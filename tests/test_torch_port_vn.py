"""Port parity: E2EVN/VarNet of mridc_tpu_torch against mridc_tpu's on the CPU —
InstanceNorm, the U-Net family, the VarNet forward in both dc_modes, its
training loss, gradients and Adam steps, the param mapping, the registry, the
SENSE expansion and reduction Functions' backward, and the float32
convolutions' precision rule.

Inputs are made from a seed with numpy; weights come from flax's own init and
are carried into the port through ``varnet_params_from_jax`` /
``normunet_params_from_jax``. Tolerance rtol 2e-3 / atol 2e-4 of the largest
magnitude (``tests/test_torch_parity.py:131``), unless a test says otherwise:
bf16 is held against JAX's bf16 at rtol 3e-2 / atol 3e-2 of the largest
magnitude (the bf16 cell test's limits, ``test_torch_port_cells.py``) and at
relative l2 5e-2, the JAX package's own bf16 bound
(``tests/test_models_recon.py:238``).
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.base import ModelOutput as JOut
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu.train.trainer import TrainState as JTrainState
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu.utils.torch_import import import_varnet_params
from mridc_tpu_torch import kernels
from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.models import available_models, build_model
from mridc_tpu_torch.nn import dc as tdc
from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.nn import unet as tunet
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import (hwio_to_iohw_flipped, hwio_to_oihw, normunet_params_from_jax,
                                          varnet_params_from_jax)

jdc = importlib.import_module("mridc_tpu.nn.dc")
jlayers = importlib.import_module("mridc_tpu.nn.layers")
junet = importlib.import_module("mridc_tpu.nn.unet")

RTOL, ATOL = 2e-3, 2e-4
BF16_RTOL, BF16_ATOL, BF16_REL_L2 = 3e-2, 3e-2, 5e-2
B, C = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops (gradcheck perturbs one element at a time); one
    intra-op thread keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _close_bf16(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * float(np.abs(want).max()))


def _data(h=64, w=64, seed=0):
    """tests/test_vn_psf1d.py's recipe: unit-RSS maps, a 1D column mask (every
    4th column and 16 centre ones), masked k-space, and a complex target."""
    rng = np.random.default_rng(seed)
    shape = (B, C, h, w)
    sens = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = np.zeros((B, 1, h, w), np.float32)
    mask[..., ::4] = 1
    mask[..., w // 2 - 8 : w // 2 + 8] = 1
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64) * mask
    target = (rng.standard_normal((B, h, w)) + 1j * rng.standard_normal((B, h, w))).astype(np.complex64)
    rv = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)  # noqa: E731
    return rv(y), rv(sens), mask, rv(target)


def _cfg(**kw):
    return {"model_name": "VN", "num_cascades": 2, "channels": 8, "pooling_layers": 2, "fft_centered": True,
            "fft_normalization": "ortho", **kw}


def _jax_params(cfg, y, sens, mask, seed=0):
    """Numpy leaves shaped like the flax tree (``jax.eval_shape``, so no init
    is compiled), scaled like flax's lecun-normal init: kernels normal with
    variance 1 / fan-in (kH * kW * in for both conv kinds), the final conv's
    bias small and nonzero, each cascade's dc_weight off 1."""
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), y, sens, mask)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "dc_weight":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_forward(cfg, params, y, sens, mask):
    model = jax_build_model(cfg)
    return np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a).prediction)(params, y, sens, mask))


def _port(cfg, params):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(varnet_params_from_jax(params))
    return model


def _port_forward(cfg, params, y, sens, mask):
    with torch.no_grad():
        return _port(cfg, params)(*(torch.from_numpy(a) for a in (y, sens, mask))).prediction


def _nhwc(c, seed, h=12, w=10):
    return np.random.default_rng(seed).standard_normal((B, h, w, c)).astype(np.float32)


def _to_port(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # channels_last NCHW view


def _from_port(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ---- InstanceNorm ----


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_instance_norm_matches_flax(dtype):
    x = (_nhwc(6, 1) * 3.0 + 1.5).astype(np.float32)
    jx = jnp.asarray(x) if dtype is None else jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jlayers.InstanceNorm().apply({}, jx), np.float32)
    tx = _to_port(x) if dtype is None else _to_port(x).to(torch.bfloat16)
    got = tlayers.InstanceNorm()(tx)
    assert got.dtype == tx.dtype
    if dtype is None:
        _close(_from_port(got), want, 1e-5, 1e-6)
        return
    # both take the statistics of the bf16 input in float32 and round the
    # float32 normalisation once: at most one bf16 ulp (2^-7 relative) apart
    np.testing.assert_allclose(_from_port(got), want, rtol=2**-7, atol=1e-6)


# ---- the U-Net family ----


def _convblock_state(p):
    return {"layers.0.weight": torch.from_numpy(hwio_to_oihw(p["Conv_0"]["kernel"])),
            "layers.4.weight": torch.from_numpy(hwio_to_oihw(p["Conv_1"]["kernel"]))}


def _transpose_state(p):
    return {"layers.0.weight": torch.from_numpy(hwio_to_iohw_flipped(p["ConvTranspose_0"]["kernel"]))}


def _unet_state(p):
    state = normunet_params_from_jax({"Unet_0": p})
    return {k[len("unet."):]: v for k, v in state.items()}


UNET_CASES = {
    "conv_block": (lambda dt: junet.ConvBlock(6, dtype=dt), lambda dt: tunet.ConvBlock(4, 6, dtype=dt), 4,
                   _convblock_state),
    "transpose_conv_block": (lambda dt: junet.TransposeConvBlock(5, dtype=dt),
                             lambda dt: tunet.TransposeConvBlock(8, 5, dtype=dt), 8, _transpose_state),
    "unet": (lambda dt: junet.Unet(2, chans=4, num_pool_layers=2, dtype=dt),
             lambda dt: tunet.Unet(3, 2, chans=4, num_pool_layers=2, dtype=dt), 3, _unet_state),
    "norm_unet": (lambda dt: junet.NormUnet(chans=8, num_pools=2, padding_size=11, dtype=dt),
                  lambda dt: tunet.NormUnet(chans=8, num_pools=2, padding_size=11, dtype=dt), 2,
                  normunet_params_from_jax),
    "norm_unet_unpadded": (lambda dt: junet.NormUnet(chans=4, num_pools=2, padding_size=0, dtype=dt),
                           lambda dt: tunet.NormUnet(chans=4, num_pools=2, padding_size=0, dtype=dt), 2,
                           normunet_params_from_jax),
}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("size", [(16, 20), (37, 45)])
@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet_family_matches_flax(case, size, dtype):
    """Even and odd sizes (37 x 45: the up path reflect-pads, unless the
    NormUnet's padding takes the size to a multiple of 4 first); a bf16
    compute dtype against flax's bf16."""
    jfn, tfn, cin, mapping = UNET_CASES[case]
    x = _nhwc(cin, 2, *size)
    jmod = jfn(dtype)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)), np.float32)
    tmod = tfn(dtype)
    tmod.load_state_dict(mapping(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)) if case.startswith("norm_unet") else tmod(_to_port(x))
    # the Unet casts back to float32 at its exit; the blocks stay in their dtype
    assert out.dtype == (torch.float32 if dtype is None or "unet" in case else torch.bfloat16)
    got = out if case.startswith("norm_unet") else _from_port(out)
    (_close if dtype is None else _close_bf16)(got, want)


def test_transpose_conv_kernel_is_flipped():
    """flax applies a ConvTranspose kernel unflipped, torch flips its weight:
    with a kernel that no flip leaves alone (every tap distinct), the flipped
    mapping matches flax and the plain transpose does not."""
    x = _nhwc(3, 4, 5, 7)
    jmod = junet.TransposeConvBlock(2)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    kernel = (np.arange(2 * 2 * 3 * 2, dtype=np.float32).reshape(2, 2, 3, 2) - 11.5) / 7.0
    params["ConvTranspose_0"]["kernel"] = kernel
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tunet.TransposeConvBlock(3, 2)
    tmod.load_state_dict(_transpose_state(params))
    with torch.no_grad():
        _close(_from_port(tmod(_to_port(x))), want, 1e-5, 1e-6)
        tmod.layers[0].weight.copy_(torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (2, 3, 0, 1)))))
        unflipped = _from_port(tmod(_to_port(x)))
    assert np.abs(unflipped - want).max() > 0.1


@pytest.mark.parametrize("layer", ["Conv", "ConvTranspose"])
def test_unet_init_is_flax_truncated_normal(layer):
    """The U-Net's convs draw flax's lecun_normal (fan-in truncated normal):
    no entry past 2s (s = sqrt(1 / fan_in) / 0.87962566), a std within 1% of
    sqrt(1 / fan_in); a flax draw of the same kernel passes the same checks.
    The transpose conv's fan-in is kH * kW * in (flax's kernel is
    (kH, kW, in, out)), not torch's out * kH * kW."""
    cin, cout = 64, 128
    block = tunet.ConvBlock(cin, cout) if layer == "Conv" else tunet.TransposeConvBlock(cin, cout)
    k = 3 if layer == "Conv" else 2
    fan_in = cin * k * k
    std = np.sqrt(1.0 / fan_in)
    s = std / tlayers.TRUNC_STD

    def passes(w):
        w = np.asarray(w, np.float64)
        return bool(np.abs(w).max() <= 2 * s * (1 + 1e-6)) and abs(w.std() / std - 1) < 0.01

    block.reset_parameters(torch.Generator().manual_seed(0))
    assert passes(block.layers[0].weight.detach().numpy())
    assert passes(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (k, k, cin, cout)))
    if layer == "ConvTranspose":
        wrong = torch.empty(cin, cout, k, k)
        tlayers.fan_in_truncated_normal_(wrong, 1.0, torch.Generator().manual_seed(0))  # torch's fan-in
        assert not passes(wrong.numpy())


# ---- VarNet forward ----

FORWARD_CASES = {
    "full_c_ortho": dict(cfg={"dc_mode": "full"}, size=(64, 64)),
    "full_u_backward_odd": dict(cfg={"dc_mode": "full", "fft_centered": False, "fft_normalization": "backward"},
                                size=(37, 45)),
    "full_c_forward_odd": dict(cfg={"dc_mode": "full", "fft_normalization": "forward"}, size=(37, 45)),
    "full_rss_odd": dict(cfg={"dc_mode": "full", "coil_combination_method": "RSS"}, size=(37, 45)),
    "full_no_dc": dict(cfg={"dc_mode": "full", "no_dc": True, "fft_centered": False}, size=(64, 64)),
    "full_bf16_compute": dict(cfg={"dc_mode": "full", "compute_dtype": "bfloat16"}, size=(64, 64), bf16=True),
    "psf1d_c_ortho": dict(cfg={"dc_mode": "psf1d"}, size=(64, 64)),
    "psf1d_u_backward_odd": dict(cfg={"dc_mode": "psf1d", "fft_centered": False, "fft_normalization": "backward"},
                                 size=(37, 45)),
    "psf1d_c_forward": dict(cfg={"dc_mode": "psf1d", "fft_normalization": "forward"}, size=(64, 64)),
    "psf1d_bf16_dc": dict(cfg={"dc_mode": "psf1d", "dc_dtype": "bfloat16"}, size=(64, 64), bf16=True),
    "psf1d_bench_cfg_odd": dict(cfg={"dc_mode": "psf1d", "dc_dtype": "bfloat16", "compute_dtype": "bfloat16"},
                                size=(37, 45), bf16=True),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_varnet_forward_matches_jax(case):
    spec = FORWARD_CASES[case]
    cfg = _cfg(**spec["cfg"])
    y, sens, mask, _ = _data(*spec["size"], seed=len(case))
    params = _jax_params(cfg, y, sens, mask, seed=1)
    want = _jax_forward(cfg, params, y, sens, mask)
    got = _port_forward(cfg, params, y, sens, mask)
    assert got.shape == (B, *spec["size"], 2) and got.dtype == torch.float32
    (_close_bf16 if spec.get("bf16") else _close)(got, want)


def test_full_and_psf1d_agree_at_the_same_weights():
    """The port's two dc_modes compute one function on a 1D mask: the JAX
    package's own bound at 2 cascades of untrained NormUnets (2e-2,
    tests/test_vn_psf1d.py:58), which amplify reassociation noise."""
    y, sens, mask, _ = _data(seed=5)
    params = _jax_params(_cfg(), y, sens, mask, seed=2)
    full = _port_forward(_cfg(dc_mode="full"), params, y, sens, mask)
    fast = _port_forward(_cfg(dc_mode="psf1d"), params, y, sens, mask)
    assert float((fast - full).norm() / full.norm()) < 2e-2


# ---- the param mapping ----


def test_varnet_params_from_jax_reads_both_dc_modes_and_every_leaf():
    y, sens, mask, _ = _data(16, 16)
    trees = {mode: _jax_params(_cfg(dc_mode=mode), y, sens, mask, seed=4) for mode in ("full", "psf1d")}
    assert jax.tree_util.tree_structure(trees["full"]) == jax.tree_util.tree_structure(trees["psf1d"])
    port = build_model(_cfg(), device="cpu")
    state = varnet_params_from_jax({"params": trees["psf1d"]})
    assert sorted(state) == sorted(port.state_dict())
    assert sum(v.numel() for v in state.values()) == sum(a.size for a in jax.tree_util.tree_leaves(trees["psf1d"]))
    np.testing.assert_array_equal(
        state["cascades.1.model.unet.up_transpose_conv.0.layers.0.weight"].numpy(),
        np.transpose(trees["psf1d"]["_VarNetBlock_1"]["NormUnet_0"]["Unet_0"]["TransposeConvBlock_0"]
                     ["ConvTranspose_0"]["kernel"], (2, 3, 0, 1))[..., ::-1, ::-1])
    extra = jax.tree_util.tree_map(lambda a: a, trees["full"])
    extra["_VarNetBlock_0"]["NormUnet_0"]["Unet_0"]["Conv_0"]["scale"] = np.ones(2, np.float32)
    with pytest.raises(KeyError, match="not used"):
        varnet_params_from_jax(extra)
    missing = jax.tree_util.tree_map(lambda a: a, trees["full"])
    del missing["_VarNetBlock_1"]["NormUnet_0"]["Unet_0"]["ConvBlock_2"]["Conv_1"]
    with pytest.raises(KeyError, match="missing"):
        varnet_params_from_jax(missing)


def test_state_dict_round_trips_through_the_jax_importer():
    """The port's state-dict keys are the reference torch names that
    mridc_tpu's import_varnet_params reads: a port state imported into the JAX
    package gives the same forward, and maps back unchanged."""
    cfg = _cfg(dc_mode="psf1d")
    y, sens, mask, _ = _data(24, 24, seed=6)
    port = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    state = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    params = import_varnet_params(state, num_cascades=2, chans=8, num_pools=2)
    _close(_port_forward(cfg, params, y, sens, mask), _jax_forward(cfg, params, y, sens, mask))
    again = varnet_params_from_jax(params)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy())


# ---- the registry ----


def test_varnet_names_build_and_its_guards_raise(monkeypatch):
    assert {"VN", "VARNET", "E2EVN"} <= set(available_models())
    for name in ("VN", "VARNET", "E2EVN"):
        model = build_model({**_cfg(), "model_name": name}, device="cpu")
        assert type(model).__name__ == "VarNet" and len(model.cascades) == 2
        assert all(float(b.dc_weight.detach()) == 1.0 for b in model.cascades)
    wrapped = build_model(_cfg(use_sens_net=True), device="cpu")
    assert type(wrapped).__name__ == "VarNetWithSensNet" and len(wrapped.cascades) == 2
    for bad in ({"no_dc": True}, {"coil_combination_method": "RSS"}):
        with pytest.raises(ValueError, match="VarNet dc_mode=psf1d requires no_dc=false"):
            build_model(_cfg(dc_mode="psf1d", **bad), device="cpu")
    with pytest.raises(ValueError, match="dc_mode"):
        build_model(_cfg(dc_mode="fast"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_cfg())


def test_varnet_weights_come_from_the_generator_alone():
    state = torch.random.get_rng_state()
    a = build_model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert torch.equal(state, torch.random.get_rng_state())
    b = build_model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(p.is_contiguous(memory_format=torch.channels_last) for p in a.values() if p.ndim == 4)


# ---- training ----


def _jax_loss_and_grads(cfg, params, y, sens, mask, target):
    model = jax_build_model(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(JOut(prediction=out.prediction), jnp.asarray(target), "l1")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), varnet_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("dc_mode,size", [("full", (32, 32)), ("psf1d", (32, 32)), ("full", (21, 27))])
def test_varnet_train_loss_and_gradients_match_jax_grad(dc_mode, size):
    cfg = _cfg(dc_mode=dc_mode, fft_centered=size[0] % 2 == 0)
    y, sens, mask, target = _data(*size, seed=7)
    params = _jax_params(cfg, y, sens, mask, seed=3)
    want_loss, want = _jax_loss_and_grads(cfg, params, y, sens, mask, target)
    model = _port(cfg, params)
    out = model(*(torch.from_numpy(a) for a in (y, sens, mask)), train=True)
    loss = process_reconstruction_loss(out, torch.from_numpy(target), "l1")
    loss.backward()
    _close(float(loss), want_loss)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        # cascade 0's soft DC sees pred = y, so its weight's gradient is 0
        assert (float(want[k].abs().max()) > 0) == (k != "cascades.0.dc_weight"), k
        _close(got[k], want[k].numpy())


OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
         "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}


def test_three_trainer_steps_give_optax_parameters():
    """Trainer (Adam under InverseSquareRootAnnealing) on the full route, whose
    gradients run through the SENSE Functions' backward."""
    cfg = _cfg(dc_mode="full")
    y, sens, mask, target = _data(16, 16, seed=8)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    params = _jax_params(cfg, y, sens, mask, seed=5)
    trainer_cfg = {"max_steps": 30}

    jt = JTrainer(jax_build_model(cfg), optim_cfg=OPTIM, trainer_cfg=trainer_cfg, loss_type="l1", mesh=make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    jt.state = JTrainState.create(params, jt._tx)
    want_losses = [float(jt.training_batch(batch)["loss"]) for _ in range(3)]

    model = _port(cfg, params)
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg=trainer_cfg, loss_type="l1", device="cpu")
    tt.setup_optimization()
    tt.init_state(batch)
    _close([float(tt.training_batch(batch)["loss"]) for _ in range(3)], want_losses)
    want_params = varnet_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for k, p in model.named_parameters():
        _close(p, want_params[k].numpy())
    _close(tt.predict_batch(batch), np.asarray(jt.predict_batch(batch)))


# ---- the SENSE expansion and reduction Functions ----

FFT_MODES = [(c, n) for c in (True, False) for n in ("backward", "ortho", "forward")]


def _sense_operands(h, w, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    sens = rng.standard_normal((B, 3, h, w, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    image = rng.standard_normal((B, h, w, 2)).astype(np.float32)
    kspace = rng.standard_normal((B, 3, h, w, 2)).astype(np.float32)
    mask = (rng.random((B, 1, h, w)) < 0.5).astype(np.float32)
    return sens, image, kspace, mask


def _jax_reorder(k, centered, fft_order, back=False):
    if not (centered and fft_order):
        return k
    return (jnp.fft.fftshift if back else jnp.fft.ifftshift)(k, axes=(-3, -2))


@pytest.mark.parametrize("fft_order", [False, True])
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_sens_expand_and_reduce_backward_match_jax_vjp(centered, norm, fft_order):
    """At an odd size, in every centering and normalisation, with k-space in
    centered or FFT order: the Functions' forward and their hand-written
    backward (the adjoint, with the swapped normalisation) against jax.vjp of
    nn/dc.py's sens_expand and sens_reduce; sens_reduce also with a mask."""
    sens, image, kspace, mask = _sense_operands(15, 17, seed=1)
    js = jnp.asarray(sens)
    rng = np.random.default_rng(2)
    g_k = rng.standard_normal(kspace.shape).astype(np.float32)
    g_x = rng.standard_normal(image.shape).astype(np.float32)

    out, vjp = jax.vjp(lambda x: _jax_reorder(jdc.sens_expand(x, js, centered, norm), centered, fft_order),
                       jnp.asarray(image))
    tx = torch.from_numpy(image).requires_grad_(True)
    got = kernels.sens_expand(tx, torch.from_numpy(sens), centered, norm, fft_order)
    got.backward(torch.from_numpy(g_k))
    _close(got, out)
    _close(tx.grad, vjp(jnp.asarray(g_k))[0])

    masks = (None,) if fft_order else (None, mask)
    for m in masks:
        def jfn(k):
            k = _jax_reorder(k, centered, fft_order, back=True)
            return jdc.sens_reduce(k if m is None else k * jnp.asarray(m)[..., None], js, centered, norm)

        out, vjp = jax.vjp(jfn, jnp.asarray(kspace))
        tk = torch.from_numpy(kspace).requires_grad_(True)
        got = kernels.sens_reduce(tk, torch.from_numpy(sens), None if m is None else torch.from_numpy(m), centered,
                                  norm, fft_order=fft_order)
        got.backward(torch.from_numpy(g_x))
        _close(got, out)
        _close(tk.grad, vjp(jnp.asarray(g_x))[0])


@pytest.mark.parametrize("fft_order", [False, True])
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_sens_expand_and_reduce_pass_gradcheck_in_float64(centered, norm, fft_order):
    sens, image, kspace, mask = (torch.from_numpy(a).double() for a in _sense_operands(5, 7, seed=3))
    assert torch.autograd.gradcheck(lambda x: kernels.sens_expand(x, sens, centered, norm, fft_order),
                                    (image.requires_grad_(True),))
    m = None if fft_order else mask
    assert torch.autograd.gradcheck(lambda k: kernels.sens_reduce(k, sens, m, centered, norm, fft_order=fft_order),
                                    (kspace.requires_grad_(True),))


def test_fft_order_round_trips_and_refuses_a_mask():
    sens, _, kspace, mask = (torch.from_numpy(a) for a in _sense_operands(5, 7, seed=4))
    kf = k2.to_fft_order(kspace, True)
    assert torch.equal(kf, torch.fft.ifftshift(kspace, dim=(-3, -2)))
    assert torch.equal(k2.from_fft_order(kf, True), kspace) and k2.to_fft_order(kspace, False) is kspace
    with pytest.raises(ValueError, match="fft_order takes no mask"):
        kernels.sens_reduce(kf, sens, mask, True, "ortho", fft_order=True)
    # the maps' gradient (zero at a zero image)
    s = sens.clone().requires_grad_(True)
    kernels.sens_expand(torch.zeros(B, 5, 7, 2, requires_grad=True), s, True).sum().backward()
    assert s.grad is not None and torch.equal(s.grad, torch.zeros_like(sens))


def test_psf1d_normal_is_k1_without_its_data_term():
    y, sens, mask, _ = _data(16, 16, seed=9)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 16, 16, 2)).astype(np.float32))
    ts = torch.from_numpy(sens)
    mats = tdc.psf1d_gauss_mats(torch.from_numpy(mask)[:, 0, 0, :], True, "ortho")
    want = jdc.log_likelihood_gradient_psf1d(jnp.asarray(u.numpy()), jnp.asarray(sens), jnp.asarray(mats.numpy()),
                                             jnp.zeros((B, 16, 16, 2)))[..., 2:]
    _close(k1.psf1d_normal(u, ts, mats, torch.zeros(B, 16, 16, 2)), want)


# ---- float32 convolutions run without TF32 whatever the global flag says ----


class _RecordFlag(TorchDispatchMode):
    """Records cuDNN's TF32 flag at each convolution and its backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default, torch.ops.aten.convolution_backward.default):
            self.seen.append((func.__name__, args[0].dtype, torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model_cfg", [
    _cfg(dc_mode="full"),
    {"model_name": "CIRIM", "num_cascades": 1, "time_steps": 2, "conv_filters": [8, 8, 2],
     "recurrent_filters": [8, 8, 0], "fft_centered": True, "fft_normalization": "ortho"},
], ids=["varnet", "cirim"])
def test_float32_convolutions_run_without_tf32(model_cfg):
    """With the global flag on (PyTorch's default), every float32 convolution
    of a forward and of its backward (which reads the flag when it runs: the
    autograd node does not record it) runs with TF32 off, and the flag is
    restored after; bf16 convolutions are left as PyTorch runs them."""
    y, sens, mask, target = _data(16, 16, seed=10)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dtype in (None, "bfloat16"):
            model = build_model({**model_cfg, "compute_dtype": dtype}, device="cpu")
            with _RecordFlag() as rec:
                out = model(*(torch.from_numpy(a) for a in (y, sens, mask)), train=True)
                process_reconstruction_loss(out, torch.from_numpy(target), "l1").backward()
            f32 = [r for r in rec.seen if r[1] == torch.float32]
            names = {r[0] for r in f32}
            if dtype is None:
                assert names == {"convolution.default", "convolution_backward.default"}, names
                assert not any(r[2] for r in f32)
            else:
                assert any(r[1] == torch.bfloat16 for r in rec.seen)
            assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---- the launch counts chip_smoke.py asserts, on the CPU path ----


def test_chip_smoke_varnet_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.VN_PER_FORWARD and VN_PER_STEP derive the kernel launches of
    a VarNet forward and training step (8 cascades, centered FFT); the CPU
    path calls each Function's plain version where the card launches its
    stages, so counting the stages those calls stand for must give the same
    tables."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    counts = {}

    def count(mod, name, symbols):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    def load(c, fft_order, needed=True):
        return ["k2_load"] if needed and c and not fft_order else []

    count(k1, "psf1d_dc_plain", lambda e, s, *a: [k1.SYMBOLS[s.dtype]])
    count(k1, "psf1d_dc_bwd_plain", lambda g, s, *a: [k1.BWD_SYMBOLS[s.dtype]])
    count(k2, "sens_expand_plain", lambda x, s, c=False, n="backward", fft_order=False, mask=None:
          ["k2_expand", *load(c, fft_order)])
    count(k2, "sens_expand_bwd_plain", lambda g, s, c=False, n="backward", fft_order=False, mask=None:
          [*load(c, fft_order), "k2_reduce"])
    count(k2, "sens_reduce_plain", lambda k, s, m=None, c=False, n="backward", sd=None, cd=1, fft_order=False:
          [*load(c or m is not None, fft_order), "k2_reduce"])
    count(k2, "sens_reduce_bwd_plain", lambda g, s, m=None, c=False, n="backward", fft_order=False:
          ["k2_expand", *(["k2_mask"] if m is not None else []), *load(c, fft_order)])
    count(k2, "_reorder", lambda *a: ["k2_load"])

    y, sens, mask, target = _data(16, 16, seed=11)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    small = dict(channels=4, pooling_layers=2)
    forward = {"vn_bf16_psf1d": chip_smoke.vn_cfg(**small),
               "vn_f32_psf1d": chip_smoke.vn_cfg(compute_dtype=None, dc_dtype=None, **small),
               "vn_f32_full": chip_smoke.vn_cfg(compute_dtype=None, dc_dtype=None, dc_mode="full", **small)}
    for name, cfg in forward.items():
        assert cfg["num_cascades"] == 8 and cfg["fft_centered"]
        model = build_model(cfg, device="cpu")
        counts.clear()
        with torch.no_grad():
            model(*(torch.from_numpy(a) for a in (y, sens, mask)))
        assert counts == chip_smoke.VN_PER_FORWARD[name], name
    for name, run in (("train_vn_bf16_psf1d", "vn_bf16_psf1d"), ("train_vn_f32_full", "vn_f32_full")):
        trainer = Trainer(build_model(forward[run], device="cpu"), optim_cfg=chip_smoke.TRAIN_OPTIM,
                          trainer_cfg=chip_smoke.TRAIN_CFG, device="cpu")
        counts.clear()
        trainer.training_batch(batch)
        assert counts == chip_smoke.VN_PER_STEP[name], name


def test_chip_smoke_varnet_weights_have_the_flax_layout():
    """chip_smoke.py draws VarNet weights without JAX, in the flax tree layout;
    that layout must be the one mridc_tpu's VarNet really has."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    cfg = chip_smoke.vn_cfg(num_cascades=2, channels=6, pooling_layers=3)
    y, sens, mask, _ = _data(16, 16)
    want = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), y, sens, mask)
    got = chip_smoke.vn_layout_tree(cfg, seed=0, gain=chip_smoke.VN_GAIN)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a, b: a.shape == b.shape, got, want)))
