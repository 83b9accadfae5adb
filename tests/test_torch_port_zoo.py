"""Port parity: ZF, UNet, ResNet (with and without its conjugate-gradient DC)
and ProximalGradient of mridc_tpu_torch against mridc_tpu's on the CPU, the
CG's normal operator (K2's ``normal_op`` Function), the zero-filled SENSE
image through ``sens_reduce``, the residual network's xavier init, the param
mappings, and the launch tables chip_smoke.py asserts for these models.

Inputs are made from a seed with numpy at 4 coils, 32x32 (a random 2D mask);
weights are drawn with numpy in the flax tree's shapes and carried into the
port through ``unet_params_from_jax`` / ``resnet_params_from_jax``. Forward
and loss: rtol 2e-3 / atol 2e-4 of the largest magnitude
(``tests/test_torch_parity.py:131``). Gradients: elementwise, at rtol 2e-3 /
atol 1e-3 of each parameter's largest magnitude, for every model: UNet's
LeakyReLU and ResNet's ReLU kinks can make a gradient move with a 1e-7
change of an activation (ROADMAP.md §1's NormUnet trap), but at these seeds
and sizes no kink flips between the two packages (the worst element reads
2% of its limit), so no per-parameter relative l2 is needed. bf16 compute:
rtol 3e-2 / atol 3e-2 of the largest magnitude and relative l2 5e-2 (the JAX
package's bf16 bound, ``tests/test_models_recon.py:238``).
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.base import ModelOutput as JOut
from mridc_tpu.ops.cplx import ccombine as jccombine
from mridc_tpu.ops.cplx import cmul as jcmul
from mridc_tpu.ops.cplx import cmul_conj as jcmul_conj
from mridc_tpu.ops.fft import fft2_rv as jfft2_rv
from mridc_tpu.ops.fft import ifft2_rv as jifft2_rv
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.models import PENDING_MODELS, available_models, build_model
from mridc_tpu_torch.models.recon import resnet as tresnet
from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import resnet_params_from_jax, unet_params_from_jax

jresnet = importlib.import_module("mridc_tpu.models.recon.resnet")

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-3, 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
BF16_RTOL, BF16_ATOL, BF16_REL_L2 = 3e-2, 3e-2, 5e-2
B, C, H, W = 2, 4, 32, 32
CONVENTIONS = {"u-backward": (False, "backward"), "c-ortho": (True, "ortho")}
MODELS = {
    "zf": {"model_name": "ZF"},
    "zf_rss": {"model_name": "ZF", "coil_combination_method": "RSS"},
    "unet": {"model_name": "UNet", "channels": 8, "pooling_layers": 2},
    "resnet_cg": {"model_name": "ResNet", "unrolled_iterations": 2, "residual_blocks": 2, "channels": 8,
                  "conjugate_gradient_dc": True, "conjugate_gradient_iterations": 4, "penalization_weight": 0.05},
    "resnet_ssdu": {"model_name": "ResNet", "unrolled_iterations": 2, "residual_blocks": 2, "channels": 8,
                    "regularization_factor": 1.0, "conjugate_gradient_dc": True, "conjugate_gradient_iterations": 4,
                    "penalization_weight": 0.0},
    "resnet": {"model_name": "ResNet", "unrolled_iterations": 2, "residual_blocks": 2, "channels": 8},
    "pg": {"model_name": "PG", "conjugate_gradient_iterations": 4, "penalization_weight": 0.05},
}
CASES = [(m, c) for m in MODELS for c in CONVENTIONS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1e-30, float(np.abs(want).max())))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _data(b=B, c=C, h=H, w=W, seed=0):
    """Unit-RSS maps, a random 2D mask (40% of k-space and the 6x6 centre),
    masked k-space, a complex target; real views."""
    rng = np.random.default_rng(seed)
    shape = (b, c, h, w)
    sens = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = (rng.random((b, 1, h, w)) < 0.4).astype(np.float32)
    mask[..., h // 2 - 3 : h // 2 + 3, w // 2 - 3 : w // 2 + 3] = 1
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64) * mask
    target = (rng.standard_normal((b, h, w)) + 1j * rng.standard_normal((b, h, w))).astype(np.complex64)
    rv = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)  # noqa: E731
    return rv(y), rv(sens), mask, rv(target)


def _cfg(model, conv, **kw):
    centered, norm = CONVENTIONS[conv]
    return {**MODELS[model], "fft_centered": centered, "fft_normalization": norm, **kw}


def _jax_params(cfg, y, sens, mask, seed=0):
    """Numpy leaves in the flax tree's shapes (``jax.eval_shape``): kernels
    normal with variance 1 / fan-in, biases small, mu as configured plus a
    small offset (so that its gradient is not held at a special point)."""
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), y, sens, mask).get("params", {})
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "mu":
            return np.full(s.shape, cfg.get("penalization_weight", 1.0) + 0.01, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _state(cfg, params):
    name = cfg["model_name"].upper()
    if name == "UNET":
        return unet_params_from_jax(params)
    if name in ("RESNET", "PG", "PROXIMALGRADIENT"):
        return resnet_params_from_jax(params)
    return {}


def _port(cfg, params):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_state(cfg, params))
    return model


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---- forward, loss and gradients against mridc_tpu ----


@pytest.mark.parametrize("model,conv", CASES)
def test_zoo_forward_matches_jax(model, conv):
    cfg = _cfg(model, conv)
    y, sens, mask, _ = _data(seed=len(model))
    params = _jax_params(cfg, y, sens, mask, seed=1)
    want = np.asarray(jax_build_model(cfg).apply({"params": params}, y, sens, mask).prediction)
    with torch.no_grad():
        got = _port(cfg, params)(*_t(y, sens, mask)).prediction
    assert got.shape == (B, H, W, 2) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("model", ["unet", "resnet_cg"])
def test_zoo_bf16_compute_matches_jax(model):
    cfg = _cfg(model, "c-ortho", compute_dtype="bfloat16")
    y, sens, mask, _ = _data(seed=5)
    params = _jax_params(cfg, y, sens, mask, seed=2)
    want = np.asarray(jax_build_model(cfg).apply({"params": params}, y, sens, mask).prediction)
    with torch.no_grad():
        got = _port(cfg, params)(*_t(y, sens, mask)).prediction.numpy()
    assert got.dtype == np.float32
    assert _rel_l2(got, want) < BF16_REL_L2
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * float(np.abs(want).max()))


def _jax_loss_and_grads(cfg, params, y, sens, mask, target, **loss_kw):
    model = jax_build_model(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(JOut(prediction=out.prediction), jnp.asarray(target), "l1", **loss_kw)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), _state(cfg, jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("model,conv", CASES)
def test_zoo_loss_and_gradients_match_jax_grad(model, conv):
    """The training loss, and every parameter's gradient against jax.grad
    (mu's included), elementwise (see the module docstring)."""
    cfg = _cfg(model, conv)
    y, sens, mask, target = _data(seed=7)
    params = _jax_params(cfg, y, sens, mask, seed=3)
    want_loss, want = _jax_loss_and_grads(cfg, params, y, sens, mask, target)
    m = _port(cfg, params)
    loss = process_reconstruction_loss(m(*_t(y, sens, mask), train=True), torch.from_numpy(target), "l1")
    if want:
        loss.backward()
    _close(float(loss.detach()), want_loss)
    got = {k: p.grad for k, p in m.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(np.abs(want[k].numpy()).max()) > 0, k
        _close(got[k], want[k].numpy(), GRAD_RTOL, GRAD_ATOL)


def test_ssdu_kspace_loss_and_mu_gradient_match_jax():
    """The SSDU configuration (mu starting at 0, centered ortho FFT, the
    k-space loss gated by a loss mask) through ResNet's CG: the loss, and
    every gradient (mu's and the convs') elementwise."""
    cfg = _cfg("resnet_ssdu", "c-ortho")
    y, sens, mask, target = _data(seed=8)
    loss_mask = (np.random.default_rng(9).random((B, H, W)) < 0.5).astype(np.float32)
    params = _jax_params(cfg, y, sens, mask, seed=4)
    kw = dict(sensitivity_maps=jnp.asarray(sens), kspace_loss=True, fft_centered=True, fft_normalization="ortho")
    want_loss, want = _jax_loss_and_grads(cfg, params, y, sens, mask, target, loss_mask=jnp.asarray(loss_mask), **kw)
    m = _port(cfg, params)
    out = m(*_t(y, sens, mask), train=True)
    loss = process_reconstruction_loss(out, torch.from_numpy(target), "l1", 1.0, torch.from_numpy(loss_mask),
                                       sensitivity_maps=torch.from_numpy(sens), kspace_loss=True, fft_centered=True,
                                       fft_normalization="ortho")
    loss.backward()
    _close(float(loss.detach()), want_loss)
    assert sorted(want) == sorted(dict(m.named_parameters()))
    for k, p in m.named_parameters():
        _close(p.grad, want[k].numpy(), GRAD_RTOL, GRAD_ATOL)


# ---- the conjugate-gradient solve and its normal operator ----


def _jax_ehe(x, sens, mask, mu, centered, norm):
    """mridc_tpu/models/recon/resnet.py:67-71's ehe, as written there."""
    m = mask[..., None]
    k = jfft2_rv(jcmul(x[:, None], sens), centered, norm, (-2, -1))
    img = jifft2_rv(k * m, centered, norm, (-2, -1))
    return jcmul_conj(img, sens).sum(axis=1) + mu * x


FFT_MODES = [(c, n) for c in (True, False) for n in ("backward", "ortho", "forward")]


@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_normal_op_and_its_backward_match_jax_vjp(centered, norm):
    """At an odd size, in every centering and normalisation: the Function's
    forward against ehe, its backward (the operator on g, and mu's real inner
    product) against jax.vjp with respect to x and mu."""
    y, sens, mask, _ = _data(h=15, w=17, seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 15, 17, 2)).astype(np.float32)
    g = rng.standard_normal((B, 15, 17, 2)).astype(np.float32)
    mu = np.array([0.3], np.float32)
    out, vjp = jax.vjp(lambda a, m_: _jax_ehe(a, jnp.asarray(sens), jnp.asarray(mask), m_, centered, norm),
                       jnp.asarray(x), jnp.asarray(mu))
    dx, dmu = vjp(jnp.asarray(g))
    tx, tmu = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(mu).requires_grad_(True)
    got = k2.normal_op(tx, torch.from_numpy(sens), torch.from_numpy(mask), tmu, centered, norm)
    got.backward(torch.from_numpy(g))
    _close(got, out)
    _close(tx.grad, dx)
    _close(tmu.grad, dmu)
    _close(k2.normal_op_plain(*_t(x, sens, mask), 0.3, centered, norm), out)


@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_normal_op_passes_gradcheck_in_float64(centered, norm):
    y, sens, mask, _ = _data(b=2, c=3, h=5, w=7, seed=13)
    sens, mask = torch.from_numpy(sens).double(), torch.from_numpy(mask).double()
    x = torch.randn(2, 5, 7, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0), requires_grad=True)
    mu = torch.tensor([0.2], dtype=torch.float64, requires_grad=True)
    fn = lambda a, m_: k2._NormalOp.apply(a, sens, mask, m_, centered, norm)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, mu))


def test_normal_op_takes_the_maps_gradient():
    """The maps' gradient against the plain backward's (``r_c conj(g) + q_c
    conj(x)``; held against jax.vjp in ``test_torch_port_sens.py``); the
    mask's still raises."""
    y, sens, mask, _ = _data(seed=14)
    ts = torch.from_numpy(sens).requires_grad_(True)
    x, m = torch.from_numpy(y[:, 0]), torch.from_numpy(mask)
    k2.normal_op(x, ts, m, 0.1).sum().backward()
    want = k2.normal_op_bwd_sens_plain(torch.ones_like(x), x, torch.from_numpy(sens), m, 0.1)[1]
    _close(ts.grad, want.numpy())
    with pytest.raises(NotImplementedError, match="mask"):
        k2.normal_op(x, torch.from_numpy(sens), m.clone().requires_grad_(True), 0.1).sum().backward()


@pytest.mark.parametrize("mu", [0.05, 0.0])
def test_cg_shares_alpha_and_beta_across_the_batch(mu):
    """The CG's dot products sum over every axis, the batch included, so the
    examples of a B=2 batch share one alpha and one beta per iteration: the
    port's solve at B=2 equals mridc_tpu's, and differs from each example
    solved alone (in both packages). mu = 0 is the SSDU start: E^H M E x =
    rhs from x = 0 with r = p = rhs."""
    y, sens, mask, _ = _data(seed=15)
    rhs = np.random.default_rng(16).standard_normal((B, H, W, 2)).astype(np.float32)
    kw = dict(iterations=4, fft_centered=True, fft_normalization="ortho")
    want = np.asarray(jresnet.conjugate_gradient(jnp.asarray(rhs), jnp.asarray(sens), jnp.asarray(mask),
                                                 jnp.float32(mu), **kw))
    got = tresnet.conjugate_gradient(*_t(rhs, sens, mask), torch.tensor([mu]), **kw)
    _close(got, want)
    alone = np.asarray(jresnet.conjugate_gradient(jnp.asarray(rhs[:1]), jnp.asarray(sens[:1]),
                                                  jnp.asarray(mask[:1]), jnp.float32(mu), **kw))
    got_alone = tresnet.conjugate_gradient(*_t(rhs[:1], sens[:1], mask[:1]), torch.tensor([mu]), **kw)
    _close(got_alone, alone)
    assert _rel_l2(want[:1], alone) > 1e-3 and _rel_l2(got[:1].numpy(), got_alone.numpy()) > 1e-3


def test_cg_scalars_are_re_im_pairs_as_in_jax():
    rng = np.random.default_rng(17)
    a, b = (rng.standard_normal((B, 5, 6, 2)).astype(np.float32) for _ in range(2))
    num, den = np.array([0.3, -1.2], np.float32), np.array([2.0, 0.5], np.float32)
    jcdot = lambda u, v: jnp.stack([(u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]).sum(),  # noqa: E731
                                    (u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]).sum()])
    _close(tresnet.cdot(*_t(a, b)), jcdot(jnp.asarray(a), jnp.asarray(b)))
    d = den[0] ** 2 + den[1] ** 2 + 1e-30
    _close(tresnet.cdiv(*_t(num, den)), [(num[0] * den[0] + num[1] * den[1]) / d,
                                        (num[1] * den[0] - num[0] * den[1]) / d])
    zero = torch.zeros(2)
    assert tresnet.cdiv(zero, zero).tolist() == [0.0, 0.0]  # the 1e-30 keeps 0/0 at 0
    s = num
    _close(tresnet.cscale(*_t(s, a)), np.stack([s[0] * a[..., 0] - s[1] * a[..., 1],
                                                s[0] * a[..., 1] + s[1] * a[..., 0]], -1))


# ---- zero-filled image, init, param mapping, registry ----


@pytest.mark.parametrize("method", ["SENSE", "RSS"])
@pytest.mark.parametrize("conv", sorted(CONVENTIONS))
def test_zero_filled_through_sens_reduce_matches_ccombine(method, conv, monkeypatch):
    """SENSE's zero-filled image is sens_reduce (K2's load and reduce on the
    card), the JAX package's ifft2_rv and ccombine; RSS stays plain."""
    centered, norm = CONVENTIONS[conv]
    y, sens, _, _ = _data(seed=18)
    want = jccombine(jifft2_rv(jnp.asarray(y), centered, norm, (-2, -1)), jnp.asarray(sens), method, 1)
    calls = []
    orig = k2.sens_reduce_plain
    monkeypatch.setattr(k2, "sens_reduce_plain", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    model = build_model({"model_name": "ZF", "coil_combination_method": method, "fft_centered": centered,
                         "fft_normalization": norm}, device="cpu")
    _close(model.zero_filled(*_t(y, sens)), want)
    assert len(calls) == (method == "SENSE")


def test_cirim_and_varnet_do_not_take_the_zero_filled_image(monkeypatch):
    """CIRIM and VarNet start from ``sense_init``, not ``zero_filled``, so
    routing ``zero_filled`` through ``sens_reduce`` leaves their results and
    launch counts as they were."""
    from mridc_tpu_torch.models.base import BaseReconModel

    def refuse(*a, **kw):
        raise AssertionError("zero_filled called")

    monkeypatch.setattr(BaseReconModel, "zero_filled", refuse)
    y, sens, mask, _ = _data(seed=22)
    for cfg in ({"model_name": "CIRIM", "num_cascades": 1, "time_steps": 2, "conv_filters": [4, 4, 2],
                 "recurrent_filters": [4, 4, 0], "dc_mode": "full"},
                {"model_name": "VN", "num_cascades": 1, "channels": 4, "pooling_layers": 2}):
        with torch.no_grad():
            assert build_model(cfg, device="cpu")(*_t(y, sens, mask)).prediction.shape == (B, H, W, 2)


def test_residual_network_init_is_flax_xavier_normal():
    """flax's xavier_normal is variance_scaling(1, fan_avg, truncated_normal):
    no entry past 2s (s = sqrt(1 / fan_avg) / 0.87962566), a std within 1% of
    sqrt(1 / fan_avg), fan_avg = (in + out) * 9 / 2; a flax draw of the same
    kernel passes the same checks, torch's untruncated xavier_normal_ fails
    the first and its unrescaled truncation the second."""
    cin, cout, k = 64, 128, 3
    std = np.sqrt(1.0 / ((cin + cout) * k * k / 2))
    s = std / tlayers.TRUNC_STD

    def passes(w):
        w = np.asarray(w, np.float64)
        return bool(np.abs(w).max() <= 2 * s * (1 + 1e-6)) and abs(w.std() / std - 1) < 0.01

    w = torch.empty(cout, cin, k, k)
    tlayers.fan_avg_truncated_normal_(w, 1.0, torch.Generator().manual_seed(0))
    assert passes(w.numpy())
    assert passes(jax.nn.initializers.xavier_normal()(jax.random.PRNGKey(0), (k, k, cin, cout)))
    assert not passes(torch.nn.init.xavier_normal_(torch.empty(cout, cin, k, k),
                                                   generator=torch.Generator().manual_seed(0)).numpy())
    unscaled = torch.nn.init.trunc_normal_(torch.empty(cout, cin, k, k), std=std, a=-2 * std, b=2 * std,
                                           generator=torch.Generator().manual_seed(0))
    assert not passes(unscaled.numpy())
    net = tresnet.ResidualNetwork(2, 64)
    net.reset_parameters(torch.Generator().manual_seed(1))
    std = np.sqrt(1.0 / (128 * 9 / 2))
    s = std / tlayers.TRUNC_STD
    assert passes(torch.cat([c.weight.flatten() for c in (*net.layers1, *net.layers2)]).detach().numpy())


@pytest.mark.parametrize("model", ["unet", "resnet_cg", "resnet", "pg"])
def test_params_from_jax_use_every_leaf(model):
    """The mappings consume every leaf of the flax tree (an extra one raises,
    a missing one raises) and give exactly the port's parameters."""
    cfg = _cfg(model, "u-backward")
    y, sens, mask, _ = _data(seed=19)
    params = jax.tree_util.tree_map(np.asarray, _jax_params(cfg, y, sens, mask))
    state = _state(cfg, params)
    assert sorted(state) == sorted(dict(build_model(cfg, device="cpu").named_parameters()))
    fn = unet_params_from_jax if model == "unet" else resnet_params_from_jax
    with pytest.raises(KeyError, match="not used"):
        fn({**params, "extra": {"kernel": np.zeros(1)}})
    first = sorted(params)[0]
    sub = dict(params[first]) if isinstance(params[first], dict) else None
    if sub is not None:
        sub.pop(sorted(sub)[-1])
        with pytest.raises(KeyError):
            fn({**params, first: sub})
    if model == "resnet":
        assert "mu" not in state and "mu" not in dict(build_model(cfg, device="cpu").named_parameters())


def test_state_dict_names_are_the_reference_ones():
    y, sens, mask, _ = _data(seed=20)
    unet = build_model(_cfg("unet", "u-backward"), device="cpu")
    assert "unet.unet.down_sample_layers.0.layers.0.weight" in unet.state_dict()
    resnet = build_model(_cfg("resnet_cg", "u-backward"), device="cpu")
    assert {"mu", "residual_network.conv1.weight", "residual_network.layers1.1.weight",
            "residual_network.layers2.1.weight", "residual_network.last_layer.weight",
            "residual_network.final_layer.weight"} <= set(resnet.state_dict())
    assert list(dict(build_model(_cfg("pg", "u-backward"), device="cpu").named_parameters())) == ["mu"]
    assert not list(build_model(_cfg("zf", "u-backward"), device="cpu").parameters())


@pytest.mark.parametrize("name", ["ZF", "UNet", "UNET", "ResNet", "RESNET", "PG", "PROXIMALGRADIENT"])
def test_zoo_builds_on_the_card_unless_told_otherwise(name, monkeypatch):
    assert name.upper() in available_models() and name.upper() not in PENDING_MODELS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model({"model_name": name})
    assert build_model({"model_name": name, "channels": 4, "residual_blocks": 1, "unrolled_iterations": 1},
                       device="cpu") is not None


def test_zoo_weights_come_from_the_generator_alone():
    for cfg in (_cfg("unet", "u-backward"), _cfg("resnet_cg", "u-backward")):
        torch.manual_seed(0)
        a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
        torch.manual_seed(1)
        b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---- chip_smoke.py's configurations and launch tables, on the CPU path ----


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", ["zf", "pg", "unet", "resnet"])
def test_chip_smoke_zoo_configs_are_the_yamls(name):
    cs = _chip_smoke()
    model = yaml.safe_load((ROOT / f"projects/reconstruction/conf/base_{name}_train.yaml").read_text())["model"]
    cfg = {**cs.ZOO_COMMON, **cs.ZOO_CFGS[name]}
    assert {k: model[k] for k in cfg} == cfg
    assert not {k for k in model if k not in cfg and not k.endswith("_ds")} - {
        "sens_chans", "sens_pools", "sens_mask_type", "complex_data", "log_images", "train_loss_fn",
        "val_loss_fn", "optim"}
    assert model["train_ds"]["batch_size"] == cs.ZOO_TRAIN_BATCH["resnet"] == 1


def test_chip_smoke_zoo_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.ZOO_PER_FORWARD and ZOO_PER_STEP (and S_PER_STEP's
    ResNet and UNet rows) derive the K2 launches of the zoo's forwards and
    training steps; the CPU path calls each Function's plain version where the
    card launches its stages, so counting the stages those calls stand for
    must give the same tables. Depth and width are cut; the tables scale with
    unrolls and CG iterations, which are kept."""
    cs = _chip_smoke()
    counts = {}

    def count(name, symbols):
        orig = getattr(k2, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(k2, name, wrapped)

    count("normal_op_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce"])
    count("sens_reduce_plain", lambda k, s, m=None, c=False, *a, fft_order=False, **kw:
          [*(["k2_load"] if (c or m is not None) and not fft_order else []), "k2_reduce"])
    y, sens, mask, target = _data(b=2, c=3, h=16, w=16, seed=21)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    cut = {"channels": 4, "residual_blocks": 1, "pooling_layers": 2}
    for name, cfg in cs.ZOO_CFGS.items():
        cfg = {**cs.ZOO_COMMON, **cfg, **{k: v for k, v in cut.items() if k in cfg}}
        model = build_model(cfg, device="cpu")
        counts.clear()
        with torch.no_grad():
            model(*_t(y, sens, mask))
        assert counts == cs.ZOO_PER_FORWARD[name], name
        trainer = Trainer(model, optim_cfg={"name": "adam", "lr": 1e-3}, device="cpu")
        counts.clear()
        trainer.training_batch(batch)
        assert counts == cs.ZOO_PER_STEP[f"train_{name}"], name
    ssdu = {**{k: v for k, v in cs.SSDU_CFG["model"].items() if not k.endswith("_ds")}, "channels": 4}
    trainer = Trainer(build_model(ssdu, device="cpu"), optim_cfg={"name": "adam", "lr": 1e-3}, device="cpu",
                      ssdu=True, kspace_reconstruction_loss=True)
    counts.clear()
    ssdu_mask = np.stack([mask, (np.random.default_rng(0).random(mask.shape) < 0.5).astype(np.float32)], 1)
    trainer.training_batch({**batch, "mask": ssdu_mask})
    assert counts == cs.S_PER_STEP["ssdu_resnet"]
    n2r = {**{k: v for k, v in cs.N2R_CFG["model"].items() if not k.endswith("_ds")}, "channels": 4,
           "pooling_layers": 2}
    trainer = Trainer(build_model(n2r, device="cpu"), optim_cfg={"name": "adam", "lr": 1e-3}, device="cpu")
    for sup, run in ((True, "n2r_unet_supervised"), (False, "n2r_unet_consistency")):
        counts.clear()
        trainer.training_batch({**batch, "n2r_masked_kspace": y * 0.5, "n2r_mask": mask,
                                "attrs": [{"n2r_supervised": sup}, {"n2r_supervised": False}]})
        assert counts == cs.S_PER_STEP[run], run
