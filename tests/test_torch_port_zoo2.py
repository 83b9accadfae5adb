"""Port parity: CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet and DUNet of
mridc_tpu_torch against mridc_tpu's on the CPU, with their regularisers
(Conv2dCascade, MWCNN with its DWT/IWT, DIDN with its Subpixel), K2's masked
SENSE expansion, the weight carry both ways, the YAML model blocks, and the
launch tables chip_smoke.py asserts for these models.

Inputs are made from a seed with numpy at 4 coils, 32x32 (a random 2D mask),
and at 33x37 where an odd size takes the reflect pads of DIDN and MWCNN;
weights are drawn with numpy in the flax tree's shapes and carried into the
port through ``zoo2_params_from_jax``. Forward and loss: rtol 2e-3 / atol
2e-4 of the largest magnitude (``tests/test_torch_parity.py:131``).
Gradients: elementwise at rtol 2e-3 / atol 1e-3 of each parameter's largest
magnitude (the rule of ``test_torch_port_zoo.py``) where no ReLU or PReLU kink
flips between the packages at these seeds and sizes; LPDNet's NormUnets flip
one, and it is held per parameter at relative l2 1e-2. bf16 compute: rtol
3e-2 / atol 3e-2 of the largest magnitude and relative l2 5e-2 (LPDNet: see
its test).
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.base import ModelOutput as JOut
from mridc_tpu.nn import conv2d as jconv2d
from mridc_tpu.nn import didn as jdidn
from mridc_tpu.nn import mwcnn as jmwcnn
from mridc_tpu.nn.dc import sens_expand as jsens_expand
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu_torch import cli
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.models import PENDING_MODELS, available_models, build_model
from mridc_tpu_torch.nn import conv2d as tconv2d
from mridc_tpu_torch.nn import didn as tdidn
from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.nn import mwcnn as tmwcnn
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import zoo2_params_from_jax, zoo2_params_to_jax

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-3, 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
GRAD_REL_L2 = 1e-2
BF16_RTOL, BF16_ATOL, BF16_REL_L2 = 3e-2, 3e-2, 5e-2
B, C, H, W = 2, 4, 32, 32
CONVENTIONS = {"u-backward": (False, "backward"), "c-ortho": (True, "ortho")}
MODELS = {
    "ccnn": {"model_name": "CascadeNet", "num_cascades": 2, "hidden_channels": 8, "n_convs": 3},
    "crnn": {"model_name": "CRNNet", "num_iterations": 3, "hidden_channels": 8, "n_convs": 3},
    "xpdnet": {"model_name": "XPDNet", "num_iter": 2, "num_primal": 3, "use_primal_only": True,
               "image_model_architecture": "MWCNN", "mwcnn_hidden_channels": 4, "mwcnn_num_scales": 2},
    "kikinet": {"model_name": "KIKINet", "num_iter": 2, "kspace_model_architecture": "DIDN",
                "kspace_didn_hidden_channels": 4, "kspace_didn_num_dubs": 1, "kspace_didn_num_convs_recon": 2,
                "imspace_model_architecture": "MWCNN", "image_mwcnn_hidden_channels": 4,
                "image_mwcnn_num_scales": 2},
    "lpdnet": {"model_name": "LPDNet", "num_iter": 2, "num_primal": 3, "num_dual": 2, "primal_unet_num_filters": 4,
               "primal_unet_num_pool_layers": 2, "dual_unet_num_filters": 4, "dual_unet_num_pool_layers": 2},
    "vsnet": {"model_name": "VSNet", "num_cascades": 2, "imspace_model_architecture": "CONV",
              "imspace_conv_hidden_channels": 8, "imspace_conv_n_convs": 3},
    "dunet": {"model_name": "DUNet", "num_iter": 2, "reg_model_architecture": "DIDN", "didn_hidden_channels": 4,
              "didn_num_dubs": 1, "didn_num_convs_recon": 2, "data_consistency_term": "GD"},
}
YAMLS = {"ccnn": "ccnn", "crnn": "crnn", "xpdnet": "xpdnet", "kikinet": "kikinet", "lpdnet": "lpdnet",
         "vsnet": "vsnet", "dunet": "dunet"}


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


def _cfg(model, conv="u-backward", **kw):
    centered, norm = CONVENTIONS[conv]
    return {**MODELS[model], "fft_centered": centered, "fft_normalization": norm, **kw}


def _leaf(rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (1 + 0.1 * np.abs(rng.standard_normal(s.shape))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return leaf


@functools.lru_cache(maxsize=None)
def _shapes(key):
    cfg, shape = json.loads(key[0]), key[1]
    y, sens, mask = (np.zeros(s, np.float32) for s in ((*shape, 2), (*shape, 2), (shape[0], 1, *shape[2:])))
    return dict(jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), y, sens, mask))


def _jax_vars(cfg, y, sens, mask, seed=0):
    """Numpy leaves in the flax variables' shapes: kernels normal with
    variance 1 / fan-in, BatchNorm variances above 1 and scales near 1, every
    other leaf small."""
    shapes = _shapes((json.dumps(cfg, sort_keys=True), y.shape[:4]))
    return jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(seed)), shapes)


def _jax_predict(cfg, v, *inputs):
    return np.asarray(jax.jit(jax_build_model(cfg).apply)(v, *inputs).prediction)


def _port(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(variables, cfg))
    return model


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---- the regularisers against mridc_tpu ----


def _nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bn", ["none", "frozen", "live"])
def test_conv2d_cascade_matches_jax(bn):
    x = _nhwc((2, 12, 10, 3), 1)
    kw = dict(batchnorm=bn != "none", live_bn=bn == "live")
    jmod = jconv2d.Conv2dCascade(out_channels=2, hidden_channels=6, n_convs=3, lane_fold="never", **kw)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(2)), dict(shapes))
    mod = tconv2d.Conv2dCascade(3, 2, 6, 3, **kw)
    from mridc_tpu_torch.utils.params import _FROM, _cascade_pairs

    leaves = {c: {"/".join(p.key for p in path): np.asarray(a) for path, a in
                  jax.tree_util.tree_flatten_with_path(v.get(c, {}))[0]} for c in ("params", "batch_stats")}
    mod.load_state_dict({pk: torch.from_numpy(np.ascontiguousarray(_FROM[kind](leaves[c][f])))
                         for c, f, pk, kind in _cascade_pairs(mod, "", "")})
    for train in (False, True):
        want = np.asarray(jmod.apply(v, x, train, mutable=["batch_stats"] if bn == "live" and train else False)[0]
                          if bn == "live" and train else jmod.apply(v, x, train))
        with torch.no_grad():
            got = mod(torch.from_numpy(x), train)
        _close(got, want)


def test_dwt2_and_iwt2_are_bit_identical():
    x = _nhwc((2, 8, 12, 3), 3)
    got = tmwcnn.dwt2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jmwcnn.dwt2(jnp.asarray(x)))
    assert got.shape == want.shape and np.array_equal(got, want)
    z = _nhwc((2, 4, 6, 8), 4)
    got = tmwcnn.iwt2(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jmwcnn.iwt2(jnp.asarray(z)))
    assert got.shape == want.shape and np.array_equal(got, want)
    # the channel order: LL is the 2x2 mean times 2
    np.testing.assert_allclose(tmwcnn.dwt2(torch.ones(1, 1, 2, 2)).flatten().numpy(), [2, 0, 0, 0])


def _block_state(mod, pairs_fn, v):
    from mridc_tpu_torch.utils.params import _FROM

    leaves = {c: {"/".join(p.key for p in path): np.asarray(a) for path, a in
                  jax.tree_util.tree_flatten_with_path(v.get(c, {}))[0]} for c in ("params", "batch_stats")}
    return {pk: torch.from_numpy(np.ascontiguousarray(_FROM[kind](leaves[c].pop(f))))
            for c, f, pk, kind in pairs_fn(mod, "", "")}, leaves


@pytest.mark.parametrize("hw,res", [((16, 12), False), ((17, 13), True)])
def test_mwcnn_matches_jax(hw, res):
    from mridc_tpu_torch.utils.params import _mwcnn_pairs

    x = _nhwc((2, *hw, 4), 5)
    jmod = jmwcnn.MWCNN(input_channels=4, first_conv_hidden_channels=4, num_scales=3)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(6)),
                                         dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)))
    mod = tmwcnn.MWCNN(4, 4, 3)
    state, left = _block_state(mod, _mwcnn_pairs, v)
    assert not left["params"]
    mod.load_state_dict(state)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), res)
    _close(got, np.asarray(jax.jit(jmod.apply, static_argnums=2)(v, x, res)))


@pytest.mark.parametrize("hw,skip", [((16, 20), False), ((33, 37), True)])
def test_didn_matches_jax(hw, skip):
    from mridc_tpu_torch.utils.params import _didn_pairs

    x = _nhwc((2, *hw, 3), 7)
    jmod = jdidn.DIDN(out_channels=2, hidden_channels=4, num_dubs=2, num_convs_recon=3, skip_connection=skip)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(8)),
                                         dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)))
    mod = tdidn.DIDN(3, 2, 4, 2, 3, skip)
    state, left = _block_state(mod, _didn_pairs, v)
    assert not left["params"]
    mod.load_state_dict(state)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    _close(got, np.asarray(jax.jit(jmod.apply)(v, x)))


def test_subpixel_is_pixel_shuffle_in_jax_channel_order():
    """The JAX package's NHWC depth-to-space sends channel c r^2 + i r + j to
    pixel (i, j) of channel c, which is F.pixel_shuffle's order: shown on
    inputs whose values name their channel, then through the conv."""
    r, cout, h, w = 2, 3, 4, 5
    x = np.broadcast_to(np.arange(cout * r * r, dtype=np.float32), (1, h, w, cout * r * r)).copy()
    b, hh, ww, c = x.shape
    want = x.reshape(b, hh, ww, c // (r * r), r, r).transpose(0, 1, 4, 2, 5, 3).reshape(b, hh * r, ww * r, c // 4)
    got = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, want) and got[0, 1, 0, 2] == 2 * 4 + 1 * 2 + 0
    xin = _nhwc((2, h, w, 6), 9)
    jmod = jdidn.Subpixel(features=cout, upscale=r, kernel=1)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(10)),
                                         dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xin)))
    mod = tdidn.Subpixel(6, cout, r, 1)
    p = v["params"]["Conv_0"]
    mod.conv.load_state_dict({"weight": torch.from_numpy(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)).copy()),
                              "bias": torch.from_numpy(np.asarray(p["bias"]))})
    with torch.no_grad():
        got = mod(torch.from_numpy(xin).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, np.asarray(jmod.apply(v, xin)))


def test_regulariser_init_is_flax_lecun_normal():
    """flax's plain nn.Conv (MWCNN, DIDN, the conv cascade): a normal with
    variance 1 / fan-in cut at two of its std, zero biases; PReLU alphas and
    BatchNorm entries at flax's constants."""
    torch.manual_seed(0)
    mw = tmwcnn.MWCNN(2, 16, 2)
    mw.reset_parameters(torch.Generator().manual_seed(1))
    w = mw.up_dil[0].convs[0].weight.detach().numpy()  # 32 -> 32, 3x3
    s = np.sqrt(1.0 / (32 * 9)) / tlayers.TRUNC_STD
    assert abs(w.std() / np.sqrt(1.0 / (32 * 9)) - 1) < 0.05 and np.abs(w).max() <= 2 * s + 1e-6
    assert not mw.up_dil[0].convs[0].bias.detach().any()
    didn = tdidn.DIDN(2, 2, 16, 1, 2)
    didn.reset_parameters(torch.Generator().manual_seed(2))
    assert float(didn.conv_in.prelu.detach()) == 0.25 and didn.recon_block.convs[-1].prelu is None
    casc = tconv2d.Conv2dCascade(2, 2, 8, 3, batchnorm=True)
    assert [float(a.detach()) for a in casc.prelus] == [0.25, 0.25]
    assert float(casc.bns[0].var.detach().sum()) == 8 and not casc.bns[0].mean.detach().any()


# ---- K2's masked expansion ----


@pytest.mark.parametrize("conv", list(CONVENTIONS))
def test_masked_sens_expand_matches_jax_fwd_and_vjp(conv):
    """sens_expand(mask=) and its plain twin against the JAX package's masked
    forward operator (``xpdnet.py``'s ``fwd``), and the backward against
    ``jax.vjp``: the masked reduction with the adjoint's normalisation."""
    centered, norm = CONVENTIONS[conv]
    y, sens, mask, _ = _data(seed=30)
    x = np.random.default_rng(31).standard_normal((B, H, W, 2)).astype(np.float32)
    g = np.random.default_rng(32).standard_normal((B, C, H, W, 2)).astype(np.float32)
    m = jnp.asarray(mask)[..., None]

    def jfwd(img):
        k = jsens_expand(img, jnp.asarray(sens), centered, norm)
        return jnp.where(m == 0, jnp.zeros((), k.dtype), k)

    want, want_g = jax.jit(lambda a, b: (lambda o: (o[0], o[1](b)[0]))(jax.vjp(jfwd, a)))(jnp.asarray(x), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = k2.sens_expand(tx, torch.from_numpy(sens), centered, norm, mask=torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    _close(got, np.asarray(want))
    _close(tx.grad, np.asarray(want_g))
    _close(k2.sens_expand_plain(torch.from_numpy(x), torch.from_numpy(sens), centered, norm,
                                mask=torch.from_numpy(mask)), np.asarray(want))
    _close(k2.sens_expand_bwd_plain(torch.from_numpy(g), torch.from_numpy(sens), centered, norm,
                                    mask=torch.from_numpy(mask)), np.asarray(want_g))
    with pytest.raises(ValueError, match="fft_order takes no mask"):
        k2.sens_expand(tx, torch.from_numpy(sens), centered, norm, True, mask=torch.from_numpy(mask))


def test_masked_sens_expand_passes_gradcheck_and_refuses_mask_grads():
    y, sens, mask, _ = _data(b=1, c=2, h=6, w=5, seed=33)
    s64 = torch.from_numpy(sens).double()
    m64 = torch.from_numpy(mask).double()
    x = torch.randn(1, 6, 5, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0), requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: k2.sens_expand(v, s64, True, "ortho", mask=m64), (x,))
    with pytest.raises(NotImplementedError):
        k2.sens_expand(x, s64, False, "backward", mask=m64.clone().requires_grad_(True)).sum().backward()


# ---- the seven models against mridc_tpu ----


FORWARD_CASES = [(m, "u-backward") for m in MODELS] + [(m, "c-ortho") for m in ("ccnn", "xpdnet", "lpdnet")]


@pytest.mark.parametrize("model,conv", FORWARD_CASES)
def test_zoo2_forward_matches_jax(model, conv):
    cfg = _cfg(model, conv)
    y, sens, mask, _ = _data(seed=len(model))
    v = _jax_vars(cfg, y, sens, mask, seed=1)
    want = _jax_predict(cfg, v, y, sens, mask)
    with torch.no_grad():
        got = _port(cfg, v)(*_t(y, sens, mask)).prediction
    assert got.shape == (B, H, W, 2) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("model", ["xpdnet", "dunet"])
def test_zoo2_forward_matches_jax_at_an_odd_size(model):
    cfg = _cfg(model)
    y, sens, mask, _ = _data(b=1, c=3, h=33, w=37, seed=11)
    v = _jax_vars(cfg, y, sens, mask, seed=2)
    want = _jax_predict(cfg, v, y, sens, mask)
    with torch.no_grad():
        _close(_port(cfg, v)(*_t(y, sens, mask)).prediction, want)


@pytest.mark.parametrize("model", list(MODELS))
def test_zoo2_bf16_compute_matches_jax(model):
    """bf16 compute against the JAX package's, at the bf16 limits. LPDNet's
    two iterations of 4-filter NormUnets put the JAX package's own bf16
    prediction 3.5% of the largest magnitude from its float32 one at these
    inputs, beyond the elementwise limit, and the port's lies as far (two
    independent roundings): there both are held to the float32 prediction,
    the port no farther from it than 1.5 x the JAX package's distance."""
    cfg = _cfg(model, compute_dtype="bfloat16")
    y, sens, mask, _ = _data(seed=5)
    v = _jax_vars(cfg, y, sens, mask, seed=2)
    want = _jax_predict(cfg, v, y, sens, mask)
    with torch.no_grad():
        got = _port(cfg, v)(*_t(y, sens, mask)).prediction.numpy()
    assert got.dtype == np.float32
    assert _rel_l2(got, want) < BF16_REL_L2
    if model != "lpdnet":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * float(np.abs(want).max()))
        return
    f32 = _jax_predict(_cfg(model), v, y, sens, mask)
    jax_dist, port_dist = np.abs(want - f32).max(), np.abs(got - f32).max()
    assert jax_dist > BF16_ATOL * float(np.abs(f32).max()) and port_dist <= 1.5 * jax_dist


def _jax_loss_and_grads(cfg, v, y, sens, mask, target):
    model = jax_build_model(cfg)
    rest = {k: val for k, val in v.items() if k != "params"}

    def loss_fn(p):
        out = model.apply({"params": p, **rest}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(JOut(prediction=out.prediction, intermediates=out.intermediates), jnp.asarray(target), "l1")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return float(loss), zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads), **rest}, cfg)


def _check_grads(cfg, seed, data_seed=7, per_parameter=False):
    y, sens, mask, target = _data(seed=data_seed)
    v = _jax_vars(cfg, y, sens, mask, seed=seed)
    want_loss, want = _jax_loss_and_grads(cfg, v, y, sens, mask, target)
    m = _port(cfg, v)
    loss = process_reconstruction_loss(m(*_t(y, sens, mask), train=True), torch.from_numpy(target), "l1")
    loss.backward()
    _close(float(loss.detach()), want_loss)
    got = {k: p.grad for k, p in m.named_parameters()}
    assert sorted(got) == sorted(k for k in want if k in got) and len(got) > 0
    for k in got:
        if float(np.abs(want[k].numpy()).max()) == 0:
            # the first cascade's soft DC sees pred = y: its weight's gradient is 0
            assert k.endswith("0.dc_weight") and not got[k].any(), k
        elif per_parameter:
            assert _rel_l2(got[k], want[k].numpy()) < GRAD_REL_L2, k
        else:
            _close(got[k], want[k].numpy(), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("model", list(MODELS))
def test_zoo2_loss_and_gradients_match_jax_grad(model):
    """The training loss (CRNNet's over its intermediates), and every
    parameter's gradient against jax.grad: elementwise, but LPDNet's (its
    NormUnets' LeakyReLU kinks flip between the packages at these inputs,
    moving single gradient elements; ROADMAP.md's NormUnet trap) per
    parameter at relative l2 1e-2 (the worst reads 2.3e-3)."""
    conv = "c-ortho" if model in ("xpdnet", "lpdnet") else "u-backward"
    _check_grads(_cfg(model, conv), seed=3, per_parameter=model == "lpdnet")


@pytest.mark.parametrize("term", ["ID", "GD", "PROX", "VS"])
def test_dunet_dc_terms_match_jax(term):
    cfg = _cfg("dunet", data_consistency_term=term, data_consistency_iterations=3)
    y, sens, mask, _ = _data(seed=12)
    v = _jax_vars(cfg, y, sens, mask, seed=4)
    if term == "PROX":  # lambda near its init, so that the CG is well posed
        v["params"] = {k: (np.full((1,), 0.1, np.float32) if k.startswith("lambda") else a)
                       for k, a in v["params"].items()}
    want = _jax_predict(cfg, v, y, sens, mask)
    with torch.no_grad():
        _close(_port(cfg, v)(*_t(y, sens, mask)).prediction, want)
    if term in ("GD", "VS"):
        _check_grads(cfg, seed=4, data_seed=13)


def test_dunet_starts_from_a_loaders_initial_prediction():
    cfg = _cfg("dunet")
    y, sens, mask, _ = _data(seed=14)
    init = np.random.default_rng(15).standard_normal((B, H, W, 2)).astype(np.float32)
    v = _jax_vars(cfg, y, sens, mask, seed=5)
    want = _jax_predict(cfg, v, y, sens, mask, init)
    with torch.no_grad():
        _close(_port(cfg, v)(*_t(y, sens, mask, init)).prediction, want)


def test_xpdnet_takes_both_parameter_layouts():
    """The unrolled tree and the ``scan_iterations`` tree (each leaf stacked
    over the iterations) give the same port model, equal to both JAX paths."""
    cfg = _cfg("xpdnet")
    y, sens, mask, _ = _data(seed=16)
    v = _jax_vars(cfg, y, sens, mask, seed=6)
    from mridc_tpu.models.recon.xpdnet import stack_iteration_params

    scanned = {"params": jax.tree_util.tree_map(np.asarray, stack_iteration_params(v["params"], cfg["num_iter"]))}
    a, b = zoo2_params_from_jax(v, cfg), zoo2_params_from_jax(scanned, {**cfg, "scan_iterations": True})
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    want_u = _jax_predict(cfg, v, y, sens, mask)
    want_s = _jax_predict({**cfg, "scan_iterations": True}, scanned, y, sens, mask)
    with torch.no_grad():
        got = _port({**cfg, "scan_iterations": True}, scanned)(*_t(y, sens, mask)).prediction
    _close(got, want_u)
    _close(got, want_s)


# ---- the weight carry, names and building ----


@pytest.mark.parametrize("model", list(MODELS))
def test_params_carry_every_leaf_both_ways(model):
    cfg = _cfg(model)
    y, sens, mask, _ = _data(seed=19)
    v = _jax_vars(cfg, y, sens, mask)
    state = zoo2_params_from_jax(v, cfg)
    assert sorted(state) == sorted(build_model(cfg, device="cpu").state_dict())
    back = zoo2_params_to_jax(state, cfg)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, v, back))
    with pytest.raises(KeyError, match="not used"):
        zoo2_params_from_jax({"params": {**v["params"], "extra": np.zeros(1)}}, cfg)
    with pytest.raises(KeyError, match="missing"):
        zoo2_params_to_jax({k: t for k, t in list(state.items())[1:]}, cfg)


def test_state_dict_names():
    names = {m: set(build_model(_cfg(m), device="cpu").state_dict()) for m in MODELS}
    assert {"cascades.1.dc_weight", "cascades.1.model.convs.2.weight", "cascades.0.model.prelus.1"} <= names["ccnn"]
    assert {"block.dc_weight", "block.model.convs.0.bias"} <= names["crnn"]
    assert {"iterations.1.image_model.mwcnn.up_dil.1.convs.1.weight", "iterations.0.image_model.head.bias"} <= \
        names["xpdnet"]
    assert {"kspace_model.dubs.0.conv_agg_2.weight", "kspace_model.recon_block.convs.0.prelu", "dc_weight",
            "image_model.out.weight"} <= names["kikinet"]
    assert {"dual_model.unet.conv.layers.0.weight", "primal_model.unet.up_conv.1.1.bias"} <= names["lpdnet"]
    assert {"cascades.1.weighted_avg", "cascades.1.dc_weight"} <= names["vsnet"]
    assert {"regs.1.up2.conv.weight", "lambdas.1"} <= names["dunet"]


@pytest.mark.parametrize("name", ["CascadeNet", "CCNN", "CRNNet", "CRNN", "XPDNet", "KIKINet", "LPDNet", "LPD",
                                  "VSNet", "DUNet"])
def test_zoo2_builds_on_the_card_unless_told_otherwise(name, monkeypatch):
    assert name.upper() in available_models() and name.upper() not in PENDING_MODELS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model({"model_name": name})
    small = {"num_cascades": 1, "num_iterations": 1, "num_iter": 1, "hidden_channels": 4, "didn_hidden_channels": 4,
             "kspace_didn_hidden_channels": 4}
    assert build_model({"model_name": name, **small}, device="cpu") is not None


def test_zoo2_weights_come_from_the_generator_alone():
    for m in ("kikinet", "dunet"):
        torch.manual_seed(0)
        a = build_model(_cfg(m), device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
        torch.manual_seed(1)
        b = build_model(_cfg(m), device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


def _yaml(name):
    return yaml.safe_load((ROOT / f"projects/reconstruction/conf/base_{name}_train.yaml").read_text())


class _Built(Exception):
    pass


@pytest.mark.parametrize("name", list(YAMLS))
def test_yaml_model_blocks_build_through_the_launcher(name, monkeypatch, tmp_path):
    """``python -m mridc_tpu_torch run -c base_<model>_train.yaml`` builds the
    model (stopped right after ``build_model``, before any data is read)."""
    from mridc_tpu_torch import models

    built = {}
    orig = models.build_model

    def stop(cfg, device=None, generator=None):
        built["model"] = orig(cfg, device=device, generator=generator)
        raise _Built

    monkeypatch.setattr(models, "build_model", stop)
    path = ROOT / f"projects/reconstruction/conf/base_{YAMLS[name]}_train.yaml"
    with pytest.raises(_Built):
        cli.main(["run", "-c", str(path), "trainer.accelerator=cpu", f"exp_manager.exp_dir={tmp_path}"])
    assert type(built["model"]).__name__ == {"ccnn": "CascadeNet"}.get(name, _yaml(name)["model"]["model_name"])


# ---- chip_smoke.py's configurations and launch tables, on the CPU path ----


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", list(YAMLS))
def test_chip_smoke_zoo2_configs_are_the_yamls(name):
    cs = _chip_smoke()
    model = _yaml(name)["model"]
    cfg = {**cs.ZOO_COMMON, **cs.ZOO2_CFGS[name]}
    assert {k: model[k] for k in cfg} == cfg
    assert not {k for k in model if k not in cfg and not k.endswith("_ds")} - {
        "sens_chans", "sens_pools", "sens_mask_type", "complex_data", "log_images", "train_loss_fn",
        "val_loss_fn", "optim"}
    assert model["train_ds"]["batch_size"] == cs.ZOO2_TRAIN_BATCH == 1
    assert model["optim"] == cs.TRAIN_OPTIM


def test_chip_smoke_zoo2_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.ZOO2_PER_FORWARD and ZOO2_PER_STEP derive the K2 launches
    of the seven models' forwards and training steps; on the CPU path each K2
    Function calls its plain version where the card launches its stages, so
    counting the stages those calls stand for must give the same tables.
    Widths are cut; iterations, cascades and the primal/dual counts (which the
    tables scale with) are kept."""
    cs = _chip_smoke()
    counts = {}

    def count(name, symbols):
        orig = getattr(k2, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(k2, name, wrapped)

    def load(needed, fft_order):
        return ["k2_load"] if needed and not fft_order else []

    count("sens_expand_plain", lambda x, s, c=False, n="backward", fft_order=False, mask=None:
          ["k2_expand", *(["k2_mask"] if mask is not None else []), *load(c, fft_order)])
    count("sens_expand_bwd_plain", lambda g, s, c=False, n="backward", fft_order=False, mask=None:
          [*load(c or mask is not None, fft_order), "k2_reduce"])
    count("sens_reduce_plain", lambda k, s, m=None, c=False, *a, fft_order=False, **kw:
          [*load(c or m is not None, fft_order), "k2_reduce"])
    count("sens_reduce_bwd_plain", lambda g, s, m=None, c=False, n="backward", fft_order=False:
          ["k2_expand", *(["k2_mask"] if m is not None else []), *load(c, fft_order)])
    count("full_dc_plain", lambda *a, **kw: ["k2_expand", "k2_residual", "k2_reduce"])
    count("full_dc_bwd_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce_acc"])
    y, sens, mask, target = _data(b=1, c=3, h=16, w=16, seed=21)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    cut = {"hidden_channels": 4, "mwcnn_hidden_channels": 4, "kspace_didn_hidden_channels": 4,
           "kspace_didn_num_dubs": 1, "image_mwcnn_hidden_channels": 4, "primal_unet_num_filters": 4,
           "dual_unet_num_filters": 4, "imspace_conv_hidden_channels": 4, "didn_hidden_channels": 4,
           "didn_num_dubs": 1}
    for name, cfg in cs.ZOO2_CFGS.items():
        cfg = {**cs.ZOO_COMMON, **cfg, **{k: v for k, v in cut.items() if k in cfg}}
        model = build_model(cfg, device="cpu")
        counts.clear()
        with torch.no_grad():
            model(*_t(y, sens, mask))
        assert counts == cs.ZOO2_PER_FORWARD[name], name
        trainer = Trainer(model, optim_cfg=cs.TRAIN_OPTIM, device="cpu")
        counts.clear()
        trainer.training_batch(batch)
        assert counts == cs.ZOO2_PER_STEP[f"train_{name}"], name
