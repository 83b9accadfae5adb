"""Port parity: learned sensitivity maps. ``SensitivityModel`` against
``mridc_tpu.nn.sens`` (batch 1 and 2, 1D and 2D ``mask_type``, ACS masking
and RSS normalisation on and off, ``num_low_frequencies``); the maps'
gradient of every K1 and K2 Function against ``jax.vjp`` of the JAX package's
functions in both centerings and all three normalisations, against float64
``gradcheck``, and the card's chain of stages (their plain versions, the
same index arithmetic) against each Function's plain backward; the
``use_sens_net`` wrapper over CIRIM (full and psf1d), VarNet, ResNet (the
CG's ``normal_op``), XPDNet (the masked ``sens_expand``), IDSLR and SERANet:
forward, loss and every gradient, the sens net's included, against
``jax.grad``; the weight carry and archives of the wrapped multitask models
(IDSLR, IDSLRUNet, SegNet, RecSegUNet, SERANet); the registry
wraps what ``mridc_tpu`` wraps and raises where it raises; archives of
wrapped models both ways, and the reference-archive repair.

Inputs come from numpy seeds at 2-3 coils and at most 32x32; weights are
drawn by ``init`` of the JAX model and carried over by
``utils.params.params_from_jax``. Forward and loss: rtol 2e-3 / atol 2e-4
of the largest magnitude (``tests/test_torch_parity.py:131``); gradients:
elementwise at rtol 2e-3 / atol 1e-3 of each parameter's largest magnitude
(``tests/test_torch_port_zoo.py``).
"""

import importlib
import io
import json
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import available_models as jax_models
from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.sens_wrapper import _SENS_UNSUPPORTED as JAX_UNSUPPORTED
from mridc_tpu.nn.sens import SensitivityModel as JSensitivityModel
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu.utils import torch_import as jti
from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.models import available_models, build_model
from mridc_tpu_torch.models.sens_wrapper import _SENS_UNSUPPORTED, estimator, is_wrapped
from mridc_tpu_torch.nn import dc as tdc
from mridc_tpu_torch.nn.sens import SensitivityModel
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.utils.params import normunet_params_from_jax, params_from_jax, params_to_jax

jdc = importlib.import_module("mridc_tpu.nn.dc")

RTOL, ATOL = 2e-3, 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
FFT_MODES = [(c, n) for c in (False, True) for n in ("backward", "ortho", "forward")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


def _data(b=2, c=3, h=16, w=20, seed=0, soft=True, acs=(6, 4)):
    """Masked k-space [B, C, H, W, 2] (y also off the mask), maps, a column
    mask with a centre band of ``acs[i]`` columns for example i (soft
    weights elsewhere when ``soft``), an image and an upstream [B, H, W, 4]."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, c, h, w, 2)).astype(np.float32)
    sens = rng.standard_normal((b, c, h, w, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    cols = (rng.random((b, w)) < 0.3).astype(np.float32)
    if soft:
        cols *= rng.uniform(0.3, 1.0, (b, w)).astype(np.float32)
    for i in range(b):
        a = acs[i % len(acs)]
        cols[i, w // 2 - a // 2: w // 2 - a // 2 + a] = 1.0
    mask = np.broadcast_to(cols[:, None, None, :], (b, 1, h, w)).copy()
    eta = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    g = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    return y, sens, mask, eta, g


# ---- SensitivityModel ----

SENS_CASES = {
    "b1_2d": (1, "2D", True, True, None), "b1_1d": (1, "1D", True, True, None),
    "b2_2d": (2, "2D", True, True, None), "b2_1d_no_norm": (2, "1D", True, False, None),
    "b1_no_center": (1, "2D", False, True, None), "b2_nlf": (2, "2D", True, True, 6),
    "b1_nlf_no_norm": (1, "2D", True, False, 4),
}


@pytest.mark.parametrize("case", sorted(SENS_CASES))
@pytest.mark.parametrize("centered,norm", [(False, "backward"), (True, "ortho")])
def test_sensitivity_model_matches_jax(case, centered, norm):
    """The ACS band (width read from row 0 per example; on H for batch 1 in
    2D, on W otherwise), the per-coil NormUnet and the RSS normalisation."""
    b, mask_type, center, normalize, nlf = SENS_CASES[case]
    y, _, mask, _, _ = _data(b=b, seed=1, soft=False)
    kw = dict(mask_type=mask_type, fft_centered=centered, fft_normalization=norm, normalize=normalize,
              mask_center=center)
    jm = JSensitivityModel(chans=4, num_pools=2, **kw)
    params = numpy_init(jm, y, mask, seed=b)
    want = jm.apply({"params": params}, jnp.asarray(y), jnp.asarray(mask), nlf)
    model = SensitivityModel(chans=4, num_pools=2, **kw)
    model.norm_unet.load_state_dict(normunet_params_from_jax(params["NormUnet_0"]))
    got = model(*_t(y, mask), num_low_frequencies=nlf)
    _close(got, want)
    assert sorted(model.state_dict()) == sorted(f"norm_unet.{k}" for k in model.norm_unet.state_dict())
    assert all(k.startswith("norm_unet.unet.") for k in model.state_dict())


# ---- the maps' gradient of the K1 and K2 Functions ----


def _psf1d_operands(mask, centered, norm):
    return tdc.psf1d_gauss_mats(torch.from_numpy(mask)[:, 0, 0, :], centered, norm)


def _functions(centered, norm, y, mask, mats, dtype=torch.float32):
    """name -> (port function of (x, s), JAX function of (x, s), x's array):
    each Function with its maps as the second differentiable input."""
    ty, tm = _t(y, mask, dtype=dtype)
    tmats = mats.to(dtype)
    z0 = np.random.default_rng(7).standard_normal(y.shape[:1] + y.shape[2:]).astype(np.float32)
    tz0 = torch.from_numpy(z0).to(dtype)
    jy, jm, jmats = jnp.asarray(y), jnp.asarray(mask), jnp.asarray(mats.float().numpy())
    m_rv = jdc.expand_rv_mask(jm)

    def jreorder(k):
        return jnp.fft.ifftshift(k, axes=(-3, -2)) if centered else k

    return {
        "full_dc": (lambda x, s: k2.full_dc(x, ty, s, tm, 0.7, centered, norm),
                    lambda x, s: jdc.log_likelihood_gradient(x, jy, s, jm, 0.7, centered, norm), "image"),
        "sens_expand_masked": (lambda x, s: k2.sens_expand(x, s, centered, norm, mask=tm),
                               lambda x, s: m_rv * jdc.sens_expand(x, s, centered, norm), "image"),
        "sens_expand_fft_order": (lambda x, s: k2.sens_expand(x, s, centered, norm, fft_order=True),
                                  lambda x, s: jreorder(jdc.sens_expand(x, s, centered, norm)), "image"),
        "sens_reduce_masked": (lambda k, s: k2.sens_reduce(k, s, tm, centered, norm),
                               lambda k, s: jdc.sens_reduce(m_rv * k, s, centered, norm), "kspace"),
        "sens_reduce_fft_order": (
            lambda k, s: k2.sens_reduce(k, s, None, centered, norm, fft_order=True),
            lambda k, s: jdc.sens_reduce(jnp.fft.fftshift(k, axes=(-3, -2)) if centered else k, s, centered,
                                         norm), "kspace"),
        "normal_op": (lambda x, s: k2.normal_op(x, s, tm, 0.3, centered, norm),
                      lambda x, s: _jax_ehe(x, s, jm, 0.3, centered, norm), "image"),
        "psf1d_dc": (lambda x, s: k1.psf1d_dc(x, s, tmats, tz0, 0.7),
                     lambda x, s: jdc.log_likelihood_gradient_psf1d(x, s, jmats, jnp.asarray(z0), 0.7), "image"),
    }


def _jax_ehe(x, sens, mask, mu, centered, norm):
    """``mridc_tpu/models/recon/resnet.py:67-71`` ``ehe``."""
    from mridc_tpu.ops.cplx import cmul, cmul_conj
    from mridc_tpu.ops.fft import fft2_rv, ifft2_rv

    k = fft2_rv(cmul(x[:, None], sens), centered, norm)
    img = ifft2_rv(k * mask[..., None], centered, norm)
    return cmul_conj(img, sens).sum(axis=1) + mu * x


FUNCTIONS = ["full_dc", "sens_expand_masked", "sens_expand_fft_order", "sens_reduce_masked", "sens_reduce_fft_order",
             "normal_op", "psf1d_dc"]


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_maps_gradient_matches_jax_vjp(name, centered, norm):
    """At an odd size: the gradient with respect to the maps (and the
    image or k-space beside it) against ``jax.vjp``."""
    y, sens, mask, eta, _ = _data(h=15, w=17, seed=3)
    mats = _psf1d_operands(mask, centered, norm)
    port, jfn, first = _functions(centered, norm, y, mask, mats)[name]
    x = y if first == "kspace" else eta
    out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(sens))
    g = np.random.default_rng(5).standard_normal(out.shape).astype(np.float32)
    dx, ds = vjp(jnp.asarray(g))
    tx, ts = (t.requires_grad_(True) for t in _t(x, sens))
    got = port(tx, ts)
    _close(got, out)
    got.backward(torch.from_numpy(g))
    _close(tx.grad, dx)
    _close(ts.grad, ds)
    assert float(np.abs(np.asarray(ds)).max()) > 0


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_maps_gradient_passes_gradcheck_in_float64(name, centered, norm):
    y, sens, mask, eta, _ = _data(b=2, c=2, h=5, w=7, seed=4, acs=(2,))
    mats = _psf1d_operands(mask, centered, norm).double()
    port, _, first = _functions(centered, norm, y, mask, mats, dtype=torch.float64)[name]
    x = y if first == "kspace" else eta
    tx, ts = (t.requires_grad_(True) for t in _t(x, sens, dtype=torch.float64))
    assert torch.autograd.gradcheck(port, (tx, ts))
    # the maps alone (the image or k-space fixed)
    assert torch.autograd.gradcheck(lambda s: port(tx.detach(), s), (ts,))


@pytest.fixture
def card_chain(monkeypatch):
    """The card's branch of K2's backward functions on CPU tensors: the
    stage wrappers are their plain versions (the kernels' index arithmetic)
    and the device check names the card, so each function composes the
    stages around torch.fft as it does on the card."""
    for n in ("expand", "residual", "load", "reduce", "apply_mask", "reduce_acc", "sens_grad"):
        monkeypatch.setattr(k2, n, getattr(k2, f"{n}_plain"))
    monkeypatch.setattr(k2, "device_of", lambda name, *t: torch.device("cuda"))


@pytest.mark.parametrize("centered,norm", [(False, "backward"), (True, "ortho"), (True, "forward")])
@pytest.mark.parametrize("size", [(15, 17), (16, 12)])
def test_card_chain_of_the_maps_gradient_matches_the_plain_backward(card_chain, centered, norm, size):
    """The chains the card runs (the forward's coil image recomputed, d_eta's
    chain, one sens_grad stage with its coil sum) against the plain backward
    of each Function, at an odd and an even size."""
    y, sens, mask, eta, g = _data(h=size[0], w=size[1], seed=6)
    ty, ts, tm, te, tg = _t(y, sens, mask, eta, g)
    gk = torch.from_numpy(np.random.default_rng(8).standard_normal(y.shape).astype(np.float32))
    pairs = [
        (k2.full_dc_bwd_sens(tg, te, ty, ts, tm, 0.7, centered, norm),
         k2.full_dc_bwd_sens_plain(tg, te, ty, ts, tm, 0.7, centered, norm)),
        (k2.sens_expand_bwd_sens(gk, te, ts, centered, norm, mask=tm),
         k2.sens_expand_bwd_sens_plain(gk, te, ts, centered, norm, mask=tm)),
        (k2.sens_expand_bwd_sens(gk, te, ts, centered, norm, fft_order=True),
         k2.sens_expand_bwd_sens_plain(gk, te, ts, centered, norm, fft_order=True)),
        ((k2.sens_reduce_bwd_sens(tg[..., :2], ty, ts, tm, centered, norm),),
         (k2.sens_reduce_bwd_sens_plain(tg[..., :2], ty, ts, tm, centered, norm),)),
        ((k2.sens_reduce_bwd_sens(tg[..., 2:], ty, ts, None, centered, norm, fft_order=True),),
         (k2.sens_reduce_bwd_sens_plain(tg[..., 2:], ty, ts, None, centered, norm, fft_order=True),)),
        (k2.normal_op_bwd_sens(tg[..., 2:], te, ts, tm, torch.tensor([0.3]), centered, norm),
         k2.normal_op_bwd_sens_plain(tg[..., 2:], te, ts, tm, torch.tensor([0.3]), centered, norm)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            _close(a, b.numpy(), rtol=1e-5, atol=1e-5)


def test_sens_grad_stage_reads_at_the_shifted_index():
    """The stage's plain version against numpy's fftshift of the coil images,
    with both terms, the coil sum and the accumulated channels."""
    rng = np.random.default_rng(9)
    b, c, h, w = 2, 3, 7, 6
    a, a2 = (rng.standard_normal((b, c, h, w)) + 1j * rng.standard_normal((b, c, h, w)) for _ in range(2))
    e, e2, s = (rng.standard_normal(sh) + 1j * rng.standard_normal(sh) for sh in ((b, h, w), (b, h, w), (b, c, h, w)))
    acc = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    rv = lambda z: torch.from_numpy(np.stack([z.real, z.imag], -1).astype(np.float32))  # noqa: E731
    ds, total = k2.sens_grad_plain(torch.from_numpy(a.astype(np.complex64)), rv(e), True, 0.5,
                                   a2=torch.from_numpy(a2.astype(np.complex64)), b2=rv(e2), sens=rv(s),
                                   acc=torch.from_numpy(acc))
    sa, sa2 = (np.fft.fftshift(z, axes=(-2, -1)) for z in (a, a2))
    want = 0.5 * (sa * np.conj(e[:, None]) + sa2 * np.conj(e2[:, None]))
    _close(ds, np.stack([want.real, want.imag], -1), rtol=1e-5, atol=1e-6)
    tot = acc[..., 0] + 1j * acc[..., 1] + 0.5 * (np.conj(s) * sa).sum(1)
    _close(total, np.stack([tot.real, tot.imag], -1), rtol=1e-5, atol=1e-6)


def test_fixed_maps_save_and_launch_what_they_did():
    """Maps that take no gradient: each Function saves what it saved before
    (no image or k-space beside the maps and the mask), so a path with fixed
    maps keeps its memory; the maps' gradient saves one image-sized tensor."""
    y, sens, mask, eta, _ = _data(seed=10)
    ty, ts, tm, te = _t(y, sens, mask, eta)
    mats = _psf1d_operands(mask, False, "backward")
    z0 = torch.zeros_like(te)
    te.requires_grad_(True)
    for fixed, learned in (
        (lambda: k2.full_dc(te, ty, ts, tm), lambda s: k2.full_dc(te, ty, s, tm)),
        (lambda: k2.sens_expand(te, ts), lambda s: k2.sens_expand(te, s)),
        (lambda: k2.normal_op(te, ts, tm, 0.1), lambda s: k2.normal_op(te, s, tm, 0.1)),
        (lambda: k1.psf1d_dc(te, ts, mats, z0), lambda s: k1.psf1d_dc(te, s, mats, z0)),
    ):
        saved = [t for t in fixed().grad_fn.saved_tensors if t is not None]
        assert all(t.shape in (ts.shape, tm.shape, mats.shape, (1,), ()) for t in saved)
        learned_saved = [t for t in learned(ts.clone().requires_grad_(True)).grad_fn.saved_tensors if t is not None]
        assert len(learned_saved) - len(saved) in (1, 2)
        assert te.shape in [t.shape for t in learned_saved]


# ---- the use_sens_net wrapper ----

B, C, H, W = 2, 3, 16, 20
WRAPPED = {
    "cirim_full": {"model_name": "CIRIM", "num_cascades": 2, "time_steps": 2, "recurrent_layer": "IndRNN",
                   "conv_filters": [4, 4, 2], "conv_kernels": [5, 3, 3], "conv_dilations": [1, 2, 1],
                   "recurrent_filters": [4, 4, 0], "recurrent_kernels": [1, 1, 0], "recurrent_dilations": [1, 1, 0],
                   "fft_centered": True, "fft_normalization": "ortho"},
    "varnet": {"model_name": "VN", "num_cascades": 2, "channels": 4, "pooling_layers": 1},
    "resnet_cg": {"model_name": "ResNet", "unrolled_iterations": 2, "residual_blocks": 1, "channels": 4,
                  "conjugate_gradient_dc": True, "conjugate_gradient_iterations": 3, "penalization_weight": 0.05},
    "xpdnet": {"model_name": "XPDNet", "num_iter": 2, "num_primal": 3, "use_primal_only": True,
               "image_model_architecture": "MWCNN", "mwcnn_hidden_channels": 4, "mwcnn_num_scales": 2,
               "fft_centered": True, "fft_normalization": "ortho"},
}
WRAPPED["cirim_psf1d"] = {**WRAPPED["cirim_full"], "dc_mode": "psf1d"}
# JointICNet keeps its own estimator beside the wrapper's (other widths)
WRAPPED["jointicnet"] = {"model_name": "JointICNet", "num_iter": 2, "kspace_unet_num_filters": 4,
                         "kspace_unet_num_pool_layers": 1, "imspace_unet_num_filters": 4,
                         "imspace_unet_num_pool_layers": 1, "sens_unet_num_filters": 4,
                         "sens_unet_num_pool_layers": 2}
# the multitask models whose flax scopes are named on their modules: the wrapper's estimator maps under
# SensitivityModel_0 only, never into the model's own scopes (their outputs are (recon, segmentation))
_U = {"segmentation_module_channels": 4, "segmentation_module_pooling_layers": 2}
WRAPPED.update({
    "idslr": {"model_name": "IDSLR", "num_iters": 2, **_U},
    "idslrunet": {"model_name": "IDSLRUNET", "num_iters": 2, **_U},
    "segnet": {"model_name": "SegNet", "num_iters": 2, **_U},
    "recsegunet": {"model_name": "RecSegUNet", "reconstruction_module_channels": 4, "segmentation_module_channels": 4},
    "seranet": {"model_name": "SERANet", "reconstruction_module_channels": 4, "reconstruction_module_pooling_layers": 2,
                "recurrent_module_attention_channels": 4, "recurrent_module_attention_pooling_layers": 2,
                "num_iterations": 2, **_U},
})
MULTITASK = ("idslr", "idslrunet", "segnet", "recsegunet", "seranet")
_STEP_SIZES = ("reg_param_I", "reg_param_F", "reg_param_C", "lr_image", "lr_sens")
SENS = {"use_sens_net": True, "sens_chans": 4, "sens_pools": 1}


def _wrapped_cfg(name):
    return {**WRAPPED[name], **SENS}


def _wrapped_data(seed):
    y, sens, mask, _, _ = _data(b=B, c=C, h=H, w=W, seed=seed, soft=False)
    target = np.random.default_rng(seed + 1).standard_normal((B, H, W)).astype(np.float32)
    return y * mask[..., None], sens, mask, target


def numpy_init(jmodel, *args, seed=0):
    """A flax param tree of ``jmodel`` in the shapes ``init`` gives (read by
    ``jax.eval_shape``, which compiles nothing; the initialisers' compilation
    takes tens of seconds on the CPU), drawn with numpy: kernels at unit
    variance over their fan-in, every other leaf uniform in [0.5, 1.5)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _jax_init(cfg, y, sens, mask, seed=0):
    params = numpy_init(jax_build_model(cfg), y, sens, mask, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for k in _STEP_SIZES:  # JointICNet's: small, so that its updates stay contractive
        if k in params.get("model", {}):
            params["model"][k] = rng.uniform(0.05, 0.3, params["model"][k].shape).astype(np.float32)
    return params


def _port_model(cfg, params):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return model


def _recon(out):
    """The reconstruction output of a model's call: a multitask model's is the
    first of (reconstruction, segmentation)."""
    return out[0] if isinstance(out, tuple) else out


def _jax_loss_and_grads(cfg, params, y, sens, mask, target):
    model = jax_build_model(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(_recon(out), jnp.asarray(target), "l1")  # CIRIM's intermediates included

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads), cfg)


@pytest.mark.parametrize("name", sorted(set(WRAPPED) - {"idslrunet", "segnet", "recsegunet"}))
def test_wrapped_model_forward_loss_and_gradients_match_jax(name):
    """The dataset's maps are ignored (zeros give the same prediction); the
    sens net's gradients, which reach it only through the maps' gradient of
    the DC Functions, match ``jax.grad`` with every other parameter's. A
    multitask model's segmentation matches too; its loss is the
    reconstruction's. The multitask models run in float64 in both packages:
    in float32 the jitted ``jax.grad`` and the port's IDSLR encoder gradients
    differ by up to ~3e-2 (relative l2), roundoff that its U-Nets amplify (as
    ``tests/test_torch_port_multitask.py`` notes), while in float64 they
    agree to ~2e-6."""
    f64 = name in MULTITASK
    with jax.enable_x64(f64):
        _wrapped_model_matches_jax(name, np.float64 if f64 else np.float32)


def _wrapped_model_matches_jax(name, dtype):
    cfg = _wrapped_cfg(name)
    y, sens, mask, target = (a.astype(dtype) for a in _wrapped_data(seed=11))
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), _jax_init(cfg, y, sens, mask, seed=2))
    assert set(params) == {"SensitivityModel_0", "model"}
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    model = _port_model(cfg, params).to(tdt)
    assert is_wrapped(model) and type(model).__name__.endswith("WithSensNet")
    jout = jax_build_model(cfg).apply({"params": params}, *(jnp.asarray(a) for a in (y, sens, mask)))
    want = _recon(jout).prediction
    with torch.no_grad():
        out = model(*_t(y, sens, mask, dtype=tdt))
        _close(_recon(out).prediction, want)
        if name in MULTITASK:
            _close(out[1], jout[1])
        _close(_recon(model(*_t(y, np.zeros_like(sens), mask, dtype=tdt))).prediction, want)
    want_loss, want_grads = _jax_loss_and_grads(cfg, params, y, sens, mask, target)
    loss = process_reconstruction_loss(_recon(model(*_t(y, sens, mask, dtype=tdt), train=True)),
                                       torch.from_numpy(target), "l1")
    loss.backward()
    _close(float(loss.detach()), want_loss)
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    # JointICNet ignores the maps it is given (its own sens_net estimates them), so the wrapper's
    # estimator takes no gradient there, in either package, and its own estimator does
    fed = "sens_net." if name == "jointicnet" else f"{model.sens_attr}."
    sens_keys = [k for k in want_grads if k.startswith(fed)]
    assert sens_keys and any(float(want_grads[k].abs().max()) > 0 for k in sens_keys)
    for k, w_ in want_grads.items():
        if got_grads[k] is None:  # a parameter no output reads: jax.grad's zero
            assert not k.startswith(fed) and float(w_.abs().max()) == 0, k
            continue
        _close(got_grads[k], w_.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_registry_wraps_what_jax_wraps():
    """Every registry name with ``use_sens_net: true``: the port builds a
    wrapped model where ``mridc_tpu`` builds its ``WithSensNet``, and raises
    the same ``ValueError`` where it raises."""
    from mridc_tpu.models.sens_wrapper import WithSensNet as JWithSensNet

    assert _SENS_UNSUPPORTED == JAX_UNSUPPORTED
    assert set(available_models()) == set(jax_models())
    for name in sorted(jax_models()):
        cfg = {"model_name": name, "use_sens_net": True, "sens_chans": 2, "sens_pools": 1}
        try:
            jm = jax_build_model(cfg)
        except ValueError as e:
            with pytest.raises(ValueError, match="use_sens_net is not supported"):
                build_model(cfg, device="cpu")
            assert "use_sens_net is not supported" in str(e), name
            continue
        assert isinstance(jm, JWithSensNet), name
        model = build_model(cfg, device="cpu")
        assert is_wrapped(model), name
        # the wrapper's estimator at the wrapper's widths, beside the model's own state unchanged
        # (JointICNet keeps its own estimator, as the JAX package's inner SensitivityModel_0)
        est = estimator(model)
        unet = est.norm_unet.unet
        assert (unet.down_sample_layers[0].layers[0].weight.shape[0], len(unet.down_sample_layers)) == (2, 1), name
        plain = build_model({k: v for k, v in cfg.items() if k != "use_sens_net"}, device="cpu")
        prefix = f"{model.sens_attr}."
        own = {k: v.shape for k, v in model.state_dict().items() if not k.startswith(prefix)}
        assert own == {k: v.shape for k, v in plain.state_dict().items()}, name
        assert len(own) < len(model.state_dict()), name


@pytest.mark.parametrize("name,prefix", [("cirim_full", "sens_net."), ("jointicnet", "wrapper_sens_net.")])
def test_wrapper_keys_are_the_reference_ones(name, prefix):
    """``sens_net.norm_unet.unet.*`` beside the model's own keys, unprefixed
    (reference ``reconstruction/nn/base.py:406``); ``wrapper_sens_net.*``
    beside a model that has a ``sens_net`` of its own, which stays."""
    plain = build_model(WRAPPED[name], device="cpu")
    model = build_model(_wrapped_cfg(name), device="cpu")
    keys = set(model.state_dict())
    assert {k for k in keys if not k.startswith(prefix)} == set(plain.state_dict())
    assert all(k.startswith(f"{prefix}norm_unet.unet.") for k in keys - set(plain.state_dict()))


@pytest.mark.parametrize("name", ["cirim_full", "varnet", "xpdnet", "jointicnet", *MULTITASK])
def test_params_round_trip_bit_for_bit(name):
    cfg = _wrapped_cfg(name)
    y, sens, mask, _ = _wrapped_data(seed=12)
    params = _jax_init(cfg, y, sens, mask, seed=4)
    state = params_from_jax(params, cfg)
    back = params_to_jax(state, cfg)["params"]
    want, got = jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in sorted(got, key=str)] == [p for p, _ in sorted(want, key=str)]
    by_path = dict((jax.tree_util.keystr(p), v) for p, v in got)
    for p, v in want:
        np.testing.assert_array_equal(by_path[jax.tree_util.keystr(p)], v)


# ---- archives ----


@pytest.mark.parametrize("name", MULTITASK)
def test_wrapped_multitask_archive_round_trips_bit_for_bit(name, tmp_path):
    """``save_archive`` writes one flax leaf per state key of a wrapped
    multitask model (the estimator's under ``SensitivityModel_0`` alone), and
    ``load_archive`` reads back every key bit for bit."""
    cfg = _wrapped_cfg(name)
    y, sens, mask, _ = _wrapped_data(seed=15)
    params = _jax_init(cfg, y, sens, mask, seed=7)
    state = _port_model(cfg, params).state_dict()
    path = checkpoints.save_archive(tmp_path / "port.mridc", cfg, state)
    with tarfile.open(path) as tar:
        tree = checkpoints.decode_flax_msgpack(tar.extractfile("model_weights.msgpack").read())
    assert set(tree) == {"SensitivityModel_0", "model"}
    assert len(jax.tree_util.tree_leaves(tree)) == len(state)
    _, back = checkpoints.load_archive(path)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def _jax_predict(cfg, params, y, sens, mask):
    return np.asarray(jax_build_model(cfg).apply({"params": params}, *(jnp.asarray(a) for a in (y, sens, mask)))
                      .prediction)


@pytest.mark.parametrize("name", ["cirim_full", "varnet"])
def test_wrapped_archives_restore_in_both_packages(name, tmp_path):
    """The port writes a wrapped model in flax msgpack, which
    ``mridc_tpu.restore_model`` restores to the same outputs; an archive
    ``mridc_tpu`` wrote restores in the port."""
    cfg = _wrapped_cfg(name)
    y, sens, mask, _ = _wrapped_data(seed=13)
    params = _jax_init(cfg, y, sens, mask, seed=5)
    model = _port_model(cfg, params)
    path = checkpoints.save_archive(tmp_path / "port.mridc", cfg, model.state_dict())
    with tarfile.open(path) as tar:
        assert sorted(tar.getnames()) == ["model_config.yaml", "model_weights.msgpack"]
    _, jparams, _ = jckpt.restore_model(path)
    want = _jax_predict(cfg, params, y, sens, mask)
    _close(_jax_predict(cfg, jax.tree_util.tree_map(np.asarray, jparams), y, sens, mask), want)
    jpath = jckpt.save_archive(tmp_path / "jax.mridc", cfg, params)
    restored, _, rcfg = checkpoints.restore_model(jpath, device="cpu")
    assert is_wrapped(restored) and rcfg["use_sens_net"]
    with torch.no_grad():
        _close(restored(*_t(y, sens, mask)).prediction, want)


@pytest.mark.parametrize("name", ["cirim_full", "varnet"])
def test_reference_archive_with_a_sens_net_restores_in_the_port(name, tmp_path):
    """The repair: a reference torch archive of a model with ``use_sens_net``
    (``sens_net.norm_unet.unet.*`` beside the model's reference keys).
    ``mridc_tpu`` converts it to a tree whose wrapped scope is named
    ``{Class}_0`` where its ``WithSensNet`` has ``model``, and cannot apply
    it; the port restores it to the outputs of the same weights under the
    right scopes."""
    cfg = _wrapped_cfg(name)
    y, sens, mask, _ = _wrapped_data(seed=14)
    params = _jax_init(cfg, y, sens, mask, seed=6)
    state = params_from_jax(params, cfg)
    buf = io.BytesIO()
    torch.save(state, buf)
    path = tmp_path / "reference.mridc"
    with tarfile.open(path, "w:gz") as tar:
        for member, data in (("model_config.yaml", json.dumps(cfg).encode()), ("model_weights.ckpt", buf.getvalue())):
            info = tarfile.TarInfo(member)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    jmodel, jparams, _ = jckpt.restore_model(path)
    assert set(jparams) != {"SensitivityModel_0", "model"}
    with pytest.raises(Exception):
        jmodel.apply({"params": jparams}, *(jnp.asarray(a) for a in (y, sens, mask)))
    converted = jti.import_reference_model_params(cfg, {k: v.numpy() for k, v in state.items()})
    inner = next(k for k in converted if k != "SensitivityModel_0")
    fixed = {"SensitivityModel_0": converted["SensitivityModel_0"], "model": converted[inner]}
    want = _jax_predict(cfg, fixed, y, sens, mask)
    _close(want, _jax_predict(cfg, params, y, sens, mask))
    restored, _, _ = checkpoints.restore_model(path, device="cpu")
    with torch.no_grad():
        _close(restored(*_t(y, sens, mask)).prediction, want)
