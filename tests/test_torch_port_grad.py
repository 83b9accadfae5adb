"""Port parity: the backward of the K1, K2 and K3 wrappers on the CPU.

On the CPU each wrapper's ``torch.autograd.Function`` runs the plain versions
of its forward and backward kernels, so the hand-derived backward formulas
are held here against ``jax.vjp`` of the JAX package's functions (rtol 2e-3 /
atol 2e-4 of the largest magnitude, the training path's tolerance) and against
``torch.autograd.gradcheck`` in float64, in every FFT normalisation and
centering mode, odd sizes included. Also: ``replicate_pad``'s gradient, the
plain K2 backward stages composing to the backward chain, and the gradients
the wrappers refuse.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mridc_tpu_torch import kernels
from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.kernels import k3_indrnn as k3
from mridc_tpu_torch.nn import dc as tdc
from mridc_tpu_torch.nn import rnn_cells as tcells
from mridc_tpu_torch.nn.layers import replicate_pad
from mridc_tpu_torch.utils.params import hwio_to_oihw

jdc = importlib.import_module("mridc_tpu.nn.dc")
jcells = importlib.import_module("mridc_tpu.nn.rnn_cells")

RTOL, ATOL = 2e-3, 2e-4
B, C = 2, 3
SIZES = [(16, 12), (15, 17)]
FFT_MODES = [(False, "backward"), (True, "ortho"), (True, "forward"), (False, "ortho")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These checks call many tiny ops (gradcheck perturbs one element at a
    time); one intra-op thread keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _data(h, w, seed):
    """Unit-RSS maps, a column mask, masked k-space, an estimate and an
    upstream gradient [B, H, W, 4]."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, h, w, 2)).astype(np.float32)
    sens = rng.standard_normal((B, C, h, w, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    cols = (rng.random((B, 1, 1, w)) < 0.4).astype(np.float32)
    mask = np.broadcast_to(cols, (B, 1, h, w)).copy()
    eta = rng.standard_normal((B, h, w, 2)).astype(np.float32)
    g = rng.standard_normal((B, h, w, 4)).astype(np.float32)
    return y * mask[..., None], sens, mask, eta, g


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


# ---- K1: the psf1d likelihood gradient ----


def _psf1d_operands(y, sens, mask, centered, norm, dtype=torch.float32):
    ty, ts, tm = _t(y, sens, mask, dtype=dtype)
    mats = tdc.psf1d_gauss_mats(tm[:, 0, 0, :].float(), centered, norm).to(dtype)
    z0 = tdc.sens_reduce(tdc.expand_rv_mask(tm) * ty, ts, centered, norm)
    return ts, mats, z0


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_k1_backward_matches_jax_vjp(size, centered, norm):
    y, sens, mask, eta, g = _data(*size, seed=1)
    jm = jdc.psf1d_gauss_mats(jnp.asarray(mask[:, 0, 0, :]), centered, norm)
    jz0 = jdc.sens_reduce(jdc.expand_rv_mask(jnp.asarray(mask)) * jnp.asarray(y), jnp.asarray(sens), centered, norm)
    _, vjp = jax.vjp(lambda e, z: jdc.log_likelihood_gradient_psf1d(e, jnp.asarray(sens), jm, z, sigma=0.5),
                     jnp.asarray(eta), jz0)
    want_eta, want_z0 = vjp(jnp.asarray(g))

    ts, mats, z0 = _psf1d_operands(y, sens, mask, centered, norm)
    te = torch.from_numpy(eta).requires_grad_(True)
    z0.requires_grad_(True)
    kernels.psf1d_dc(te, ts, mats, z0, 0.5).backward(torch.from_numpy(g))
    _close(te.grad, want_eta)
    _close(z0.grad, want_z0)
    # the wrapper of the backward kernel alone, as the Function calls it
    _close(k1.psf1d_dc_bwd(torch.from_numpy(g), ts, mats, 0.5), want_eta)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_k1_backward_passes_gradcheck_in_float64(size, centered, norm):
    y, sens, mask, eta, _ = _data(*size, seed=2)
    ts, mats, z0 = _psf1d_operands(y, sens, mask, centered, norm, torch.float64)
    te = torch.from_numpy(eta).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda e, z: kernels.psf1d_dc(e, ts, mats, z, 0.7),
                                    (te, z0.requires_grad_(True)))


# ---- K2: the full-mask likelihood gradient ----


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_k2_backward_matches_jax_vjp(size, centered, norm):
    y, sens, mask, eta, g = _data(*size, seed=3)
    # a 2D mask too: the full chain does not need columns
    mask = mask * (np.random.default_rng(4).random(mask.shape) < 0.7).astype(np.float32)
    _, vjp = jax.vjp(lambda e: jdc.log_likelihood_gradient(e, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask),
                                                           0.5, centered, norm), jnp.asarray(eta))
    (want,) = vjp(jnp.asarray(g))
    ty, ts, tm = _t(y, sens, mask)
    te = torch.from_numpy(eta).requires_grad_(True)
    kernels.full_dc(te, ty, ts, tm, 0.5, centered, norm).backward(torch.from_numpy(g))
    _close(te.grad, want)
    _close(k2.full_dc_bwd(torch.from_numpy(g), ts, tm, 0.5, centered, norm), want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_k2_backward_passes_gradcheck_in_float64(size, centered, norm):
    y, sens, mask, eta, _ = _data(*size, seed=5)
    ty, ts, tm = _t(y, sens, mask, dtype=torch.float64)
    te = torch.from_numpy(eta).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda e: kernels.full_dc(e, ty, ts, tm, 0.7, centered, norm), (te,))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_k2_backward_stages_compose_to_the_backward_chain(size, centered, norm):
    """The index arithmetic of the two backward kernels, in their plain stage
    versions: expand(g[..., 2:]) -> FFT -> mask -> IFFT -> reduce_acc is the
    backward chain, with no fftshift anywhere."""
    _, sens, mask, _, g = _data(*size, seed=6)
    ts, tm, tg = _t(sens, mask, g)
    n = norm.replace("none", "backward")
    k = torch.fft.fft2(k2.expand_plain(tg[..., 2:], ts, centered), norm=n)
    p = torch.fft.ifft2(k2.apply_mask_plain(k, tm, centered), norm=n)
    got = k2.reduce_acc_plain(p, ts, tg, centered, 0.5)
    _close(got, k2.full_dc_bwd_plain(tg, ts, tm, 0.5, centered, norm).numpy(), 1e-5, 1e-6)
    # the stage wrappers take these plain versions for CPU tensors
    assert torch.equal(k2.apply_mask(k, tm, centered), k2.apply_mask_plain(k, tm, centered))
    assert torch.equal(k2.reduce_acc(p, ts, tg, centered, 0.5), got)


# ---- K3: the IndRNN cell ----


def _cell_pair(cin, f, seed):
    x = np.random.default_rng(seed).standard_normal((B, 7, 9, cin)).astype(np.float32)
    hid = np.abs(np.random.default_rng(seed + 1).standard_normal((B, 7, 9, f))).astype(np.float32)
    jmod = jcells.make_cell("IndRNN", f, 1, 1, True)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(hid))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 10.0, params)  # well away from relu's kink
    tmod = tcells.make_cell("IndRNN", cin, f, 1, 1, True)
    with torch.no_grad():
        tmod.ih.weight.copy_(torch.from_numpy(hwio_to_oihw(np.array(params["Conv_0"]["kernel"]))))
        tmod.ih.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
        tmod.hh.copy_(torch.from_numpy(np.transpose(np.array(params["hh"]), (0, 3, 1, 2))))
    return x, hid, jmod, params, tmod


@pytest.mark.parametrize("cin,f", [(4, 8), (16, 8), (64, 64), (64, 128), (128, 128)])
def test_k3_backward_matches_jax_vjp(cin, f):
    x, hid, jmod, params, tmod = _cell_pair(cin, f, seed=cin + f)
    out, vjp = jax.vjp(lambda p, a, h: jmod.apply({"params": p}, a, h), params, jnp.asarray(x), jnp.asarray(hid))
    g = np.random.default_rng(7).standard_normal(np.shape(out)).astype(np.float32)
    want_p, want_x, want_h = vjp(jnp.asarray(g))
    assert float((np.asarray(out) == 0).mean()) > 0.1, "the relu mask must cut some pixels"

    to_port = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_(True)  # noqa: E731
    tx, th = to_port(x), to_port(hid)
    tmod(tx, th).backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    _close(nhwc(tx.grad), want_x)
    _close(nhwc(th.grad), want_h)
    _close(tmod.ih.weight.grad, hwio_to_oihw(np.asarray(want_p["Conv_0"]["kernel"])))
    _close(tmod.ih.bias.grad, want_p["Conv_0"]["bias"])
    _close(tmod.hh.grad, np.transpose(np.asarray(want_p["hh"]), (0, 3, 1, 2)))


def test_k3_backward_passes_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 5, 4, generator=gen, dtype=torch.float64).to(memory_format=torch.channels_last)
    h = torch.rand(2, 8, 5, 4, generator=gen, dtype=torch.float64).to(memory_format=torch.channels_last)
    w, b, u = (torch.randn(*s, generator=gen, dtype=torch.float64) for s in ((8, 6, 1, 1), (8,), (1, 8, 1, 1)))
    # the relu kink lies well outside the finite-difference step
    assert float((F.conv2d(x, w, b) + u * h).abs().min()) > 1e-4
    args = [a.requires_grad_(True) for a in (x, h, w, b, u)]
    assert torch.autograd.gradcheck(kernels.indrnn, args)


def test_k3_backward_sums_in_float32_for_bf16_operands():
    """bf16 activations and weights: dx/dh in bf16, dW/db/du summed in float32
    and carried back to the float32 parameters by the casts of kernel_args
    (through the bf16 weight, as JAX's convert does: one bf16 rounding)."""
    x, hid, _, _, tmod = _cell_pair(16, 8, seed=9)
    tmod.ih.compute_dtype = torch.bfloat16
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = tmod(tx, torch.from_numpy(hid).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert tx.grad.dtype == torch.float32
    for p in (tmod.ih.weight, tmod.ih.bias, tmod.hh):
        assert p.grad is not None and p.grad.dtype == torch.float32 and float(p.grad.abs().max()) > 0
    xs, hs, ws, bs, us = tmod.kernel_args(tx.detach(), torch.from_numpy(hid).permute(0, 3, 1, 2))
    o = k3.indrnn_plain(xs, hs, ws, bs, us)
    _, _, dw, db, du = k3.indrnn_bwd_plain(torch.ones_like(o), xs, hs, o, ws, us)
    assert dw.dtype == db.dtype == du.dtype == torch.float32
    _close(tmod.ih.weight.grad.reshape(dw.shape), dw.to(torch.bfloat16).float().numpy(), 0, 0)


# ---- replicate_pad ----


@pytest.mark.parametrize("pad", [1, 2, 4])
@pytest.mark.parametrize("channels_last", [False, True])
def test_replicate_pad_gradient_equals_f_pad(pad, channels_last):
    x = torch.randn(2, 3, 7, 5, generator=torch.Generator().manual_seed(pad), dtype=torch.float64)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(2, 3, 7 + 2 * pad, 5 + 2 * pad, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = replicate_pad(a, pad)
    assert torch.equal(out, F.pad(x, (pad,) * 4, mode="replicate"))
    out.backward(g)
    F.pad(b, (pad,) * 4, mode="replicate").backward(g)
    assert torch.allclose(a.grad, b.grad, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda t: replicate_pad(t, pad), (x.clone().requires_grad_(True),))


# ---- gradients the wrappers refuse ----


def test_wrappers_refuse_gradients_they_do_not_compute():
    """The gradients with respect to the operator, y and the mask raise; the
    maps' gradient is computed (held against jax.vjp in
    ``test_torch_port_sens.py``)."""
    y, sens, mask, eta, _ = _data(16, 12, seed=8)
    ts, mats, z0 = _psf1d_operands(y, sens, mask, True, "ortho")
    ty, tm = _t(y, mask)
    te = torch.from_numpy(eta).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="mats"):
        kernels.psf1d_dc(te, ts, mats.clone().requires_grad_(True), z0).sum().backward()
    for name, args in (("y", (ty.clone().requires_grad_(True), ts, tm)),
                       ("mask", (ty, ts, tm.clone().requires_grad_(True)))):
        with pytest.raises(NotImplementedError, match=name):
            kernels.full_dc(te, *args).sum().backward()
    for fn in (lambda s: kernels.psf1d_dc(te, s, mats, z0), lambda s: kernels.full_dc(te, ty, s, tm)):
        s = ts.clone().requires_grad_(True)
        fn(s).sum().backward()
        assert s.grad is not None and float(s.grad.abs().max()) > 0
