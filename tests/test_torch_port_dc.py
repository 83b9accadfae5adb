"""Port parity: mridc_tpu_torch.nn.dc against mridc_tpu.nn.dc on the CPU, and
the K1/K2/K3 wrappers' CPU dispatch.

Tolerance rtol 1e-5 / atol 1e-6 of the output's largest magnitude (float32,
different summation orders); masks and the PSF operator's layout are exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu_torch import kernels
from mridc_tpu_torch.nn import dc as tdc

jdc = importlib.import_module("mridc_tpu.nn.dc")

RTOL, ATOL = 1e-5, 1e-6
B, C = 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL * scale)


def _data(h, w, seed=0, column_mask=False):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, h, w, 2)).astype(np.float32)
    sens = rng.standard_normal((B, C, h, w, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    eta = rng.standard_normal((B, h, w, 2)).astype(np.float32)
    if column_mask:
        cols = (rng.random((B, 1, 1, w)) < 0.4).astype(np.float32)
        mask = np.broadcast_to(cols, (B, 1, h, w)).copy()
    else:
        mask = (rng.random((B, 1, h, w)) < 0.5).astype(np.float32)
    return y, sens, eta, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


SIZES = [(16, 12), (15, 17)]
FFT_MODES = [(False, "backward"), (True, "ortho"), (True, "forward"), (False, "ortho")]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_sens_expand_reduce_match_jax(size, centered, norm):
    y, sens, eta, _ = _data(*size)
    ty, ts, te = _t(y, sens, eta)
    _close(tdc.sens_expand(te, ts, centered, norm), jdc.sens_expand(jnp.asarray(eta), jnp.asarray(sens), centered, norm))
    for keep in (False, True):
        _close(
            tdc.sens_reduce(ty, ts, centered, norm, keepdims=keep),
            jdc.sens_reduce(jnp.asarray(y), jnp.asarray(sens), centered, norm, keepdims=keep),
        )


def test_soft_dc_and_mask_expand_match_jax():
    y, sens, _, mask = _data(16, 12, seed=1)
    pred = np.random.default_rng(2).standard_normal(y.shape).astype(np.float32)
    ty, tp, tm = _t(y, pred, mask)
    w = np.array([0.7], np.float32)
    _close(tdc.soft_dc(tp, ty, tm, torch.from_numpy(w)), jdc.soft_dc(pred, y, mask, w))
    np.testing.assert_array_equal(tdc.expand_rv_mask(tm).numpy(), jdc.expand_rv_mask(mask))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
@pytest.mark.parametrize("sigma", [1.0, 0.5])
def test_log_likelihood_gradient_matches_jax(size, centered, norm, sigma):
    y, sens, eta, mask = _data(*size, seed=3)
    want = jdc.log_likelihood_gradient(
        jnp.asarray(eta), jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), sigma, centered, norm
    )
    got = tdc.log_likelihood_gradient(*_t(eta, y, sens, mask), sigma, centered, norm)
    assert got.shape == (B, *size, 4)
    _close(got, want)


@pytest.mark.parametrize("w", [12, 17, 320])
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_psf1d_gauss_mats_match_jax(w, centered, norm):
    row = (np.random.default_rng(w).random((B, w)) < 0.4).astype(np.float32)
    want = np.asarray(jdc.psf1d_gauss_mats(jnp.asarray(row), centered, norm))
    got = tdc.psf1d_gauss_mats(torch.from_numpy(row), centered, norm)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (B, 3, w, w)
    _close(got, want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_psf1d_chain_matches_jax(size, centered, norm):
    y, sens, eta, mask = _data(*size, seed=4, column_mask=True)
    jm = jdc.psf1d_gauss_mats(jnp.asarray(mask[:, 0, 0, :]), centered, norm)
    jz0 = jdc.sens_reduce(jdc.expand_rv_mask(jnp.asarray(mask)) * jnp.asarray(y), jnp.asarray(sens), centered, norm)
    tm = tdc.psf1d_gauss_mats(torch.from_numpy(mask[:, 0, 0, :]), centered, norm)
    tz0 = tdc.sens_reduce(tdc.expand_rv_mask(torch.from_numpy(mask)) * torch.from_numpy(y), torch.from_numpy(sens),
                          centered, norm)
    _close(tz0, jz0)
    coil = np.random.default_rng(5).standard_normal((B, C, *size, 2)).astype(np.float32)
    _close(tdc.apply_psf1d(torch.from_numpy(coil), tm), jdc.apply_psf1d(jnp.asarray(coil), jm))
    want = jdc.log_likelihood_gradient_psf1d(jnp.asarray(eta), jnp.asarray(sens), jm, jz0, sigma=0.5)
    got = tdc.log_likelihood_gradient_psf1d(*_t(eta, sens), tm, tz0, sigma=0.5)
    _close(got, want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_psf1d_gradient_equals_full_gradient_on_column_mask(size, centered, norm):
    y, sens, eta, mask = _data(*size, seed=6, column_mask=True)
    ty, ts, te, tm = _t(y, sens, eta, mask)
    mats = tdc.psf1d_gauss_mats(tm[:, 0, 0, :], centered, norm)
    z0 = tdc.sens_reduce(tdc.expand_rv_mask(tm) * ty, ts, centered, norm)
    full = tdc.log_likelihood_gradient(te, ty, ts, tm, 1.0, centered, norm)
    psf = tdc.log_likelihood_gradient_psf1d(te, ts, mats, z0)
    _close(psf, full.numpy(), rtol=1e-4)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("centered,norm", FFT_MODES)
def test_k2_stages_compose_to_the_dc_functions(size, centered, norm):
    """The index arithmetic of the K2 kernels, in their plain stage versions:
    expand -> FFT -> residual -> IFFT -> reduce is log_likelihood_gradient and
    load -> IFFT -> reduce is sens_reduce, with no fftshift anywhere."""
    from mridc_tpu_torch.kernels import k2_full_dc as k2

    ty, ts, te, tm = _t(*_data(*size, seed=8))
    n = dict(norm=None if norm is None else norm.replace("none", "backward"))
    k = torch.fft.fft2(k2.expand_plain(te, ts, centered), **n)
    got = k2.reduce_plain(torch.fft.ifft2(k2.residual_plain(k, ty, tm, centered), **n), ts, te, centered, 0.5)
    _close(got, tdc.log_likelihood_gradient(te, ty, ts, tm, 0.5, centered, norm).numpy())
    for m in (None, tm):
        got = k2.reduce_plain(torch.fft.ifft2(k2.load_plain(ty, m, centered), **n), ts, None, centered)
        want = tdc.sens_reduce(ty if m is None else tdc.expand_rv_mask(m) * ty, ts, centered, norm)
        _close(got, want.numpy())
    # the stage wrappers take these plain versions for CPU tensors
    assert torch.equal(k2.expand(te, ts, centered), k2.expand_plain(te, ts, centered))
    assert torch.equal(k2.load(ty, tm, centered), k2.load_plain(ty, tm, centered))
    assert torch.equal(k2.residual(k, ty, tm, centered), k2.residual_plain(k, ty, tm, centered))


def test_check_rv_rejects_bad_views():
    from mridc_tpu_torch.utils.typecheck import ShapeError

    with pytest.raises(ShapeError):
        tdc.sens_expand(torch.zeros(2, 4, 4, 3), torch.zeros(2, 1, 4, 4, 2))
    with pytest.raises(ShapeError):
        tdc.sens_reduce(torch.zeros(2, 1, 4, 4, 2, dtype=torch.int32), torch.zeros(2, 1, 4, 4, 2))


# ---- the kernel wrappers: plain version for CPU tensors, never a fallback ----


def _wrapper_cases():
    y, sens, eta, mask = _t(*_data(16, 12, seed=7, column_mask=True))
    mats = tdc.psf1d_gauss_mats(mask[:, 0, 0, :], True, "ortho")
    z0 = tdc.sens_reduce(tdc.expand_rv_mask(mask) * y, sens, True, "ortho")
    x = torch.randn(B, 8, 16, 12, generator=torch.Generator().manual_seed(0)).to(memory_format=torch.channels_last)
    h = torch.rand(B, 8, 16, 12, generator=torch.Generator().manual_seed(1)).to(memory_format=torch.channels_last)
    wt, bias, hh = torch.randn(8, 8, 1, 1), torch.randn(8), torch.randn(1, 8, 1, 1)
    return [
        ("psf1d_dc", kernels.psf1d_dc, tdc.log_likelihood_gradient_psf1d, (eta, sens, mats, z0, 0.5)),
        (
            "full_dc",
            lambda *a: kernels.full_dc(*a, True, "ortho"),
            lambda *a: tdc.log_likelihood_gradient(*a, True, "ortho"),
            (eta, y, sens, mask, 0.5),
        ),
        (
            "sens_reduce",
            lambda k, s, m: kernels.sens_reduce(k, s, m, True, "ortho"),
            lambda k, s, m: tdc.sens_reduce(tdc.expand_rv_mask(m) * k, s, True, "ortho"),
            (y, sens, mask),
        ),
        (
            "indrnn",
            kernels.indrnn,
            lambda x, h, w, b, u: torch.relu(torch.nn.functional.conv2d(x, w, b) + u * h),
            (x, h, wt, bias, hh),
        ),
    ]


@pytest.mark.parametrize("case", range(4))
def test_wrappers_take_the_plain_version_on_cpu(case):
    name, wrapper, plain, args = _wrapper_cases()[case]
    before = kernels.launch_counts()
    got = wrapper(*args)
    assert torch.equal(got, plain(*args)), name
    assert kernels.launch_counts() == before, "a CPU call must not count as a kernel launch"


@pytest.mark.parametrize("case", range(4))
def test_wrappers_refuse_other_devices(case):
    name, wrapper, _, args = _wrapper_cases()[case]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="not supported"):
        wrapper(*meta)
