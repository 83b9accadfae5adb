"""Port parity: mridc_tpu_torch.ops (fft, cplx, complex, masking) against
mridc_tpu.ops on the CPU.

Inputs come from numpy and go through both packages; the JAX side runs the
native complex FFT on the CPU, so the oracle is exact float32. Tolerance
rtol 1e-5 / atol 1e-6 of the output's largest magnitude (float32 FFTs with
different summation orders; unnormalized transforms grow with n);
``dft_mats`` is built the same way in both and must match bit for bit.
``ops.complex`` within 1e-6 relative (float32 sums in another order);
``ops.masking`` (selection and a multiply by 0 or 1) bit for bit, on the cases
of ``tests/test_fft.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.data.subsample import create_masker as jcreate_masker
from mridc_tpu_torch.data.subsample import create_masker
from mridc_tpu_torch.ops import complex as tcomplex
from mridc_tpu_torch.ops import cplx as tcplx
from mridc_tpu_torch.ops import fft as tfft
from mridc_tpu_torch.ops import masking as tmasking

# the JAX package's ops/__init__ re-exports a function named `cplx`, which
# shadows the submodule attribute
jcplx = importlib.import_module("mridc_tpu.ops.cplx")
jfft = importlib.import_module("mridc_tpu.ops.fft")
jcomplex = importlib.import_module("mridc_tpu.ops.complex")
jmasking = importlib.import_module("mridc_tpu.ops.masking")

RTOL, ATOL = 1e-5, 1e-6
NORMS = ["backward", "ortho", "forward", "none", None]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rv(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("shape", [(2, 3, 16, 12), (1, 2, 15, 17)])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("norm", NORMS)
def test_fft2_ifft2_match_jax(shape, centered, norm):
    x = _cx(shape, 0)
    for jf, tf in ((jfft.fft2, tfft.fft2), (jfft.ifft2, tfft.ifft2)):
        want = jf(jnp.asarray(x), centered=centered, normalization=norm)
        got = tf(torch.from_numpy(x), centered=centered, normalization=norm)
        _close(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 3, 16, 12, 2), (1, 2, 15, 17, 2)])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_fft2_rv_ifft2_rv_match_jax(shape, centered, norm):
    x = _rv(shape, 1)
    for jf, tf in ((jfft.fft2_rv, tfft.fft2_rv), (jfft.ifft2_rv, tfft.ifft2_rv)):
        want = jf(jnp.asarray(x), centered, norm)
        got = tf(torch.from_numpy(x), centered, norm, use_matmul=True)  # use_matmul is a TPU knob: ignored
        assert got.shape == x.shape
        _close(got.numpy(), want)


def test_centered_aliases_and_shifts_match_jax():
    x = _cx((2, 15, 17), 2)
    _close(tfft.fft2c(torch.from_numpy(x)).numpy(), jfft.fft2c(jnp.asarray(x)))
    _close(tfft.ifft2c(torch.from_numpy(x)).numpy(), jfft.ifft2c(jnp.asarray(x)))
    for axes in [None, (-2, -1), (1,)]:
        np.testing.assert_array_equal(tfft.fftshift(torch.from_numpy(x), axes).numpy(), jfft.fftshift(x, axes))
        np.testing.assert_array_equal(tfft.ifftshift(torch.from_numpy(x), axes).numpy(), jfft.ifftshift(x, axes))


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="normalization"):
        tfft.fft2(torch.zeros(4, 4, dtype=torch.complex64), normalization="bogus")


@pytest.mark.parametrize("n", [12, 15, 320])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_dft_mats_bit_identical(n, inverse, centered, norm):
    got_r, got_i = tfft.dft_mats(n, inverse, centered, norm)
    want_r, want_i = jfft.dft_mats(n, inverse, centered, norm)
    assert got_r.dtype == np.float32 and got_i.dtype == np.float32
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("fn", ["cmul", "cmul_conj"])
def test_cplx_binary_match_jax(fn):
    a, b = _rv((2, 3, 5, 7, 2), 3), _rv((2, 3, 5, 7, 2), 4)
    _close(getattr(tcplx, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy(), getattr(jcplx, fn)(a, b))


@pytest.mark.parametrize("fn", ["cconj", "cabs", "cabs2", "crss", "re", "im"])
def test_cplx_unary_match_jax(fn):
    a = _rv((2, 3, 5, 7, 2), 5)
    _close(getattr(tcplx, fn)(torch.from_numpy(a)).numpy(), getattr(jcplx, fn)(a))


@pytest.mark.parametrize("method", ["SENSE", "RSS", "sense"])
def test_ccombine_and_csense_match_jax(method):
    x, s = _rv((2, 3, 5, 7, 2), 6), _rv((2, 3, 5, 7, 2), 7)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    _close(tcplx.ccombine(tx, ts, method).numpy(), jcplx.ccombine(x, s, method))
    _close(tcplx.csense(tx, ts).numpy(), jcplx.csense(x, s))
    _close(tcplx.cplx(tx[..., 0], tx[..., 1]).numpy(), jcplx.cplx(x[..., 0], x[..., 1]))
    with pytest.raises(ValueError):
        tcplx.ccombine(tx, ts, "bogus")


def test_rv_conversions_match_jax():
    z = _cx((3, 4), 8)
    np.testing.assert_array_equal(tcplx.to_rv(z), jcplx.to_rv(z))
    np.testing.assert_array_equal(tcplx.to_rv(z.real), jcplx.to_rv(z.real))
    rv = jcplx.to_rv(z)
    np.testing.assert_array_equal(tcplx.from_rv(rv), jcplx.from_rv(rv))
    np.testing.assert_array_equal(tcplx.from_rv(torch.from_numpy(rv)), jcplx.from_rv(rv))


# ---- ops.complex (native complex tensors) ----


def _rel(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def test_real_view_roundtrip_matches_jax():
    x = _cx((2, 3, 8, 8), 5)
    rv = tcomplex.to_real_view(torch.from_numpy(x))
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jcomplex.to_real_view(jnp.asarray(x))))
    np.testing.assert_array_equal(tcomplex.from_real_view(rv).numpy(), np.asarray(jcomplex.from_real_view(rv.numpy())))
    with pytest.raises(ValueError, match="trailing complex dim"):
        tcomplex.from_real_view(torch.zeros(2, 3))
    np.testing.assert_array_equal(tcomplex.to_numpy_complex(rv), jcomplex.to_numpy_complex(rv.numpy()))
    np.testing.assert_array_equal(tcomplex.to_numpy_complex(torch.from_numpy(x)), x)


@pytest.mark.parametrize("dim", [0, 1])
def test_rss_sense_and_coil_combination_match_jax(dim):
    x, s = _cx((2, 5, 12, 14), 11), _cx((2, 5, 12, 14), 12)
    tx, ts, jx, js = torch.from_numpy(x), torch.from_numpy(s), jnp.asarray(x), jnp.asarray(s)
    _rel(tcomplex.rss(tx, dim).numpy(), jcomplex.rss(jx, dim))
    _rel(tcomplex.rss(tx.real, dim).numpy(), jcomplex.rss(jx.real, dim))
    _rel(tcomplex.rss_complex(tx, dim).numpy(), jcomplex.rss_complex(jx, dim))
    _rel(tcomplex.sense(tx, ts, dim).numpy(), jcomplex.sense(jx, js, dim))
    _rel(tcomplex.complex_abs(tx).numpy(), jcomplex.complex_abs(jx))
    _rel(tcomplex.complex_abs_sq(tx).numpy(), jcomplex.complex_abs_sq(jx))
    for method in ("SENSE", "RSS", "sense"):
        _rel(tcomplex.coil_combination(tx, ts, method, dim).numpy(), jcomplex.coil_combination(jx, js, method, dim))
    with pytest.raises(ValueError, match="not supported"):
        tcomplex.coil_combination(tx, ts, "bogus")


# ---- ops.masking ----


def test_center_crop_and_crop_to_smallest_match_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 3, 17, 19)).astype(np.float32)
    y = rng.standard_normal((2, 3, 11, 25)).astype(np.float32)
    np.testing.assert_array_equal(tmasking.center_crop(torch.from_numpy(x), (8, 9)).numpy(),
                                  np.asarray(jmasking.center_crop(jnp.asarray(x), (8, 9))))
    for got, want in zip(tmasking.center_crop_to_smallest(torch.from_numpy(x), torch.from_numpy(y)),
                         jmasking.center_crop_to_smallest(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="Invalid crop"):
        tmasking.center_crop(torch.from_numpy(x), (18, 9))


@pytest.mark.parametrize("mask_type", ["1D", "2D"])
def test_mask_center_matches_jax(mask_type):
    x = _cx((2, 3, 10, 12), 17)
    for frm, to in ((3, 7), ([2], [5])):
        np.testing.assert_array_equal(tmasking.mask_center(torch.from_numpy(x), frm, to, mask_type).numpy(),
                                      np.asarray(jmasking.mask_center(jnp.asarray(x), frm, to, mask_type)))
    with pytest.raises(ValueError, match="mask_type"):
        tmasking.mask_center(torch.from_numpy(x), 1, 2, "3D")


@pytest.mark.parametrize("mask_type", ["1D", "2D"])
@pytest.mark.parametrize("bounds", [([1, 2, 3], [5, 6, 7]), ([2], [6])])
def test_batched_mask_center_matches_jax(mask_type, bounds):
    x = _cx((3, 2, 8, 8), 19)
    rv = _rv((3, 2, 8, 8, 2), 20)
    frm, to = (np.array(b) for b in bounds)
    for a in (x, rv):
        np.testing.assert_array_equal(tmasking.batched_mask_center(torch.from_numpy(a), frm, to, mask_type).numpy(),
                                      np.asarray(jmasking.batched_mask_center(jnp.asarray(a), frm, to, mask_type)))


APPLY_MASK_CASES = {
    "equispaced1d": dict(mask="equispaced1d", kw={}),
    "poisson2d_shift": dict(mask="poisson2d", kw={"shift": True}),
    "random1d_padding": dict(mask="random1d", kw={"padding": (3, 13)}),
    "gaussian2d_half_scan": dict(mask="gaussian2d", kw={"half_scan_percentage": 0.2, "center_scale": 0.05}),
    "existing_mask": dict(mask=None, kw={}),
}


@pytest.mark.parametrize("layout", ["complex", "real_view"])
@pytest.mark.parametrize("case", sorted(APPLY_MASK_CASES))
def test_apply_mask_matches_jax(case, layout):
    spec = APPLY_MASK_CASES[case]
    data = _cx((1, 3, 16, 18), 21) if layout == "complex" else _rv((1, 3, 16, 18, 2), 22)
    kw = dict(spec["kw"])
    if spec["mask"] is None:
        # the generator layout: a trailing singleton axis against real views
        shape = (1, 1, 16, 18) if layout == "complex" else (1, 1, 16, 18, 1)
        existing = (np.random.default_rng(23).random(shape) < 0.4).astype(np.float32)
        got = tmasking.apply_mask(torch.from_numpy(data), existing_mask=existing)
        want = jmasking.apply_mask(jnp.asarray(data), existing_mask=existing)
    else:
        got = tmasking.apply_mask(torch.from_numpy(data), create_masker(spec["mask"], [0.08], [4]), seed=(7,), **kw)
        want = jmasking.apply_mask(jnp.asarray(data), jcreate_masker(spec["mask"], [0.08], [4]), seed=(7,), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.float32 and float(got[2]) == float(want[2])
