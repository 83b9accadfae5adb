"""Port parity: mridc_tpu_torch.ops (fft, cplx) against mridc_tpu.ops on the CPU.

Inputs come from numpy and go through both packages; the JAX side runs the
native complex FFT on the CPU, so the oracle is exact float32. Tolerance
rtol 1e-5 / atol 1e-6 of the output's largest magnitude (float32 FFTs with
different summation orders; unnormalized transforms grow with n);
``dft_mats`` is built the same way in both and must match bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu_torch.ops import cplx as tcplx
from mridc_tpu_torch.ops import fft as tfft

# the JAX package's ops/__init__ re-exports a function named `cplx`, which
# shadows the submodule attribute
jcplx = importlib.import_module("mridc_tpu.ops.cplx")
jfft = importlib.import_module("mridc_tpu.ops.fft")

RTOL, ATOL = 1e-5, 1e-6
NORMS = ["backward", "ortho", "forward", "none", None]


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
