"""K2's expand, load and mask stages: the operands their wrappers take (maps
and k-space views off 16 bytes, g's channels 2:4, the CG's mask), the CPU
dispatch of their wrappers, the mask stage's shifted index against numpy's
ifftshift, and the plain versions composed with the FFT against
``mridc_tpu.nn.dc`` and the CG's normal operator at the shapes chip_smoke.py's
phase 3 holds the kernels to on the card: W = 2 (mod 4) centered (an odd
column shift), an odd H with 7 coils (a last coil group of one), and an odd
W.

Parity: rtol 2e-3 / atol 2e-4 of the largest magnitude (the port's limit
against the JAX package), float32, numpy-seeded inputs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.ops.cplx import cmul as jcmul
from mridc_tpu.ops.cplx import cmul_conj as jcmul_conj
from mridc_tpu.ops.fft import fft2_rv as jfft2_rv
from mridc_tpu.ops.fft import ifft2_rv as jifft2_rv
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.kernels.common import check_operand
from mridc_tpu_torch.models.recon import resnet as tresnet

jdc = importlib.import_module("mridc_tpu.nn.dc")

RTOL, ATOL = 2e-3, 2e-4


def _off_by_one_pixel(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` starting 8 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype)
    start = 2 if buf.data_ptr() % 16 == 0 else 0  # the CPU allocator aligns to 64 bytes
    view = buf[start:start + x.numel()].view(x.shape).copy_(x)
    assert view.data_ptr() % 16 == 8
    return view


def test_maps_and_kspace_are_taken_off_16_bytes():
    """The kernels read and write the coil tensors 8 bytes a pixel, so expand's
    maps and load's k-space are taken 8-byte aligned; the other operands
    stay held to 16."""
    off = _off_by_one_pixel(torch.zeros(2, 3, 4, 6, 2))
    check_operand("sens", off, (2, 3, 4, 6, 2), (torch.float32,), align=8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_operand("sens", off, (2, 3, 4, 6, 2), (torch.float32,))
    with pytest.raises(ValueError, match="8-byte aligned"):
        check_operand("sens", torch.zeros(2 * 3 * 4 * 6 * 2 + 1)[1:].view(2, 3, 4, 6, 2), (2, 3, 4, 6, 2),
                      (torch.float32,), align=8)


def test_eta_stride_of_g_channels():
    """The backward's g [B, H, W, 4]: expand reads channels 2:4 in place (eta
    stride 2, a pointer 8 bytes past 16)."""
    b, h, w = 2, 320, 320
    eta = torch.zeros(b, h, w, 4)[..., 2:]
    assert k2._eta_stride(eta, b, h, w) == 2 and eta.data_ptr() % 16 == 8
    assert k2._eta_stride(torch.zeros(b, h, w, 2), b, h, w) == 1
    with pytest.raises(ValueError, match="channels 2:4"):
        k2._eta_stride(torch.zeros(b, h, w, 6)[..., 2:4], b, h, w)


def _data(b, c, h, w, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, c, h, w, 2)).astype(np.float32)
    sens = rng.standard_normal((b, c, h, w, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    eta = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    g = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    mask = (rng.random((b, 1, h, w)) < 0.4).astype(np.float32)
    return y, sens, eta, g, mask


SHAPES = [(2, 3, 34, 38), (2, 7, 33, 40), (2, 3, 37, 45)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("centered", [True, False])
def test_cpu_wrappers_take_the_plain_versions(shape, centered):
    y, sens, eta, g, mask = (torch.from_numpy(a) for a in _data(*shape, seed=11))
    for e, s in ((eta, sens), (g[..., 2:], sens), (_off_by_one_pixel(eta), sens), (eta, _off_by_one_pixel(sens))):
        assert torch.equal(k2.expand(e, s, centered), k2.expand_plain(e, s, centered))
    for fftshift in (False, True):
        for yy, m in ((y, mask), (y, None), (_off_by_one_pixel(y), mask)):
            assert torch.equal(k2.load(yy, m, centered, fftshift), k2.load_plain(yy, m, centered, fftshift))
    k = torch.view_as_complex(y.contiguous())
    for m in (mask, mask[:, :, :1]):
        assert torch.equal(k2.apply_mask(k.clone(), m, centered), k2.apply_mask_plain(k, m, centered))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("norm", ["ortho", "backward"])
def test_expand_then_fft_then_fftshift_load_is_sens_expand(shape, norm):
    """Centered SENSE expansion as the card runs it: expand (the input
    ifftshift in its read index), the FFT, then load with the fftshift (the
    output back to centered order), against ``mridc_tpu.nn.dc.sens_expand``;
    eta and channels 2:4 of a g."""
    y, sens, eta, g, mask = _data(*shape, seed=12)
    ts = torch.from_numpy(sens)
    for img, t_img in ((eta, torch.from_numpy(eta)), (g[..., 2:], torch.from_numpy(g)[..., 2:])):
        k = torch.fft.fft2(k2.expand_plain(t_img, ts, True), norm=norm)
        got = torch.view_as_real(k2.load_plain(torch.view_as_real(k), None, True, fftshift=True))
        _close(got, jdc.sens_expand(jnp.asarray(np.ascontiguousarray(img)), jnp.asarray(sens), True, norm))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("norm", ["ortho", "backward"])
@pytest.mark.parametrize("masked", [True, False])
def test_load_then_ifft_then_reduce_is_sens_reduce(shape, norm, masked):
    """Centered SENSE reduction as the card runs it: load (mask and input
    ifftshift in its read index), the inverse FFT, reduce (the output
    fftshift in its read index), against ``mridc_tpu.nn.dc.sens_reduce``."""
    y, sens, _, _, mask = _data(*shape, seed=13)
    ty, ts, tm = (torch.from_numpy(a) for a in (y, sens, mask))
    p = torch.fft.ifft2(k2.load_plain(ty, tm if masked else None, True), norm=norm)
    got = k2.reduce_plain(p, ts, None, True)
    ky = y * mask[..., None] if masked else y
    _close(got, jdc.sens_reduce(jnp.asarray(ky), jnp.asarray(sens), True, norm))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("centered", [True, False])
def test_apply_mask_plain_reads_the_mask_ifftshifted(shape, centered):
    """The mask stage's index: on an FFT output, the centered mask is read
    ifftshifted over (H, W) (numpy's ``ifftshift``, odd H and W too) and the
    uncentered one as it is; each element one product, exactly."""
    y, _, _, _, mask = _data(*shape, seed=15)
    k = y[..., 0] + 1j * y[..., 1]
    m = np.fft.ifftshift(mask, axes=(-2, -1)) if centered else mask
    got = k2.apply_mask_plain(torch.from_numpy(k.astype(np.complex64)), torch.from_numpy(mask), centered)
    ones = k2.apply_mask_plain(torch.ones(k.shape, dtype=torch.complex64), torch.from_numpy(mask), centered)
    np.testing.assert_array_equal(ones.real.numpy(), np.broadcast_to(m, k.shape))
    np.testing.assert_array_equal(got.numpy(), (m * k).astype(np.complex64))


def _jax_ehe(x, sens, mask, centered, norm):
    """mridc_tpu/models/recon/resnet.py:67-71's ehe with mu = 0, as written there."""
    k = jfft2_rv(jcmul(x[:, None], sens), centered, norm, (-2, -1))
    img = jifft2_rv(k * mask[..., None], centered, norm, (-2, -1))
    return jcmul_conj(img, sens).sum(axis=1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("norm", ["ortho", "backward"])
@pytest.mark.parametrize("centered", [True, False])
def test_expand_fft_mask_ifft_reduce_is_the_cg_normal_operator(shape, norm, centered):
    """The CG's normal operator as the card runs it (mu = 0): expand, the FFT,
    the mask stage in FFT order, the inverse FFT, reduce, against the JAX
    package's ``ehe``."""
    _, sens, eta, _, mask = _data(*shape, seed=16)
    ts = torch.from_numpy(sens)
    k = torch.fft.fft2(k2.expand_plain(torch.from_numpy(eta), ts, centered), norm=norm)
    p = torch.fft.ifft2(k2.apply_mask_plain(k, torch.from_numpy(mask), centered), norm=norm)
    _close(k2.reduce_plain(p, ts, None, centered),
           _jax_ehe(jnp.asarray(eta), jnp.asarray(sens), jnp.asarray(mask), centered, norm))


def test_the_cg_densifies_its_mask_once_a_solve(monkeypatch):
    """ResNet's and ProximalGradient's CG hand ``normal_op`` one dense float32
    [B, 1, H, W] mask at every iteration, made once a solve from a [B, 1, 1,
    W] row, and the mask stage takes it as its operand without a copy."""
    b, c, h, w = 2, 3, 33, 40
    _, sens, eta, _, mask = _data(b, c, h, w, seed=17)
    seen = []

    def spy(x, s, m, *args):
        seen.append(m)
        return k2.normal_op(x, s, m, *args)

    monkeypatch.setattr(tresnet, "normal_op", spy)
    tresnet.conjugate_gradient(torch.from_numpy(eta), torch.from_numpy(sens), torch.from_numpy(mask[:, :, :1]),
                               0.1, 3)
    assert len(seen) == 3 and all(m is seen[0] for m in seen)
    m = seen[0]
    assert tuple(m.shape) == (b, 1, h, w) and m.dtype == torch.float32 and m.is_contiguous()
    assert k2._mask_operand("mask", m, b, h, w).data_ptr() == m.data_ptr()
