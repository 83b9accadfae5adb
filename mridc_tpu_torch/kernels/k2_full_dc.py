"""K2: the full-mask likelihood gradient and the SENSE reduction as kernel
stages around cuFFT (``csrc/full_dc.cu``), forward and backward, and their
plain versions.

Stands for ``mridc_tpu/nn/dc.py:81-101`` ``log_likelihood_gradient`` and
``:59-71`` ``sens_reduce`` (the SENSE init and the psf1d data term z0). The
centering shifts are folded into the stages' indices, so no ``fftshift`` copy
or ``torch.roll`` runs; the transforms are ``torch.fft`` on complex64:

    full_dc     = reduce(ifft2(residual(fft2(expand(eta, s)), y, m)), s, eta)
    sens_reduce = reduce(ifft2(load(y, m)), s)

With ``sh = n // 2`` on a centered axis (0 otherwise), the ifftshift of a
transform's input reads index ``(i + sh) % n`` and the fftshift of its output
reads ``(i + n - sh) % n``. Between the forward and the inverse transform the
two shifts cancel for any n, so ``residual`` works in place on the FFT output.

The eta -> grad map is ``S^H F^-1 M F S / sigma^2``, Hermitian in every mode,
so the backward of :func:`full_dc` for an upstream g [B, H, W, 4] is the same
chain with y = 0 on ``g[..., 2:]``, its reduce adding ``g[..., :2]``:

    d_eta = reduce_acc(ifft2(apply_mask(fft2(expand(g[..., 2:], s)))), s, g)

Each stage has a wrapper (plain version for CPU tensors, kernel for CUDA
tensors) and a plain version written with the same index arithmetic as its
kernel; :func:`full_dc` and :func:`sens_reduce` take the JAX-identical
``nn/dc.py`` functions on the CPU and the stages on the card. :func:`full_dc`
is differentiable in ``eta`` on both; the gradients with respect to y, the
maps and the mask are not ported, nor is :func:`sens_reduce`'s backward on the
card (it raises; the soft-DC tail trains on the CPU only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.kernels.binding import launch
from mridc_tpu_torch.kernels.common import check_operand, dense, device_of, refuse_grads
from mridc_tpu_torch.nn import dc
from mridc_tpu_torch.ops.cplx import cmul, cmul_conj
from mridc_tpu_torch.ops.fft import _norm

__all__ = [
    "full_dc", "full_dc_plain", "full_dc_bwd", "full_dc_bwd_plain", "sens_reduce", "sens_reduce_plain",
    "expand", "residual", "load", "reduce", "apply_mask", "reduce_acc",
    "expand_plain", "residual_plain", "load_plain", "reduce_plain", "apply_mask_plain", "reduce_acc_plain",
]

_F32 = (torch.float32,)
_C64 = (torch.complex64,)


def _shifts(h: int, w: int, centered: bool):
    return (h // 2, w // 2) if centered else (0, 0)


def _gather(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """x[..., (i + sh) % H, (j + sw) % W] over the last two axes."""
    h, w = x.shape[-2], x.shape[-1]
    ih = (torch.arange(h, device=x.device) + sh) % h
    iw = (torch.arange(w, device=x.device) + sw) % w
    return x[..., ih, :][..., iw]


# ---- plain versions of the stages (same index arithmetic as the kernels) ----


def expand_plain(eta, sens, centered: bool) -> torch.Tensor:
    """[B, H, W, 2], [B, C, H, W, 2] -> complex64 [B, C, H, W]: ifftshift(s * eta)."""
    sh, sw = _shifts(eta.shape[1], eta.shape[2], centered)
    return _gather(torch.view_as_complex(cmul(eta.unsqueeze(1), sens).contiguous()), sh, sw)


def residual_plain(k, y, mask, centered: bool) -> torch.Tensor:
    """complex [B, C, H, W] FFT output -> m * (k - y) with m, y read at the shifted index."""
    b, _, h, w = k.shape
    sh, sw = _shifts(h, w, centered)
    m = _gather(torch.broadcast_to(mask, (b, 1, h, w)), sh, sw)
    return m * (k - _gather(torch.view_as_complex(y.contiguous()), sh, sw))


def apply_mask_plain(k, mask, centered: bool) -> torch.Tensor:
    """complex [B, C, H, W] FFT output -> m * k with m read at the shifted index."""
    b, _, h, w = k.shape
    sh, sw = _shifts(h, w, centered)
    return _gather(torch.broadcast_to(mask, (b, 1, h, w)), sh, sw) * k


def load_plain(y, mask: Optional[torch.Tensor], centered: bool) -> torch.Tensor:
    """[B, C, H, W, 2] -> complex [B, C, H, W]: ifftshift(m * y) (m optional)."""
    b, _, h, w, _ = y.shape
    sh, sw = _shifts(h, w, centered)
    q = _gather(torch.view_as_complex(y.contiguous()), sh, sw)
    return q if mask is None else _gather(torch.broadcast_to(mask, (b, 1, h, w)), sh, sw) * q


def reduce_plain(p, sens, eta: Optional[torch.Tensor], centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """complex [B, C, H, W] inverse-FFT output -> sum_c conj(s_c) fftshift(p_c) / sigma^2,
    as [eta, grad] [B, H, W, 4] or grad [B, H, W, 2]."""
    h, w = p.shape[-2], p.shape[-1]
    sh, sw = _shifts(h, w, centered)
    r = torch.view_as_real(_gather(p, (h - sh) % h, (w - sw) % w))
    grad = cmul_conj(r, sens).sum(dim=1) * (1.0 / sigma**2)
    return grad if eta is None else torch.cat([eta, grad], dim=-1)


def reduce_acc_plain(p, sens, g, centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """``g[..., :2]`` plus the reduce of ``p``: [B, H, W, 2]."""
    return g[..., :2] + reduce_plain(p, sens, None, centered, sigma)


def full_dc_plain(eta, y, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward",
                  spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the whole chain (the CPU path)."""
    return dc.log_likelihood_gradient(
        eta, y, sens, mask, sigma, fft_centered, fft_normalization, spatial_dims, coil_dim
    )


def full_dc_bwd_plain(g, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward") -> torch.Tensor:
    """Plain version of the backward chain: ``g`` [B, H, W, 4] ->
    ``g[..., :2] + S^H F^-1 M F S g[..., 2:] / sigma^2`` [B, H, W, 2]."""
    coil = dc.sens_expand(g[..., 2:], sens, fft_centered, fft_normalization)
    back = dc.sens_reduce(dc.expand_rv_mask(mask) * coil, sens, fft_centered, fft_normalization)
    return g[..., :2] + back / sigma**2


def sens_reduce_plain(kspace, sens, mask=None, fft_centered=False, fft_normalization="backward",
                      spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1) -> torch.Tensor:
    """Plain PyTorch version: ``sens_reduce(mask * kspace)`` (mask optional)."""
    if mask is not None:
        kspace = dc.expand_rv_mask(mask) * kspace
    return dc.sens_reduce(kspace, sens, fft_centered, fft_normalization, spatial_dims, coil_dim)


# ---- stage wrappers: plain version on the CPU, kernel on the card ----


def _coil_dims(name, sens):
    if sens.ndim != 5 or sens.shape[-1] != 2:
        raise ValueError(f"{name}: sens must be [B, C, H, W, 2], got {tuple(sens.shape)}")
    return sens.shape[:4]


def _mask_operand(name, mask, b, h, w) -> torch.Tensor:
    m = torch.broadcast_to(mask, (b, 1, h, w)).to(torch.float32).contiguous()
    check_operand(name, m, (b, 1, h, w), _F32)
    return m


def _eta_stride(eta, b, h, w) -> int:
    """float2s from one pixel of ``eta`` to the next: 1 for a contiguous
    [B, H, W, 2], 2 for channels 2:4 of a contiguous [B, H, W, 4]."""
    if tuple(eta.shape) != (b, h, w, 2) or eta.dtype != torch.float32:
        raise ValueError(f"full_dc.expand.eta: expected float32 {(b, h, w, 2)}, got {eta.dtype} {tuple(eta.shape)}")
    for es in (1, 2):
        if eta.stride() == (h * w * 2 * es, w * 2 * es, 2 * es, 1) and eta.data_ptr() % 8 == 0:
            return es
    raise ValueError("full_dc.expand.eta: the kernel needs a contiguous [B, H, W, 2] or channels 2:4 of a "
                     "contiguous [B, H, W, 4]")


def expand(eta, sens, centered: bool) -> torch.Tensor:
    """Stage (a): complex64 [B, C, H, W] = ifftshift(s * eta); ``eta`` may be
    channels 2:4 of a contiguous [B, H, W, 4] (the backward's g)."""
    dev = device_of("full_dc.expand", eta, sens)
    if dev.type == "cpu":
        return expand_plain(eta, sens, centered)
    b, c, h, w = _coil_dims("full_dc.expand", sens)
    check_operand("full_dc.expand.sens", sens, (b, c, h, w, 2), _F32)
    es = _eta_stride(eta, b, h, w)
    x = torch.empty((b, c, h, w), dtype=torch.complex64, device=dev)
    launch("full_dc", "k2_expand", dev, eta.data_ptr(), sens.data_ptr(), x.data_ptr(), b, c, h, w,
           *_shifts(h, w, centered), es)
    return x


def residual(k, y, mask, centered: bool) -> torch.Tensor:
    """Stage (b): m * (k - y) on the forward FFT's output; on the card it
    overwrites ``k`` and returns it."""
    dev = device_of("full_dc.residual", k, y, mask)
    if dev.type == "cpu":
        return residual_plain(k, y, mask, centered)
    b, c, h, w = k.shape
    check_operand("full_dc.residual.k", k, (b, c, h, w), _C64)
    check_operand("full_dc.residual.y", y, (b, c, h, w, 2), _F32)
    m = _mask_operand("full_dc.residual.mask", mask, b, h, w)
    launch("full_dc", "k2_residual", dev, k.data_ptr(), y.data_ptr(), m.data_ptr(), b, c, h, w,
           *_shifts(h, w, centered))
    return k


def apply_mask(k, mask, centered: bool) -> torch.Tensor:
    """Backward stage (mask): m * k on the forward FFT's output; on the card
    it overwrites ``k`` and returns it."""
    dev = device_of("full_dc.mask", k, mask)
    if dev.type == "cpu":
        return apply_mask_plain(k, mask, centered)
    b, c, h, w = k.shape
    check_operand("full_dc.mask.k", k, (b, c, h, w), _C64)
    m = _mask_operand("full_dc.mask.mask", mask, b, h, w)
    launch("full_dc", "k2_mask", dev, k.data_ptr(), m.data_ptr(), b, c, h, w, *_shifts(h, w, centered))
    return k


def load(y, mask: Optional[torch.Tensor], centered: bool) -> torch.Tensor:
    """Stage (load): complex64 [B, C, H, W] = ifftshift(m * y), m optional."""
    dev = device_of("full_dc.load", y, mask)
    if dev.type == "cpu":
        return load_plain(y, mask, centered)
    b, c, h, w = _coil_dims("full_dc.load", y)
    check_operand("full_dc.load.y", y, (b, c, h, w, 2), _F32)
    m = None if mask is None else _mask_operand("full_dc.load.mask", mask, b, h, w)
    q = torch.empty((b, c, h, w), dtype=torch.complex64, device=dev)
    launch("full_dc", "k2_load", dev, y.data_ptr(), None if m is None else m.data_ptr(), q.data_ptr(),
           b, c, h, w, *_shifts(h, w, centered))
    return q


def reduce(p, sens, eta: Optional[torch.Tensor], centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """Stage (c): sum_c conj(s_c) fftshift(p_c) / sigma^2, as [eta, grad] or grad."""
    dev = device_of("full_dc.reduce", p, sens, eta)
    if dev.type == "cpu":
        return reduce_plain(p, sens, eta, centered, sigma)
    b, c, h, w = _coil_dims("full_dc.reduce", sens)
    check_operand("full_dc.reduce.p", p, (b, c, h, w), _C64)
    check_operand("full_dc.reduce.sens", sens, (b, c, h, w, 2), _F32)
    if eta is not None:
        check_operand("full_dc.reduce.eta", eta, (b, h, w, 2), _F32)
    out = torch.empty((b, h, w, 2 if eta is None else 4), dtype=torch.float32, device=dev)
    launch("full_dc", "k2_reduce", dev, p.data_ptr(), sens.data_ptr(), None if eta is None else eta.data_ptr(),
           out.data_ptr(), b, c, h, w, *_shifts(h, w, centered), 1.0 / sigma**2)
    return out


def reduce_acc(p, sens, g, centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """Backward stage (reduce_acc): ``g[..., :2] + sum_c conj(s_c)
    fftshift(p_c) / sigma^2``, [B, H, W, 2] float32, from ``g`` [B, H, W, 4]."""
    dev = device_of("full_dc.reduce_acc", p, sens, g)
    if dev.type == "cpu":
        return reduce_acc_plain(p, sens, g, centered, sigma)
    b, c, h, w = _coil_dims("full_dc.reduce_acc", sens)
    check_operand("full_dc.reduce_acc.p", p, (b, c, h, w), _C64)
    check_operand("full_dc.reduce_acc.sens", sens, (b, c, h, w, 2), _F32)
    check_operand("full_dc.reduce_acc.g", g, (b, h, w, 4), _F32)
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    launch("full_dc", "k2_reduce_acc", dev, p.data_ptr(), sens.data_ptr(), g.data_ptr(), out.data_ptr(),
           b, c, h, w, *_shifts(h, w, centered), 1.0 / sigma**2)
    return out


def _check_layout(name, spatial_dims, coil_dim):
    if tuple(spatial_dims) not in ((-2, -1), (2, 3)) or coil_dim != 1:
        raise ValueError(f"{name}: the kernels take [B, C, H, W, 2] with coils on axis 1")


def full_dc_bwd(g, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward") -> torch.Tensor:
    """The backward chain: ``g`` [B, H, W, 4] -> d_eta [B, H, W, 2] (plain
    version for CPU tensors, the stages around cuFFT on the card)."""
    dev = device_of("full_dc_bwd", g, sens, mask)
    if dev.type == "cpu":
        return full_dc_bwd_plain(g, sens, mask, sigma, fft_centered, fft_normalization)
    norm = _norm(fft_normalization)
    g = dense("full_dc_bwd", g)
    k = torch.fft.fft2(expand(g[..., 2:], sens, fft_centered), norm=norm)
    p = torch.fft.ifft2(apply_mask(k, mask, fft_centered), norm=norm)
    del k
    return reduce_acc(p, sens, g, fft_centered, sigma)


def _full_dc_kernels(eta, y, sens, mask, sigma, fft_centered, fft_normalization) -> torch.Tensor:
    norm = _norm(fft_normalization)
    k = torch.fft.fft2(expand(eta, sens, fft_centered), norm=norm)
    p = torch.fft.ifft2(residual(k, y, mask, fft_centered), norm=norm)
    del k
    return reduce(p, sens, eta, fft_centered, sigma)


class _FullDC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eta, y, sens, mask, sigma, fft_centered, fft_normalization, spatial_dims, coil_dim):
        ctx.save_for_backward(sens, mask)
        ctx.args = (sigma, fft_centered, fft_normalization)
        if eta.device.type == "cpu":
            return full_dc_plain(eta, y, sens, mask, sigma, fft_centered, fft_normalization, spatial_dims, coil_dim)
        return _full_dc_kernels(eta, y, sens, mask, sigma, fft_centered, fft_normalization)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("full_dc", ctx.needs_input_grad, {1: "y", 2: "sens", 3: "mask"})
        sens, mask = ctx.saved_tensors
        return full_dc_bwd(g, sens, mask, *ctx.args), None, None, None, None, None, None, None, None


def full_dc(eta, y, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward",
            spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1) -> torch.Tensor:
    """``eta`` [B, H, W, 2], ``y``/``sens`` [B, C, H, W, 2], ``mask``
    broadcastable to [B, 1, H, W] -> ``[eta, grad]`` [B, H, W, 4], float32;
    differentiable in ``eta``."""
    dev = device_of("full_dc", eta, y, sens, mask)
    if dev.type != "cpu":
        _check_layout("full_dc", spatial_dims, coil_dim)
    return _FullDC.apply(eta, y, sens, mask, sigma, fft_centered, fft_normalization, tuple(spatial_dims), coil_dim)


class _SensReduce(torch.autograd.Function):
    """The card's SENSE reduction (load -> IFFT -> reduce); its backward is
    not ported (ROADMAP.md, K2: the sens_reduce backward)."""

    @staticmethod
    def forward(ctx, kspace, sens, mask, fft_centered, fft_normalization):
        p = torch.fft.ifft2(load(kspace, mask, fft_centered), norm=_norm(fft_normalization))
        return reduce(p, sens, None, fft_centered)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("sens_reduce (ROADMAP.md, K2: the sens_reduce backward)", ctx.needs_input_grad,
                     {0: "kspace", 1: "sens", 2: "mask"})
        return None, None, None, None, None


def sens_reduce(kspace, sens, mask: Optional[torch.Tensor] = None, fft_centered=False,
                fft_normalization="backward", spatial_dims: Sequence[int] = (-2, -1),
                coil_dim: int = 1) -> torch.Tensor:
    """SENSE-combined image of ``mask * kspace`` ([B, C, H, W, 2] -> [B, H, W, 2]);
    differentiable on the CPU only."""
    dev = device_of("sens_reduce", kspace, sens, mask)
    if dev.type == "cpu":
        return sens_reduce_plain(kspace, sens, mask, fft_centered, fft_normalization, spatial_dims, coil_dim)
    _check_layout("sens_reduce", spatial_dims, coil_dim)
    return _SensReduce.apply(kspace, sens, mask, fft_centered, fft_normalization)
