"""Pieces shared by the references: 2D FFTs in either convention, SENSE
expansion and reduction, the RIM likelihood gradient, and the arithmetic
precision of the convolutions.

:class:`Precision` is where a reference's products are computed. ``float32``
(the reference) runs them in full float32 with TF32 off; ``tf32`` and
``fp8`` are the controls, the next precision below float32 and bfloat16:
TF32 products through the library's own flags, and fp8 as e4m3 operands
scaled per tensor by their largest magnitude (how fp8 products are fed),
accumulated in float32, in the forward and in both products of the backward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["fft2", "ifft2", "sense_reduce", "sense_expand", "likelihood_gradient", "Precision", "as_complex"]

MODES = ("float32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fft2(x: torch.Tensor, centered: bool, norm: str) -> torch.Tensor:
    """2D FFT of a complex [..., H, W] tensor; ``centered`` puts the shifts
    around it (image and k-space centre in the middle of the array)."""
    if centered:
        x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.fft2(x, norm=norm)
    return torch.fft.fftshift(x, dim=(-2, -1)) if centered else x


def ifft2(x: torch.Tensor, centered: bool, norm: str) -> torch.Tensor:
    if centered:
        x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.ifft2(x, norm=norm)
    return torch.fft.fftshift(x, dim=(-2, -1)) if centered else x


def sense_reduce(kspace: torch.Tensor, sens: torch.Tensor, centered: bool, norm: str) -> torch.Tensor:
    """Multicoil k-space [B, C, H, W] -> the SENSE image sum_c conj(s_c) IFFT(k_c), [B, H, W]."""
    return (ifft2(kspace, centered, norm) * sens.conj()).sum(1)


def sense_expand(image: torch.Tensor, sens: torch.Tensor, centered: bool, norm: str) -> torch.Tensor:
    """Image [B, H, W] -> multicoil k-space FFT(s_c x), [B, C, H, W]."""
    return fft2(image[:, None] * sens, centered, norm)


def likelihood_gradient(eta, y, sens, mask, centered: bool, norm: str) -> torch.Tensor:
    """The RIM data term A^H (M A eta - y) with A = FFT(s_c .): the forward
    model, the mask, the residual and the adjoint, each as written. ``mask``
    is [B, 1, H, W] (a 1D mask is its rows repeated)."""
    pred = fft2(eta[:, None] * sens, centered, norm)
    return sense_reduce(mask * (pred - y), sens, centered, norm)


def as_complex(rv) -> torch.Tensor:
    """A real view [..., 2] (numpy or tensor) -> a complex tensor."""
    t = torch.as_tensor(rv)
    return torch.view_as_complex(t.contiguous())


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale that maps its largest
    magnitude to the format's largest finite value, back in t's dtype."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Fp8Conv(torch.autograd.Function):
    """A convolution (or its transpose) whose three products take fp8
    operands: x and w forward, g with w and g with x backward."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed):
        qx, qw = _fp8(x), _fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding, dilation, transposed, b is not None)
        if transposed:
            return F.conv_transpose2d(qx, qw, b, stride, padding, 0, 1, dilation)
        return F.conv2d(qx, qw, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding, dilation, transposed, has_b = ctx.conf
        qg = _fp8(g)
        if transposed:  # the transpose of a conv: its input gradient is the conv's forward
            gx = F.conv2d(qg, qw, None, stride, padding, dilation)
            gw = torch.nn.grad.conv2d_weight(qg, qw.shape, qx, stride, padding, dilation)
        else:
            gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride, padding, dilation)
            gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride, padding, dilation)
        gb = g.sum((0, 2, 3)) if has_b else None
        return gx, gw, gb, None, None, None, None


class Precision:
    """The arithmetic of a reference's convolutions (see the module)."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for the ``tf32`` control, off otherwise; restored after."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def conv(self, x, w, b=None, padding=0, dilation=1):
        if self.mode == "fp8":
            return _Fp8Conv.apply(x, w, b, 1, padding, dilation, False)
        return F.conv2d(x, w, b, 1, padding, dilation)

    def conv_transpose(self, x, w, stride):
        if self.mode == "fp8":
            return _Fp8Conv.apply(x, w, None, stride, 0, 1, True)
        return F.conv_transpose2d(x, w, None, stride)
