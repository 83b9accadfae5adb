"""Classical compressed-sensing solvers (counterpart of
``mridc_tpu/nn/cs_solvers.py``): FISTA over the SENSE forward model with an
orthogonal multi-level Haar wavelet l1 prox (the approximation band kept) or
an anisotropic TV prox (a few Chambolle-style dual steps). Layout: real views
``[..., 2]``; y and the maps [B, C, H, W, 2], the image [B, H, W, 2].

Each iteration's data term is ``E^H(E z - y) = S^H F^-1 M (M F S z - y)``: the
mask is applied by E and again by E^H. It runs as one normal-operator chain,
``normal_op(z, S, M^2, 0) - x0`` with ``x0 = sens_reduce(y, mask=M)`` computed
once (:func:`~mridc_tpu_torch.kernels.k2_full_dc.normal_op`: K2's expand,
mask and reduce around cuFFT on the card, its plain version on the CPU). M^2,
not M, so that a soft mask gives the JAX result too; it is densified once a
solve. The Python loop stands for ``lax.fori_loop``; the momentum ``t`` is a
Python float, so no iteration waits on the card.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from mridc_tpu_torch.kernels.k2_full_dc import normal_op, sens_reduce

__all__ = ["haar_dwt2", "haar_idwt2", "fista_l1_wavelet", "fista_tv", "tv_prox", "wavelet_prox"]

_S2 = 1.4142135623730951


def _haar_step(x: torch.Tensor):
    """One 2D Haar level over [..., H, W] (H, W even): (ll, (lh, hl, hh))."""
    a = x[..., 0::2, :]
    b = x[..., 1::2, :]
    lo_r = (a + b) / _S2
    hi_r = (a - b) / _S2
    ll = (lo_r[..., :, 0::2] + lo_r[..., :, 1::2]) / _S2
    lh = (lo_r[..., :, 0::2] - lo_r[..., :, 1::2]) / _S2
    hl = (hi_r[..., :, 0::2] + hi_r[..., :, 1::2]) / _S2
    hh = (hi_r[..., :, 0::2] - hi_r[..., :, 1::2]) / _S2
    return ll, (lh, hl, hh)


def _haar_inv_step(ll: torch.Tensor, bands) -> torch.Tensor:
    lh, hl, hh = bands
    lo_r = torch.stack([(ll + lh) / _S2, (ll - lh) / _S2], dim=-1).reshape(ll.shape[:-1] + (2 * ll.shape[-1],))
    hi_r = torch.stack([(hl + hh) / _S2, (hl - hh) / _S2], dim=-1).reshape(hl.shape[:-1] + (2 * hl.shape[-1],))
    h = ll.shape[-2]
    out = torch.stack([(lo_r + hi_r) / _S2, (lo_r - hi_r) / _S2], dim=-2)
    return out.reshape(out.shape[:-3] + (2 * h, out.shape[-1]))


def haar_dwt2(x: torch.Tensor, levels: int = 3):
    """Multi-level orthogonal Haar DWT over the trailing two axes (sizes
    divisible by 2^levels): (ll, [bands of each level, coarse to fine])."""
    bands = []
    for _ in range(levels):
        x, b = _haar_step(x)
        bands.append(b)
    return x, bands[::-1]


def haar_idwt2(ll: torch.Tensor, bands) -> torch.Tensor:
    """The inverse of :func:`haar_dwt2`."""
    for b in bands:
        ll = _haar_inv_step(ll, b)
    return ll


def _soft(x: torch.Tensor, lam: float) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


def wavelet_prox(x: torch.Tensor, lam: float, levels: int = 3) -> torch.Tensor:
    """The l1 prox of the Haar detail bands of ``x`` [B, H, W, 2], each of
    (re, im) transformed alone; odd sizes are zero-padded at the end to a
    multiple of 2^levels and cropped back."""
    h, w = x.shape[-3], x.shape[-2]
    mult = 1 << levels
    xc = F.pad(x.permute(0, 3, 1, 2), (0, (-w) % mult, 0, (-h) % mult))  # [B, 2, Hp, Wp]
    ll, bands = haar_dwt2(xc, levels)
    rec = haar_idwt2(ll, [tuple(_soft(b, lam) for b in lvl) for lvl in bands])
    return rec[..., :h, :w].permute(0, 2, 3, 1)


def _grad_h(v):
    return torch.cat([v[..., 1:, :, :] - v[..., :-1, :, :], torch.zeros_like(v[..., :1, :, :])], -3)


def _grad_w(v):
    return torch.cat([v[..., :, 1:, :] - v[..., :, :-1, :], torch.zeros_like(v[..., :, :1, :])], -2)


def _div(ph, pw):
    dh = torch.cat([ph[..., :1, :, :], ph[..., 1:-1, :, :] - ph[..., :-2, :, :], -ph[..., -2:-1, :, :]], -3)
    dw = torch.cat([pw[..., :, :1, :], pw[..., :, 1:-1, :] - pw[..., :, :-2, :], -pw[..., :, -2:-1, :]], -2)
    return dh + dw


def tv_prox(x: torch.Tensor, lam: float, inner: int = 5) -> torch.Tensor:
    """The anisotropic TV prox of ``x`` [B, H, W, 2] by ``inner`` projected
    dual ascent steps (step 1/4, duals clipped to [-1, 1])."""
    ph = torch.zeros_like(x)
    pw = torch.zeros_like(x)
    for _ in range(inner):
        u = x - lam * _div(ph, pw)
        ph = torch.clamp(ph + 0.25 * _grad_h(u), -1.0, 1.0)
        pw = torch.clamp(pw + 0.25 * _grad_w(u), -1.0, 1.0)
    return x - lam * _div(ph, pw)


def _fista(prox, y, sens, mask, num_iters, fft_centered, fft_normalization, spatial_dims, coil_dim):
    if tuple(spatial_dims) not in ((-2, -1), (2, 3)) or coil_dim != 1:
        raise ValueError("the FISTA solvers take [B, C, H, W, 2] k-space and maps with coils on axis 1")
    b, _, h, w, _ = sens.shape
    y, sens = y.contiguous(), sens.contiguous()
    if mask.ndim == y.ndim:  # a real-view mask [..., 1]
        mask = mask[..., 0]
    mask = torch.broadcast_to(mask, (b, 1, h, w)).to(torch.float32)
    x0 = sens_reduce(y, sens, mask.contiguous(), fft_centered, fft_normalization)
    mask2 = (mask * mask).contiguous()  # E^H E applies the mask twice
    x, z, t = x0, x0, 1.0
    for _ in range(num_iters):
        grad = normal_op(z, sens, mask2, 0.0, fft_centered, fft_normalization) - x0
        x_new = prox(z - grad)
        t_new = (1 + math.sqrt(1 + 4 * t * t)) / 2
        z = x_new + ((t - 1) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def fista_l1_wavelet(
    y: torch.Tensor,
    sens: torch.Tensor,
    mask: torch.Tensor,
    reg_wt: float = 0.005,
    num_iters: int = 60,
    levels: int = 3,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
    spatial_dims: Sequence[int] = (-2, -1),
    coil_dim: int = 1,
) -> torch.Tensor:
    """L1-wavelet SENSE reconstruction by FISTA with step 1 (normalised maps,
    sum |S|^2 = 1, make E^H E a contraction): y and sens [B, C, H, W, 2],
    mask broadcastable to [B, 1, H, W]; returns [B, H, W, 2]."""
    return _fista(lambda v: wavelet_prox(v, reg_wt, levels), y, sens, mask, num_iters, fft_centered,
                  fft_normalization, spatial_dims, coil_dim)


def fista_tv(
    y: torch.Tensor,
    sens: torch.Tensor,
    mask: torch.Tensor,
    reg_wt: float = 0.005,
    num_iters: int = 60,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
    spatial_dims: Sequence[int] = (-2, -1),
    coil_dim: int = 1,
) -> torch.Tensor:
    """Anisotropic-TV SENSE reconstruction: FISTA with :func:`tv_prox`."""
    return _fista(lambda v: tv_prox(v, reg_wt), y, sens, mask, num_iters, fft_centered, fft_normalization,
                  spatial_dims, coil_dim)
