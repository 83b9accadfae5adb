"""Data-consistency primitives in plain PyTorch (counterpart of
``mridc_tpu/nn/dc.py``).

These functions are the CPU path of the port and the oracle of its DC kernels
(``mridc_tpu_torch/kernels``): K1 stands for
:func:`log_likelihood_gradient_psf1d`, K2 for :func:`log_likelihood_gradient`
and :func:`sens_reduce`. Layout: real views ``[..., 2]``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mridc_tpu_torch.ops.cplx import cmul, cmul_conj
from mridc_tpu_torch.ops.fft import dft_mats, fft2_rv, ifft2_rv
from mridc_tpu_torch.utils.typecheck import check_rv

__all__ = [
    "sens_expand",
    "sens_reduce",
    "soft_dc",
    "log_likelihood_gradient",
    "expand_rv_mask",
    "psf1d_gauss_mats",
    "apply_psf1d",
    "log_likelihood_gradient_psf1d",
]


def expand_rv_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] (or broadcastable) float mask -> [..., 1] for rv tensors."""
    return mask[..., None]


def sens_expand(
    image: torch.Tensor,
    sens: torch.Tensor,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
    spatial_dims: Sequence[int] = (-2, -1),
) -> torch.Tensor:
    """Coil-combined image [B, H, W, 2] -> multicoil k-space [B, C, H, W, 2]."""
    check_rv(image, "sens_expand.image")
    check_rv(sens, "sens_expand.sens")
    if image.ndim == sens.ndim - 1:
        image = image[:, None]
    return fft2_rv(cmul(image, sens), fft_centered, fft_normalization, spatial_dims)


def sens_reduce(
    kspace: torch.Tensor,
    sens: torch.Tensor,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
    spatial_dims: Sequence[int] = (-2, -1),
    coil_dim: int = 1,
    keepdims: bool = False,
) -> torch.Tensor:
    """Multicoil k-space [B, C, H, W, 2] -> SENSE-combined image [B, H, W, 2]."""
    check_rv(kspace, "sens_reduce.kspace")
    img = ifft2_rv(kspace, fft_centered, fft_normalization, spatial_dims)
    return cmul_conj(img, sens).sum(dim=coil_dim, keepdim=keepdims)


def soft_dc(pred_kspace: torch.Tensor, ref_kspace: torch.Tensor, mask: torch.Tensor, weight) -> torch.Tensor:
    """Soft data-consistency ``where(mask, pred - ref, 0) * w`` on rv tensors."""
    if mask.ndim == pred_kspace.ndim - 1:
        mask = mask[..., None]
    zero = torch.zeros((), dtype=pred_kspace.dtype, device=pred_kspace.device)
    return torch.where(mask.bool(), pred_kspace - ref_kspace, zero) * weight


def log_likelihood_gradient(
    eta: torch.Tensor,
    masked_kspace: torch.Tensor,
    sens: torch.Tensor,
    mask: torch.Tensor,
    sigma: float = 1.0,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
    spatial_dims: Sequence[int] = (-2, -1),
    coil_dim: int = 1,
) -> torch.Tensor:
    """RIM likelihood gradient as [B, H, W, 4] channels
    ``[re(eta), im(eta), re(grad), im(grad)]``."""
    if mask.ndim == masked_kspace.ndim - 1:
        mask = mask[..., None]
    pred_k = fft2_rv(cmul(eta.unsqueeze(coil_dim), sens), fft_centered, fft_normalization, spatial_dims)
    resid = ifft2_rv(mask * (pred_k - masked_kspace), fft_centered, fft_normalization, spatial_dims)
    grad = cmul_conj(resid, sens).sum(dim=coil_dim) / (sigma**2)
    return torch.cat([eta, grad], dim=-1)


# ---------------------------------------------------------------------------
# PSF-1D data consistency for column (1D) undersampling: with a mask that
# varies along w only, IFFT2(mask * FFT2(x)) = I (x) C_w with the per-example
# [W, W] complex operator C_w = F_w^{-1} diag(m) F_w (shifts and normalization
# folded in). The data term A^H M y is constant across RIM steps (``z0``).
# ---------------------------------------------------------------------------


def psf1d_gauss_mats(
    mask_row: torch.Tensor,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
) -> torch.Tensor:
    """[B, W] 1D mask rows -> [B, 3, W, W] float32 Gauss-form matrices
    (Cr, Cr+Ci, Ci-Cr) of ``C = F_w^{-1} diag(m) F_w``.

    The products run in float64 and round once to float32, so no TF32 setting
    of the caller can touch them (the JAX package runs them at HIGHEST)."""
    w = mask_row.shape[-1]
    dev = mask_row.device
    fr, fi = (torch.from_numpy(a).to(dev, torch.float64) for a in dft_mats(w, False, fft_centered, fft_normalization))
    br, bi = (torch.from_numpy(a).to(dev, torch.float64) for a in dft_mats(w, True, fft_centered, fft_normalization))
    m = mask_row.to(torch.float32).to(torch.float64)
    dmr = m[:, :, None] * fr
    dmi = m[:, :, None] * fi
    cr = (torch.einsum("uk,bkv->buv", br, dmr) - torch.einsum("uk,bkv->buv", bi, dmi)).to(torch.float32)
    ci = (torch.einsum("uk,bkv->buv", br, dmi) + torch.einsum("uk,bkv->buv", bi, dmr)).to(torch.float32)
    return torch.stack([cr, cr + ci, ci - cr], dim=1)


def apply_psf1d(x: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Apply the PSF-1D operator along the last spatial axis: ``x`` [B, ..., W, 2],
    ``mats`` [B, 3, W, W]; out[..., u] = sum_v C[u, v] x[..., v] as the Gauss
    3-multiplication complex product."""
    xr, xi = x[..., 0], x[..., 1]
    c_r, c_sum, c_dif = mats[:, 0], mats[:, 1], mats[:, 2]
    k1 = torch.einsum("buv,b...v->b...u", c_r, xr + xi)
    k2 = torch.einsum("buv,b...v->b...u", c_sum, xi)
    k3 = torch.einsum("buv,b...v->b...u", c_dif, xr)
    return torch.stack([k1 - k2, k1 + k3], dim=-1)


def log_likelihood_gradient_psf1d(
    eta: torch.Tensor,
    sens: torch.Tensor,
    mats: torch.Tensor,
    z0: torch.Tensor,
    sigma: float = 1.0,
    coil_dim: int = 1,
) -> torch.Tensor:
    """RIM likelihood gradient via the PSF-1D operator:
    ``grad = sum_c s_c^* (C (s_c eta)) - z0`` with ``z0 = sens_reduce(mask * y)``;
    exact alternative to :func:`log_likelihood_gradient` for 1D masks."""
    coil = cmul(eta.unsqueeze(coil_dim), sens)
    filt = apply_psf1d(coil, mats)
    grad = (cmul_conj(filt, sens).sum(dim=coil_dim) - z0) / (sigma**2)
    return torch.cat([eta, grad], dim=-1)
