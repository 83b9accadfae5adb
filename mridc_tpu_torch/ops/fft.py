"""Centered / uncentered 2D FFT primitives (counterpart of
``mridc_tpu/ops/fft.py``) on ``torch.fft`` — cuFFT on the card.

Normalization modes are ``torch.fft``'s ``norm=``: "backward" (default, no
scaling on forward), "ortho" (1/sqrt(n) both ways), "forward" (1/n on
forward). "none"/None is accepted as an alias of "backward".

The JAX package computes its real-view transforms as DFT matmuls on the TPU
(``use_matmul``, ``MRIDC_DFT_PRECISION``); that is a TPU layout choice, so here
``use_matmul`` is accepted and ignored and every transform is the native FFT.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["fft2c", "ifft2c", "fft2", "ifft2", "fftshift", "ifftshift", "fft2_rv", "ifft2_rv", "dft_mats"]


def _norm(normalization: Optional[str]) -> str:
    if normalization is None:
        return "backward"
    normalization = normalization.lower()
    if normalization == "none":
        return "backward"
    if normalization not in ("backward", "ortho", "forward"):
        raise ValueError(f"Unknown FFT normalization: {normalization!r}")
    return normalization


def _dims(spatial_dims: Optional[Sequence[int]]) -> Tuple[int, ...]:
    if spatial_dims is None:
        return (-2, -1)
    return tuple(int(d) for d in spatial_dims)


def fft2(
    data: torch.Tensor,
    centered: bool = False,
    normalization: str = "backward",
    spatial_dims: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """2D FFT of a complex tensor over ``spatial_dims`` (default last two);
    ``centered=True`` surrounds it with ifftshift/fftshift."""
    dims = _dims(spatial_dims)
    if centered:
        data = torch.fft.ifftshift(data, dim=dims)
    data = torch.fft.fftn(data, dim=dims, norm=_norm(normalization))
    if centered:
        data = torch.fft.fftshift(data, dim=dims)
    return data


def ifft2(
    data: torch.Tensor,
    centered: bool = False,
    normalization: str = "backward",
    spatial_dims: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """2D inverse FFT; exact inverse of :func:`fft2` for the same arguments."""
    dims = _dims(spatial_dims)
    if centered:
        data = torch.fft.ifftshift(data, dim=dims)
    data = torch.fft.ifftn(data, dim=dims, norm=_norm(normalization))
    if centered:
        data = torch.fft.fftshift(data, dim=dims)
    return data


def fft2c(data: torch.Tensor, spatial_dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    return fft2(data, centered=True, normalization="ortho", spatial_dims=spatial_dims)


def ifft2c(data: torch.Tensor, spatial_dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    return ifft2(data, centered=True, normalization="ortho", spatial_dims=spatial_dims)


def fftshift(data: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.fftshift(data, dim=axes)


def ifftshift(data: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.ifftshift(data, dim=axes)


@functools.lru_cache(maxsize=64)
def _dft_mats(n: int, inverse: bool, centered: bool, normalization: str):
    """Constant (real, imag) parts of the combined shift+DFT matrix, built in
    complex128 and rounded to float32 exactly as the JAX package does."""
    eye = np.eye(n, dtype=np.complex128)
    fn = np.fft.ifft if inverse else np.fft.fft
    cols = np.fft.ifftshift(eye, axes=0) if centered else eye
    mat = fn(cols, axis=0, norm=_norm(normalization))
    if centered:
        mat = np.fft.fftshift(mat, axes=0)
    return mat.real.astype(np.float32), mat.imag.astype(np.float32)


def dft_mats(n: int, inverse: bool, centered: bool, normalization: str):
    """Combined shift+DFT matrices (real, imag) as numpy float32 [n, n]: the
    operand of nn/dc.py's PSF-1D operator."""
    return _dft_mats(n, inverse, centered, normalization)


def _native_rv(x: torch.Tensor, inverse: bool, centered: bool, normalization: str) -> torch.Tensor:
    z = torch.view_as_complex(x.contiguous())
    fn = ifft2 if inverse else fft2
    z = fn(z, centered=centered, normalization=normalization, spatial_dims=(-2, -1))
    return torch.view_as_real(z)


def fft2_rv(
    data: torch.Tensor,
    centered: bool = False,
    normalization: str = "backward",
    spatial_dims: Optional[Sequence[int]] = None,
    use_matmul: Optional[bool] = None,
) -> torch.Tensor:
    """2D FFT over a [..., h, w, 2] real view (spatial dims fixed to the two
    axes before the complex axis, the only case the models use)."""
    del spatial_dims, use_matmul
    return _native_rv(data, False, centered, normalization)


def ifft2_rv(
    data: torch.Tensor,
    centered: bool = False,
    normalization: str = "backward",
    spatial_dims: Optional[Sequence[int]] = None,
    use_matmul: Optional[bool] = None,
) -> torch.Tensor:
    """2D inverse FFT over a [..., h, w, 2] real view."""
    del spatial_dims, use_matmul
    return _native_rv(data, True, centered, normalization)
