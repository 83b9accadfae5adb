"""Reconstruction-model base (counterpart of ``mridc_tpu/models/base.py``):
shared config fields and the output container.

Inputs are real views: y [B, C, H, W, 2] masked k-space, sens [B, C, H, W, 2],
mask [B, 1, H, W] (broadcastable), init_pred [B, H, W, 2] or None; the
prediction is [B, H, W, 2].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import sens_reduce
from mridc_tpu_torch.ops.cplx import ccombine
from mridc_tpu_torch.ops.fft import ifft2_rv

__all__ = ["ModelOutput", "BaseReconModel", "expand_mask", "check_dc_mode", "drawn"]


@dataclass
class ModelOutput:
    """prediction: final image [B, H, W, 2] real view.
    intermediates: optional stacked per-step predictions [..., B, H, W, 2].
    recon_intermediates: optional per-echo reconstruction stack of the
    quantitative models."""

    prediction: torch.Tensor
    intermediates: Optional[torch.Tensor] = None
    recon_intermediates: Optional[torch.Tensor] = None


def check_dc_mode(mode: str) -> str:
    """Validate the dc_mode config value."""
    if mode not in ("full", "psf1d"):
        raise ValueError(f"dc_mode must be 'full' or 'psf1d', got {mode!r}")
    return mode


def expand_mask(mask: torch.Tensor) -> torch.Tensor:
    """Ensure a mask broadcastable to [B, C, H, W] (adds the coil axis)."""
    if mask.ndim == 3:  # [B, H, W] or [B, 1, W]
        mask = mask[:, None]
    return mask


def drawn(factory: Callable[[], nn.Module], generator: Optional[torch.Generator] = None) -> nn.Module:
    """``factory()`` built on the meta device, then given storage on the CPU
    and its weights by its ``reset_parameters`` from ``generator`` alone, so
    that construction draws nothing from the global random state."""
    with torch.device("meta"):
        module = factory()
    module.to_empty(device="cpu")
    module.reset_parameters(generator)
    return module


class BaseReconModel(nn.Module):
    """Common config fields; subclasses implement ``forward(y, sens, mask,
    init_pred=None, train=False) -> ModelOutput``."""

    def __init__(
        self,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
    ):
        super().__init__()
        self.fft_centered = fft_centered
        self.fft_normalization = fft_normalization
        self.spatial_dims = tuple(spatial_dims)
        self.coil_dim = coil_dim
        self.coil_combination_method = coil_combination_method

    def zero_filled(self, y: torch.Tensor, sens: torch.Tensor) -> torch.Tensor:
        """SENSE/RSS combine of the zero-filled reconstruction -> [B, H, W, 2].
        SENSE is :func:`sens_reduce` (the inverse FFT and ``ccombine``'s sum
        over coils of conj(s_c) x_c; on the card K2's load and reduce stages
        around cuFFT); RSS stays plain."""
        if self.coil_combination_method.upper() == "SENSE":
            return self.sense_init(y, sens)
        img = ifft2_rv(y, self.fft_centered, self.fft_normalization, self.spatial_dims)
        return ccombine(img, sens, self.coil_combination_method, self.coil_dim)

    def sense_init(self, y: torch.Tensor, sens: torch.Tensor) -> torch.Tensor:
        return sens_reduce(
            y, sens, None, self.fft_centered, self.fft_normalization, self.spatial_dims, self.coil_dim
        )
