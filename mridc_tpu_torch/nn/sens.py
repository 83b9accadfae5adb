"""Learned coil-sensitivity estimation (counterpart of
``mridc_tpu/nn/sens.py``, E2E-VarNet style): mask the ACS region, inverse FFT
to coil images, a NormUnet per coil (coils folded into the batch), RSS
normalisation.

Layout: real views, k-space [B, C, H, W, 2], mask [B, 1, H, W]. The NormUnet
is the attribute ``norm_unet``, so its keys are the reference's
``norm_unet.unet.*`` (``mridc/collections/common/nn/base.py:276``
``BaseSensitivityModel``), which ``mridc_tpu.utils.torch_import.
import_sensitivity_model_params`` reads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.nn.unet import NormUnet
from mridc_tpu_torch.ops.cplx import cabs2
from mridc_tpu_torch.ops.fft import ifft2_rv

__all__ = ["SensitivityModel"]


class SensitivityModel(nn.Module):
    """Config fields and defaults as in the JAX package; ``dtype`` is the
    NormUnet's conv compute dtype (the ACS masking, the FFT and the RSS
    normalisation stay float32)."""

    def __init__(self, chans: int = 8, num_pools: int = 4, mask_type: str = "2D", fft_centered: bool = False,
                 fft_normalization: str = "backward", spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1,
                 normalize: bool = True, mask_center: bool = True, dtype=None):
        super().__init__()
        self.mask_type = mask_type
        self.fft_centered = fft_centered
        self.fft_normalization = fft_normalization
        self.spatial_dims = tuple(spatial_dims)
        self.coil_dim = coil_dim
        self.normalize = normalize
        self.mask_center = mask_center
        self.norm_unet = NormUnet(chans, num_pools, normalize=normalize, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.norm_unet.reset_parameters(generator)

    def _acs(self, x: torch.Tensor, mask: torch.Tensor, num_low_frequencies: Optional[int]) -> torch.Tensor:
        """The reference's ACS masking mirrored exactly (base.py:443-466 and
        ``utils.batched_mask_center``:379): the ACS width is read from the W
        profile at H row 0; the band lies on H for batch 1 with ``mask_type``
        "2D", on W otherwise (an upstream batch-size dependence, pinned)."""
        if mask.ndim == 3:
            mask = mask[:, None]
        b = x.shape[0]
        line = torch.broadcast_to(mask, (b, 1) + tuple(x.shape[2:4]))[:, 0, 0, :].to(torch.int8)  # [B, W]
        n = line.shape[1]
        cent = n // 2
        left = torch.argmin(torch.flip(line[:, :cent], dims=(1,)), dim=1)
        right = torch.argmin(line[:, cent:], dim=1)
        num_low = torch.clamp(2 * torch.minimum(left, right), min=1)
        if num_low_frequencies is not None and num_low_frequencies > 0:
            num_low = torch.full_like(num_low, num_low_frequencies)
        pad = torch.div(n - num_low + 1, 2, rounding_mode="floor")
        axis = 3 if (b > 1 or self.mask_type.upper() == "1D") else 2
        idx = torch.arange(x.shape[axis], device=x.device)
        keep = (idx[None, :] >= pad[:, None]) & (idx[None, :] < (pad + num_low)[:, None])
        shape = [b, 1, 1, 1, 1]
        shape[axis] = x.shape[axis]
        return torch.where(keep.reshape(shape), x, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, masked_kspace: torch.Tensor, mask: torch.Tensor, num_low_frequencies: Optional[int] = None,
                train: bool = False) -> torch.Tensor:
        """[B, C, H, W, 2] k-space and a [B, 1, H, W] mask -> [B, C, H, W, 2] maps."""
        x = masked_kspace
        if self.mask_center:
            x = self._acs(x, mask, num_low_frequencies)
        images = ifft2_rv(x, self.fft_centered, self.fft_normalization, self.spatial_dims)
        b, c, h, w, _ = images.shape
        est = self.norm_unet(images.reshape(b * c, h, w, 2), train).reshape(b, c, h, w, 2)
        if self.normalize:
            rss = torch.sqrt(cabs2(est).sum(dim=self.coil_dim, keepdim=True))[..., None]
            est = est / torch.clamp(rss, min=1e-12)
        return est
