"""MultiDomainNet (counterpart of ``mridc_tpu/models/recon/multidomainnet.py``):
the coil images ``ifft2(y)``, standardised into (SENSE-combined, residual)
pairs (:class:`~mridc_tpu_torch.nn.multidomain.StandardizationLayer`, its
combination on K2's reduce stage on the card), a multi-domain U-Net on the
B x C coil images, and the coil combination of its output.

Module names: ``unet`` (:class:`~mridc_tpu_torch.nn.multidomain.MultiDomainUnet2d`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn
from mridc_tpu_torch.nn.multidomain import MultiDomainUnet2d, StandardizationLayer
from mridc_tpu_torch.ops.cplx import ccombine
from mridc_tpu_torch.ops.fft import ifft2_rv

__all__ = ["MultiDomainNet"]


class MultiDomainNet(BaseReconModel):
    """Config fields and defaults as in the JAX package; ``compute_dtype`` is
    the U-Net's convs' (its feature FFTs and InstanceNorm statistics stay
    float32)."""

    def __init__(
        self,
        standardization: bool = True,
        num_filters: int = 16,
        num_pool_layers: int = 2,
        compute_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.standardization = StandardizationLayer(coil_dim) if standardization else None
        self.unet = drawn(lambda: MultiDomainUnet2d(4 if standardization else 2, 2, num_filters, num_pool_layers,
                                                    0.0, fft_centered, fft_normalization, compute_dtype), generator)
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            compute_dtype=cfg.get("compute_dtype"),
            standardization=cfg.get("standardization", True),
            num_filters=cfg.get("num_filters", 16),
            num_pool_layers=cfg.get("num_pool_layers", 2),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del mask, init_pred
        sens = sens.contiguous()
        image = ifft2_rv(y, self.fft_centered, self.fft_normalization, self.spatial_dims)
        if self.standardization is not None:
            image = self.standardization(image, sens)  # [B, C, H, W, 4]
        b, c, h, w, ch = image.shape
        pred = self.unet(image.reshape(b * c, h, w, ch), train).reshape(b, c, h, w, 2)
        return ModelOutput(prediction=ccombine(pred, sens, self.coil_combination_method, self.coil_dim))
