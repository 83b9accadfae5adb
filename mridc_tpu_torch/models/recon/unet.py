"""UNet reconstruction baseline (counterpart of
``mridc_tpu/models/recon/unet.py``): the SENSE-combined zero-filled image
through a NormUnet.

The NormUnet is the module ``unet`` (its own Unet ``unet.unet``), so the
state-dict keys are the reference torch ones (``unet.unet.down_sample_layers...``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn
from mridc_tpu_torch.nn.unet import NormUnet

__all__ = ["UNet"]


class UNet(BaseReconModel):
    """Config fields and defaults as in the JAX package; ``compute_dtype`` is
    the convolutions' (opt-in bf16, parameters stay float32). ``train``
    switches dropout only."""

    def __init__(
        self,
        channels: int = 64,
        pooling_layers: int = 2,
        padding_size: int = 11,
        normalize: bool = True,
        dropout: float = 0.0,
        compute_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.unet = drawn(lambda: NormUnet(channels, pooling_layers, padding_size=padding_size, normalize=normalize,
                                           drop_prob=dropout, dtype=compute_dtype), generator)
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            channels=cfg.get("channels", 64),
            pooling_layers=cfg.get("pooling_layers", 2),
            padding_size=cfg.get("padding_size", 11),
            normalize=cfg.get("normalize", True),
            dropout=cfg.get("dropout_probability", 0.0),
            compute_dtype=cfg.get("compute_dtype", None),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del mask, init_pred
        x = self.zero_filled(y.contiguous(), sens.contiguous())
        return ModelOutput(prediction=self.unet(x, train))
