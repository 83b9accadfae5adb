"""Zero-filled reconstruction (counterpart of ``mridc_tpu/models/recon/zf.py``):
the inverse FFT and the SENSE or RSS coil combination; no parameters."""

from __future__ import annotations

from typing import Optional

import torch

from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput

__all__ = ["ZF"]


class ZF(BaseReconModel):
    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        del generator
        return cls(
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del mask, init_pred, train
        return ModelOutput(prediction=self.zero_filled(y.contiguous(), sens.contiguous()))
