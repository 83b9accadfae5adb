"""CS and PICS (counterpart of ``mridc_tpu/models/recon/cs.py``): the
parameter-free FISTA reconstructions of :mod:`mridc_tpu_torch.nn.cs_solvers`,
the reference's sigpy ``L1WaveletRecon`` / ``TotalVariationRecon`` and BART's
``pics -R W``. A training step computes the loss and updates nothing."""

from __future__ import annotations

from typing import Optional

import torch

from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, expand_mask
from mridc_tpu_torch.nn.cs_solvers import fista_l1_wavelet, fista_tv

__all__ = ["CS", "PICS"]


class CS(BaseReconModel):
    """``cs_type`` ``l1_wavelet`` or ``total_variation``, ``reg_wt`` and
    ``num_iters`` with the JAX package's defaults."""

    def __init__(self, cs_type: str = "l1_wavelet", reg_wt: float = 0.005, num_iters: int = 60, **common):
        super().__init__(**common)
        self.cs_type = cs_type
        self.reg_wt = reg_wt
        self.num_iters = num_iters

    @staticmethod
    def _common(cfg):
        return dict(
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
        )

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        del generator
        return cls(cs_type=cfg.get("cs_type", "l1_wavelet"), reg_wt=cfg.get("reg_wt", 0.005),
                   num_iters=cfg.get("num_iters", 60), **cls._common(cfg))

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del init_pred, train
        solver = fista_l1_wavelet if self.cs_type == "l1_wavelet" else fista_tv
        x = solver(y, sens, expand_mask(mask), reg_wt=self.reg_wt, num_iters=self.num_iters,
                   fft_centered=self.fft_centered, fft_normalization=self.fft_normalization,
                   spatial_dims=self.spatial_dims, coil_dim=self.coil_dim)
        return ModelOutput(prediction=x)


class PICS(CS):
    """Parallel-imaging compressed sensing (BART ``pics -R W``): l1-wavelet
    FISTA on the SENSE model."""

    def __init__(self, reg_wt: float = 0.005, num_iters: int = 60, **common):
        super().__init__("l1_wavelet", reg_wt, num_iters, **common)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        del generator
        return cls(reg_wt=cfg.get("reg_wt", 0.005), num_iters=cfg.get("num_iters", 60), **cls._common(cfg))
