"""CascadeNet (counterpart of ``mridc_tpu/models/recon/ccnn.py``): cascades of
soft DC and a conv cascade regulariser in k-space, each with its own weights.

Per cascade: ``pred <- pred - soft_dc(pred, y, m, w) - sens_expand(
Conv2dCascade(sens_reduce(pred)))`` (``no_dc``: the expansion alone); the
SENSE reduction and expansion run on K2's stages around cuFFT on the card.
The prediction is the coil combination of ``ifft2(pred)``: for SENSE,
:func:`sens_reduce` once more. The cascades run their BatchNorm (if any) in
train mode while training, as the JAX package's do.

Module names: ``cascades.{i}.model`` (the conv cascade),
``cascades.{i}.dc_weight``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.conv2d import Conv2dCascade
from mridc_tpu_torch.nn.dc import soft_dc

__all__ = ["CascadeNet", "CascadeNetBlock"]


class CascadeNetBlock(nn.Module):
    """One cascade's weights: the conv cascade ``model`` and the soft DC
    weight (initialised to one)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.dc_weight = nn.Parameter(torch.ones(1))


class CascadeNet(BaseReconModel):
    """Config fields and defaults as in the JAX package; ``batchnorm`` with
    ``live_bn`` (the ``train_batch_stats`` knob) tracks running statistics.
    ``compute_dtype`` is the convs' (DC and FFTs stay float32)."""

    def __init__(
        self,
        num_cascades: int = 10,
        hidden_channels: int = 64,
        n_convs: int = 5,
        batchnorm: bool = False,
        live_bn: bool = False,
        no_dc: bool = False,
        compute_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.no_dc = no_dc
        self.cascades = nn.ModuleList([
            CascadeNetBlock(drawn(lambda: Conv2dCascade(2, 2, hidden_channels, n_convs, batchnorm, live_bn,
                                                        compute_dtype), generator))
            for _ in range(num_cascades)
        ])
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_cascades=cfg.get("num_cascades", 10),
            hidden_channels=cfg.get("hidden_channels", 64),
            n_convs=cfg.get("n_convs", 5),
            batchnorm=cfg.get("batchnorm", False),
            live_bn=bool(cfg.get("train_batch_stats", False)),
            no_dc=cfg.get("no_dc", False),
            compute_dtype=cfg.get("compute_dtype"),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del init_pred
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        c, n = self.fft_centered, self.fft_normalization
        pred = y
        for block in self.cascades:
            dc = soft_dc(pred, y, mask, block.dc_weight)
            image = sens_reduce(pred, sens, None, c, n, self.spatial_dims, self.coil_dim)
            model_term = sens_expand(block.model(image, train), sens, c, n)
            pred = model_term if self.no_dc else pred - dc - model_term
        return ModelOutput(prediction=self.zero_filled(pred, sens))
