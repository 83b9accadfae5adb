"""Convolutional recurrent network (counterpart of
``mridc_tpu/models/recon/crnn.py``): ONE conv cascade and one soft-DC weight
applied ``num_iterations`` times (the JAX package's ``nn.scan`` with its
parameters broadcast), every iteration's coil-combined prediction returned as
``intermediates`` for the loss.

Per iteration: ``image = sens_reduce(pred)``, ``pred <- pred - soft_dc(pred,
y, m, w) - sens_expand(Conv2dCascade(image) + image)``; each prediction is
:func:`sens_reduce` of its k-space for SENSE. The cascade is called without
``train``, as in the JAX package, so a BatchNorm in it runs in eval mode;
``train_batch_stats`` is refused for this model (the registry).

Module names: ``block.model`` (the conv cascade), ``block.dc_weight``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.models.recon.ccnn import CascadeNetBlock
from mridc_tpu_torch.nn.conv2d import Conv2dCascade
from mridc_tpu_torch.nn.dc import soft_dc

__all__ = ["CRNNet"]


class CRNNet(BaseReconModel):
    """Config fields and defaults as in the JAX package; ``compute_dtype`` is
    the convs' (DC and FFTs stay float32)."""

    def __init__(
        self,
        num_iterations: int = 10,
        hidden_channels: int = 64,
        n_convs: int = 3,
        batchnorm: bool = False,
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
        self.num_iterations = num_iterations
        self.no_dc = no_dc
        self.block = CascadeNetBlock(drawn(lambda: Conv2dCascade(2, 2, hidden_channels, n_convs, batchnorm,
                                                                 dtype=compute_dtype), generator))
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_iterations=cfg.get("num_iterations", 10),
            hidden_channels=cfg.get("hidden_channels", 64),
            n_convs=cfg.get("n_convs", 3),
            batchnorm=cfg.get("batchnorm", False),
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
        del init_pred, train
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        c, n = self.fft_centered, self.fft_normalization
        pred, combined = y, []
        for _ in range(self.num_iterations):
            dc = soft_dc(pred, y, mask, self.block.dc_weight)
            image = sens_reduce(pred, sens, None, c, n, self.spatial_dims, self.coil_dim)
            model_term = sens_expand(self.block.model(image) + image, sens, c, n)
            pred = model_term if self.no_dc else pred - dc - model_term
            combined.append(self.zero_filled(pred, sens))
        combined = torch.stack(combined)
        return ModelOutput(prediction=combined[-1], intermediates=combined)
