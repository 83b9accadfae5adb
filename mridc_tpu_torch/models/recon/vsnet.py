"""Variable-splitting network (counterpart of
``mridc_tpu/models/recon/vsnet.py``): per cascade, denoise the SENSE image,
replace the sampled k-space by the data under a learned weight, and blend.

Per cascade, with ``x = sens_reduce(k)``: ``p = denoiser(x)``, ``s =
sens_reduce(w * ((1 - m) * sens_expand(p) + m * y))``, ``k <-
sens_expand(a * (x + p) + (1 - a) * s)``. The JAX package reduces ``k`` twice
per cascade (the denoiser's input and the blend's term); they are the same
function of ``k``, so the port reduces it once: two reductions and two
expansions per cascade on K2's stages, and one reduction for the SENSE
prediction. The denoisers run in eval mode, as in the JAX package.

Module names: ``cascades.{i}.model`` (CONV, MWCNN or NormUnet),
``cascades.{i}.dc_weight``, ``cascades.{i}.weighted_avg``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.conv2d import Conv2dCascade
from mridc_tpu_torch.nn.mwcnn import MWCNN
from mridc_tpu_torch.nn.unet import NormUnet

__all__ = ["VSNet", "VSNetBlock"]


class VSNetBlock(nn.Module):
    """One cascade's weights: the denoiser ``model``, the DC weight and the
    weighted-average weight (both initialised to one)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.dc_weight = nn.Parameter(torch.ones(1))
        self.weighted_avg = nn.Parameter(torch.ones(1))


def _denoiser(arch: str, cfg) -> nn.Module:
    dt = cfg.get("compute_dtype")
    if arch == "MWCNN":
        return MWCNN(2, cfg.get("image_mwcnn_hidden_channels", 16), cfg.get("image_mwcnn_num_scales", 2), dtype=dt)
    if arch in ("UNET", "NORMUNET"):
        return NormUnet(cfg.get("imspace_unet_num_filters", 16), cfg.get("imspace_unet_num_pool_layers", 2),
                        padding_size=cfg.get("imspace_unet_padding_size", 11),
                        normalize=cfg.get("imspace_unet_normalize", True), dtype=dt)
    return Conv2dCascade(2, 2, cfg.get("imspace_conv_hidden_channels", 16), cfg.get("imspace_conv_n_convs", 4),
                         cfg.get("imspace_conv_batchnorm", False), bool(cfg.get("train_batch_stats", False)), dt)


class VSNet(BaseReconModel):
    """Config fields and defaults as in the JAX package (``cfg`` holds the
    denoiser's keys)."""

    def __init__(
        self,
        num_cascades: int = 10,
        image_arch: str = "CONV",
        cfg: Optional[dict] = None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        cfg = dict(cfg or {})
        self.cascades = nn.ModuleList([VSNetBlock(drawn(lambda: _denoiser(image_arch, cfg), generator))
                                       for _ in range(num_cascades)])
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_cascades=cfg.get("num_cascades", 10),
            image_arch=str(cfg.get("imspace_model_architecture", "CONV")).upper(),
            cfg=dict(cfg),
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
        m = mask[..., None]

        def reduce(k):
            return sens_reduce(k, sens, None, c, n, self.spatial_dims, self.coil_dim)

        kspace = y
        for block in self.cascades:
            image = reduce(kspace)
            pred = block.model(image)
            sx = reduce(((1 - m) * sens_expand(pred, sens, c, n) + m * y) * block.dc_weight)
            wa = block.weighted_avg
            kspace = sens_expand(wa * (image + pred) + (1 - wa) * sx, sens, c, n)
        return ModelOutput(prediction=self.zero_filled(kspace, sens))
