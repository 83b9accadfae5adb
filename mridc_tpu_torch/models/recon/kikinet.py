"""KIKINet, alternating k-space and image-space networks (counterpart of
``mridc_tpu/models/recon/kikinet.py``): ONE k-space model (run per coil) and
ONE image model shared across the iterations.

Per iteration: ``k <- kspace_model(k)`` coil by coil, ``image =
image_model(sens_reduce(k))``, then (unless ``no_dc``) ``image =
sens_reduce(k - soft_dc(k_in, y, m, w) - sens_expand(image))``, the DC
residual of the iteration's input k-space feeding the image, not the k-space
carried on; every iteration but the last carries ``sens_expand(image)``. The
SENSE operators run on K2's stages on the card. The regularisers run in eval
mode (the JAX package drops ``train``). ``scan_iterations`` gives the JAX
package the same parameter tree as the unrolled loop; the key is accepted,
and refused with a BatchNorm regulariser as there.

Module names: ``kspace_model`` (DIDN, CONV or NormUnet), ``image_model``
(MWCNN or NormUnet), ``dc_weight``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.conv2d import Conv2dCascade
from mridc_tpu_torch.nn.dc import soft_dc
from mridc_tpu_torch.nn.didn import DIDN
from mridc_tpu_torch.nn.mwcnn import MWCNN
from mridc_tpu_torch.nn.unet import NormUnet

__all__ = ["KIKINet"]


def _kspace_model(cfg) -> nn.Module:
    arch, dt = str(cfg.get("kspace_model_architecture", "DIDN")).upper(), cfg.get("compute_dtype")
    if arch == "CONV":
        return Conv2dCascade(2, 2, cfg.get("kspace_conv_hidden_channels", 16), cfg.get("kspace_conv_n_convs", 4),
                             cfg.get("kspace_conv_batchnorm", False), bool(cfg.get("train_batch_stats", False)), dt)
    if arch == "DIDN":
        return DIDN(2, 2, cfg.get("kspace_didn_hidden_channels", 64), cfg.get("kspace_didn_num_dubs", 2),
                    cfg.get("kspace_didn_num_convs_recon", 3), dtype=dt)
    if arch in ("UNET", "NORMUNET"):
        return NormUnet(cfg.get("kspace_unet_num_filters", 16), cfg.get("kspace_unet_num_pool_layers", 2),
                        padding_size=cfg.get("kspace_unet_padding_size", 11),
                        normalize=cfg.get("kspace_unet_normalize", True), dtype=dt)
    raise NotImplementedError(f"KIKINet kspace_model_architecture {arch} not supported")


def _image_model(cfg) -> nn.Module:
    arch, dt = str(cfg.get("imspace_model_architecture", "MWCNN")).upper(), cfg.get("compute_dtype")
    if arch == "MWCNN":
        return MWCNN(2, cfg.get("image_mwcnn_hidden_channels", 16), cfg.get("image_mwcnn_num_scales", 2),
                     cfg.get("image_mwcnn_batchnorm", False), bool(cfg.get("train_batch_stats", False)), dt)
    if arch in ("UNET", "NORMUNET"):
        return NormUnet(cfg.get("imspace_unet_num_filters", 16), cfg.get("imspace_unet_num_pool_layers", 2),
                        padding_size=cfg.get("imspace_unet_padding_size", 11),
                        normalize=cfg.get("imspace_unet_normalize", True), dtype=dt)
    raise NotImplementedError(f"KIKINet imspace_model_architecture {arch} not supported")


class KIKINet(BaseReconModel):
    """Config fields and defaults as in the JAX package (``cfg`` holds the
    regularisers' keys)."""

    def __init__(
        self,
        num_iter: int = 2,
        no_dc: bool = False,
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
        if cfg.get("scan_iterations") and (cfg.get("kspace_conv_batchnorm") or cfg.get("image_mwcnn_batchnorm")):
            raise ValueError("scan_iterations does not support batchnorm regularizers; use the unrolled path")
        self.num_iter, self.no_dc = num_iter, no_dc
        self.kspace_model = drawn(lambda: _kspace_model(cfg), generator)
        self.image_model = drawn(lambda: _image_model(cfg), generator)
        self.dc_weight = nn.Parameter(torch.ones(1))
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_iter=cfg.get("num_iter", 2),
            no_dc=cfg.get("no_dc", False),
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

        def reduce(k):
            return sens_reduce(k, sens, None, c, n, self.spatial_dims, self.coil_dim)

        kspace, image = y, None
        for idx in range(self.num_iter):
            dc = soft_dc(kspace, y, mask, self.dc_weight)
            b, nc, h, w, _ = kspace.shape
            kspace = self.kspace_model(kspace.reshape(b * nc, h, w, 2)).reshape(b, nc, h, w, 2)
            image = self.image_model(reduce(kspace))
            if not self.no_dc:
                image = reduce(kspace - dc - sens_expand(image, sens, c, n))
            if idx < self.num_iter - 1:
                kspace = sens_expand(image, sens, c, n)
        return ModelOutput(prediction=image)
