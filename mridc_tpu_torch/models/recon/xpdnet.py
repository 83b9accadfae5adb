"""XPDNet, the cross-domain primal-dual network (counterpart of
``mridc_tpu/models/recon/xpdnet.py``): per iteration, the k-space buffer is
refined from [buffer, forward(primal images), y] and the image buffer from
[buffer, backward(k-space buffer)], each iteration with its own weights.
``use_primal_only`` replaces the k-space model by the residual
``buffer - forward(primal image 0)``.

The forward and backward operators are masked SENSE: ``forward(x) = M F S x``
is :func:`sens_expand` with the mask and ``backward(k) = S^H F^-1 M k`` is
:func:`sens_reduce` with the mask, each one K2 Function call (expand, cuFFT,
mask; load with the mask, inverse cuFFT, reduce; the backward of each is the
other). With ``use_primal_only`` only primal image 0's forward reaches an
output, so only it is computed (XLA drops the other ``num_primal - 1`` from
the JAX package's graph too): per iteration one masked expansion and
``num_dual`` masked reductions.

``scan_iterations`` changes only the JAX package's parameter layout (one
iteration's modules under ``Scan_XPDIter_0``, each leaf stacked over the
iterations); the port runs the unrolled loop either way and
``xpdnet_params_from_jax`` takes both layouts. As in the JAX package it is
refused with a BatchNorm regulariser.

Module names: ``iterations.{i}.image_model`` (MWCNN: ``.mwcnn`` and the 3x3
``.head``; or a NormUnet), ``iterations.{i}.kspace_model`` (CONV, DIDN or
NormUnet; absent with ``use_primal_only``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.conv2d import Conv2dCascade
from mridc_tpu_torch.nn.didn import DIDN
from mridc_tpu_torch.nn.mwcnn import MWCNN, MWCNNHead
from mridc_tpu_torch.nn.unet import NormUnet

__all__ = ["XPDNet", "XPDIteration"]


class XPDIteration(nn.Module):
    """One iteration's ``image_model`` and (without ``use_primal_only``)
    ``kspace_model``."""

    def __init__(self, image_model: nn.Module, kspace_model: Optional[nn.Module]):
        super().__init__()
        self.image_model = image_model
        self.kspace_model = kspace_model


class XPDNet(BaseReconModel):
    """Config fields and defaults as in the JAX package (``cfg`` holds the
    regularisers' keys); ``compute_dtype`` is the regularisers' convs'."""

    def __init__(
        self,
        num_iter: int = 2,
        num_primal: int = 5,
        num_dual: int = 1,
        use_primal_only: bool = True,
        image_arch: str = "MWCNN",
        kspace_arch: str = "CONV",
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
        if cfg.get("scan_iterations") and cfg.get("mwcnn_batchnorm"):
            raise ValueError("scan_iterations does not support batchnorm regularizers; use the unrolled path")
        self.num_primal, self.num_dual, self.use_primal_only = num_primal, num_dual, use_primal_only
        self.image_arch, self.kspace_arch, self.cfg = image_arch, kspace_arch, cfg
        self.iterations = nn.ModuleList([
            XPDIteration(drawn(self._image_model, generator),
                         None if use_primal_only else drawn(self._kspace_model, generator))
            for _ in range(num_iter)
        ])
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        use_primal_only = cfg.get("use_primal_only", True)
        return cls(
            num_iter=cfg.get("num_iter", 2),
            num_primal=cfg.get("num_primal", 5),
            num_dual=1 if use_primal_only else cfg.get("num_dual", 5),
            use_primal_only=use_primal_only,
            image_arch=str(cfg.get("image_model_architecture", "MWCNN")).upper(),
            kspace_arch=str(cfg.get("kspace_model_architecture", "CONV")).upper(),
            cfg=dict(cfg),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def _image_model(self) -> nn.Module:
        cfg, dt = self.cfg, self.cfg.get("compute_dtype")
        cin, out = 2 * (self.num_primal + self.num_dual), 2 * self.num_primal
        if self.image_arch == "MWCNN":
            hc = cfg.get("mwcnn_hidden_channels", 16)
            mw = MWCNN(cin, hc, cfg.get("mwcnn_num_scales", 2), cfg.get("mwcnn_batchnorm", False),
                       bool(cfg.get("train_batch_stats", False)), dt)
            return MWCNNHead(mw, cin, out, 3, dt)
        return NormUnet(cfg.get("imspace_unet_num_filters", 16), cfg.get("imspace_unet_num_pool_layers", 2),
                        in_chans=cin, out_chans=out, padding_size=cfg.get("imspace_unet_padding_size", 11),
                        normalize=cfg.get("imspace_unet_normalize", True), dtype=dt)

    def _kspace_model(self) -> nn.Module:
        cfg, dt = self.cfg, self.cfg.get("compute_dtype")
        cin, out = 2 * (self.num_dual + self.num_primal + 1), 2 * self.num_dual
        if self.kspace_arch == "DIDN":
            return DIDN(cin, out, cfg.get("dual_didn_hidden_channels", 32), cfg.get("dual_didn_num_dubs", 2),
                        cfg.get("dual_didn_num_convs_recon", 3), dtype=dt)
        if self.kspace_arch in ("UNET", "NORMUNET"):
            return NormUnet(cfg.get("kspace_unet_num_filters", 16), cfg.get("kspace_unet_num_pool_layers", 2),
                            in_chans=cin, out_chans=out, padding_size=cfg.get("kspace_unet_padding_size", 11),
                            normalize=cfg.get("kspace_unet_normalize", True), dtype=dt)
        return Conv2dCascade(cin, out, cfg.get("dual_conv_hidden_channels", 16), cfg.get("dual_conv_n_convs", 4),
                             dtype=dt)

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del init_pred, train
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        c, n = self.fft_centered, self.fft_normalization

        def fwd(img):
            return sens_expand(img, sens, c, n, mask=mask)

        def bwd(k):
            return sens_reduce(k, sens, mask, c, n, self.spatial_dims, self.coil_dim)

        image_buffer = torch.cat([bwd(y)] * self.num_primal, dim=-1)
        kspace_buffer = torch.cat([y] * self.num_dual, dim=-1)
        for it in self.iterations:
            if self.use_primal_only:
                kspace_buffer = kspace_buffer[..., :2] - fwd(image_buffer[..., 0:2])
            else:
                fwd_buf = [fwd(image_buffer[..., 2 * i : 2 * i + 2]) for i in range(self.num_primal)]
                k_in = torch.cat([kspace_buffer, *fwd_buf, y], dim=-1)
                b, nc, h, w, ch = k_in.shape
                kspace_buffer = it.kspace_model(k_in.reshape(b * nc, h, w, ch)).reshape(b, nc, h, w,
                                                                                        2 * self.num_dual)
            bwd_buf = [bwd(kspace_buffer[..., 2 * i : 2 * i + 2]) for i in range(self.num_dual)]
            image_buffer = it.image_model(torch.cat([image_buffer, *bwd_buf], dim=-1))
        return ModelOutput(prediction=image_buffer[..., 0:2].contiguous())
