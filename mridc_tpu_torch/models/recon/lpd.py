"""Learned primal-dual network (counterpart of
``mridc_tpu/models/recon/lpd.py``): buffers of ``num_primal`` images and
``num_dual`` k-spaces; per iteration the dual model (run per coil) refines
the k-spaces from [dual, forward(primal image 1), y] and the primal model the
images from [primal, backward(dual k-space 0)]. ONE primal and ONE dual model
are shared across the iterations.

``forward(x) = M F S x`` is :func:`sens_expand` with the mask and
``backward(k) = S^H F^-1 M k`` :func:`sens_reduce` with the mask: one K2
Function call each way (per iteration one of each, and the input image
``backward(y)``). ``scan_iterations`` gives the JAX package the same
parameter tree as the unrolled loop; the key is accepted, and refused with a
BatchNorm regulariser as there.

Module names: ``dual_model`` (NormUnet, DIDN or CONV), ``primal_model``
(NormUnet, or MWCNN: ``.mwcnn`` and the 1x1 ``.head``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.conv2d import Conv2dCascade
from mridc_tpu_torch.nn.didn import DIDN
from mridc_tpu_torch.nn.mwcnn import MWCNN, MWCNNHead
from mridc_tpu_torch.nn.unet import NormUnet

__all__ = ["LPDNet"]


class LPDNet(BaseReconModel):
    """Config fields and defaults as in the JAX package (``cfg`` holds the
    regularisers' keys)."""

    def __init__(
        self,
        num_iter: int = 2,
        num_primal: int = 5,
        num_dual: int = 5,
        primal_arch: str = "UNET",
        dual_arch: str = "UNET",
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
        if cfg.get("scan_iterations") and cfg.get("kspace_conv_batchnorm"):
            raise ValueError("scan_iterations does not support batchnorm regularizers; use the unrolled path")
        if primal_arch not in ("MWCNN", "UNET", "NORMUNET"):
            raise ValueError(f"LPDNet primal_model_architecture must be MWCNN or UNET, got {primal_arch!r}")
        if dual_arch not in ("CONV", "DIDN", "UNET", "NORMUNET"):
            raise ValueError(f"LPDNet dual_model_architecture must be CONV, DIDN or UNET, got {dual_arch!r}")
        self.num_iter, self.num_primal, self.num_dual = num_iter, num_primal, num_dual
        dt = cfg.get("compute_dtype")
        d_in, d_out = 2 * (num_dual + 2), 2 * num_dual
        p_in, p_out = 2 * (num_primal + 1), 2 * num_primal

        def dual():
            if dual_arch == "DIDN":
                return DIDN(d_in, d_out, cfg.get("kspace_didn_hidden_channels", 32),
                            cfg.get("kspace_didn_num_dubs", 2), cfg.get("kspace_didn_num_convs_recon", 3), dtype=dt)
            if dual_arch == "CONV":
                return Conv2dCascade(d_in, d_out, cfg.get("kspace_conv_hidden_channels", 16),
                                     cfg.get("kspace_conv_n_convs", 4), cfg.get("kspace_conv_batchnorm", False),
                                     bool(cfg.get("train_batch_stats", False)), dt)
            return NormUnet(cfg.get("dual_unet_num_filters", 16), cfg.get("dual_unet_num_pool_layers", 2),
                            in_chans=d_in, out_chans=d_out, padding_size=cfg.get("dual_unet_padding_size", 11),
                            normalize=cfg.get("dual_unet_normalize", True), dtype=dt)

        def primal():
            if primal_arch == "MWCNN":
                mw = MWCNN(p_in, cfg.get("primal_mwcnn_hidden_channels", 16), cfg.get("primal_mwcnn_num_scales", 2),
                           dtype=dt)
                return MWCNNHead(mw, p_in, p_out, 1, dt)
            return NormUnet(cfg.get("primal_unet_num_filters", 16), cfg.get("primal_unet_num_pool_layers", 2),
                            in_chans=p_in, out_chans=p_out, padding_size=cfg.get("primal_unet_padding_size", 11),
                            normalize=cfg.get("primal_unet_normalize", True), dtype=dt)

        self.dual_model = drawn(dual, generator)
        self.primal_model = drawn(primal, generator)
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_iter=cfg.get("num_iter", 2),
            num_primal=cfg.get("num_primal", 5),
            num_dual=cfg.get("num_dual", 5),
            primal_arch=str(cfg.get("primal_model_architecture", "UNET")).upper(),
            dual_arch=str(cfg.get("dual_model_architecture", "UNET")).upper(),
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

        def adj(k):
            return sens_reduce(k, sens, mask, c, n, self.spatial_dims, self.coil_dim)

        dual = torch.cat([y] * self.num_dual, dim=-1)
        primal = torch.cat([adj(y)] * self.num_primal, dim=-1)
        for _ in range(self.num_iter):
            f2 = sens_expand(primal[..., 2:4], sens, c, n, mask=mask)
            dual_in = torch.cat([dual, f2, y], dim=-1)
            b, nc, h, w, ch = dual_in.shape
            dual = self.dual_model(dual_in.reshape(b * nc, h, w, ch)).reshape(b, nc, h, w, 2 * self.num_dual)
            primal = self.primal_model(torch.cat([primal, adj(dual[..., 0:2])], dim=-1))
        return ModelOutput(prediction=primal[..., 0:2].contiguous())
