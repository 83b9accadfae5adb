"""Joint Deep Model-Based MR Image and Coil Sensitivity Reconstruction Network
(counterpart of ``mridc_tpu/models/recon/jointicnet.py``): alternating
gradient updates of the coil sensitivities and of the image, with NormUnet
regularisers in image space and k-space, the maps initialised by a learned
sensitivity model, and per-iteration learned step sizes and weights.

Module names: ``kspace_model`` and ``image_model`` (NormUnets),
``sens_net`` (:class:`~mridc_tpu_torch.nn.sens.SensitivityModel`),
``reg_param_I``, ``reg_param_F``, ``reg_param_C``, ``lr_image``, ``lr_sens``
([num_iter]); the JAX package's scopes are ``NormUnet_0`` (k-space),
``NormUnet_1`` (image), ``SensitivityModel_0`` and the same five parameters.

The maps take a gradient at every step, so every SENSE operation goes
through K2's Functions with their maps' gradient: the SENSE init
(``sens_reduce``), update C's ``F(s_c x)`` (``sens_expand``) and update X's
data term. That term is ``sum_c conj(s_c) F^-1(where(m == 0, 0, F(s_c x)) -
y)``: y is subtracted everywhere, not only on the mask, and the mask is its
indicator ``ind = (m != 0)``. K2's full DC computes ``F^-1(m (F(s_c x) -
y))``, so the term is written as ``full_dc`` on ``ind`` plus ``sens_reduce``
of y under the mask ``ind - 1`` (``-(1 - ind) y``): exact for any mask and any
y, at the cost of one more load, inverse FFT and reduce per iteration (the
second term vanishes for data whose y is zero off the mask, and is computed
all the same). Update C's residual keeps the JAX package's ``where`` s and
its elementwise product with the conjugated image (not a complex product),
and the maps are not renormalised.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import full_dc, sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.sens import SensitivityModel
from mridc_tpu_torch.nn.unet import NormUnet
from mridc_tpu_torch.ops.cplx import cconj
from mridc_tpu_torch.ops.fft import fft2_rv, ifft2_rv

__all__ = ["JointICNet"]


class JointICNet(BaseReconModel):
    """Config fields and defaults as in the JAX package; ``compute_dtype``
    is the NormUnets' conv compute dtype (parameters stay float32)."""

    def __init__(self, num_iter: int = 2, kspace_unet_num_filters: int = 16, kspace_unet_num_pool_layers: int = 2,
                 imspace_unet_num_filters: int = 16, imspace_unet_num_pool_layers: int = 2,
                 sens_unet_num_filters: int = 16, sens_unet_num_pool_layers: int = 2, padding_size: int = 11,
                 compute_dtype=None, fft_centered: bool = False, fft_normalization: str = "backward",
                 spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1, coil_combination_method: str = "SENSE",
                 generator: Optional[torch.Generator] = None):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.num_iter = num_iter
        self.kspace_model = drawn(lambda: NormUnet(kspace_unet_num_filters, kspace_unet_num_pool_layers,
                                                   padding_size=padding_size, dtype=compute_dtype), generator)
        self.image_model = drawn(lambda: NormUnet(imspace_unet_num_filters, imspace_unet_num_pool_layers,
                                                  padding_size=padding_size, dtype=compute_dtype), generator)
        self.sens_net = drawn(lambda: SensitivityModel(
            sens_unet_num_filters, sens_unet_num_pool_layers, fft_centered=fft_centered,
            fft_normalization=fft_normalization, spatial_dims=spatial_dims, coil_dim=coil_dim,
            dtype=compute_dtype), generator)
        for name in ("reg_param_I", "reg_param_F", "reg_param_C", "lr_image", "lr_sens"):
            setattr(self, name, nn.Parameter(torch.ones(num_iter)))
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_iter=cfg.get("num_iter", 2),
            compute_dtype=cfg.get("compute_dtype", None),
            kspace_unet_num_filters=cfg.get("kspace_unet_num_filters", 16),
            kspace_unet_num_pool_layers=cfg.get("kspace_unet_num_pool_layers", 2),
            imspace_unet_num_filters=cfg.get("imspace_unet_num_filters", 16),
            imspace_unet_num_pool_layers=cfg.get("imspace_unet_num_pool_layers", 2),
            sens_unet_num_filters=cfg.get("sens_unet_num_filters", 16),
            sens_unet_num_pool_layers=cfg.get("sens_unet_num_pool_layers", 2),
            padding_size=cfg.get("kspace_unet_padding_size", 11),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens_in, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del sens_in, init_pred
        c, n, sd = self.fft_centered, self.fft_normalization, self.spatial_dims
        y = y.contiguous()
        b, _, h, w, _ = y.shape
        mask = torch.broadcast_to(expand_mask(mask), (b, 1, h, w)).to(y.dtype).contiguous()
        m = mask[..., None]
        ind = (mask != 0).to(y.dtype)
        off = ind - 1  # -(1 - ind): y off the mask, subtracted in update X's data term

        dc_sens = self.sens_net(y, mask, train=train)
        sens = dc_sens
        image = sens_reduce(y, sens, None, c, n, sd, self.coil_dim)
        for i in range(self.num_iter):
            # update C (reference :82-159)
            rc, ls = self.reg_param_C[i], self.lr_sens[i]
            ax = torch.where(m == 0, torch.zeros((), dtype=y.dtype, device=y.device), sens_expand(image, sens, c, n))
            resid = torch.where(m == 1, torch.zeros((), dtype=y.dtype, device=y.device), ax - y)
            t3 = 2 * ls * (ifft2_rv(resid, c, n, sd) * cconj(image)[:, None])
            sens = ((1 - 2 * rc * ls) * sens + 2 * rc * ls * dc_sens - t3).contiguous()

            # update X (reference :160-238)
            ri, rf, li = self.reg_param_I[i], self.reg_param_F[i], self.lr_image[i]
            x1 = (1 - 2 * ri * li - 2 * rf * li) * image
            di = self.image_model(image, train)
            df = ifft2_rv(self.kspace_model(fft2_rv(image, c, n, sd), train), c, n, sd)
            x2 = 2 * li * (ri * di + rf * df)
            data = full_dc(image, y, sens, ind, 1.0, c, n, sd, self.coil_dim)[..., 2:] + sens_reduce(
                y, sens, off, c, n, sd, self.coil_dim)
            image = (x1 + x2 - 2 * li * data).contiguous()
        return ModelOutput(prediction=image)
