"""Down-up network with a selectable data-consistency term (counterpart of
``mridc_tpu/models/recon/dunet.py``): from the SENSE image (or a loader's
initial prediction), ``num_iter`` times ``x <- x + reg_i(x)`` (each
iteration its own regulariser), then the DC term:

- ``GD``: ``x <- x - lambda_i E^H M (E x - y)``, the gradient one K2
  :func:`full_dc` call (expand, cuFFT, masked residual, inverse cuFFT,
  reduce; its backward the same chain without y);
- ``PROX``: the conjugate-gradient solve of ``(E^H M E + I / lambda_i) u =
  (lambda_i E^H M y + x) / lambda_i`` on K2's :func:`normal_op` (lambda
  clamped at 1e-8; ``E^H M y`` is the same at every iteration and is reduced
  once);
- ``VS``: ``x <- b_i x + (1 - b_i) sens_reduce((1 - m) E x + m (a_i E x +
  (1 - a_i) y))``;
- ``ID``: no data consistency.

Module names: ``regs.{i}`` (DIDN or NormUnet), ``lambdas.{i}`` (GD, PROX),
``alphas.{i}`` and ``betas.{i}`` (VS).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import full_dc, sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.models.recon.resnet import conjugate_gradient
from mridc_tpu_torch.nn.didn import DIDN
from mridc_tpu_torch.nn.unet import NormUnet

__all__ = ["DUNet"]

DC_TERMS = ("ID", "GD", "PROX", "VS")


class DUNet(BaseReconModel):
    """Config fields and defaults as in the JAX package (``cfg`` holds the
    regulariser's keys)."""

    def __init__(
        self,
        num_iter: int = 10,
        reg_arch: str = "DIDN",
        data_consistency_term: str = "GD",
        data_consistency_lambda_init: float = 0.1,
        data_consistency_iterations: int = 10,
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
        if data_consistency_term not in DC_TERMS:
            raise ValueError(f"DUNet data_consistency_term must be one of {DC_TERMS}, got {data_consistency_term!r}")
        self.term = data_consistency_term
        self.data_consistency_iterations = data_consistency_iterations
        dt = cfg.get("compute_dtype")

        def reg():
            if reg_arch == "DIDN":
                return DIDN(2, 2, cfg.get("didn_hidden_channels", 64), cfg.get("didn_num_dubs", 2),
                            cfg.get("didn_num_convs_recon", 3), dtype=dt)
            return NormUnet(cfg.get("unet_num_filters", 16), cfg.get("unet_num_pool_layers", 2),
                            padding_size=cfg.get("unet_padding_size", 11), normalize=cfg.get("unet_normalize", True),
                            dtype=dt)

        self.regs = nn.ModuleList([drawn(reg, generator) for _ in range(num_iter)])

        def weights(value):
            return nn.ParameterList([nn.Parameter(torch.full((1,), float(value))) for _ in range(num_iter)])

        self.lambdas = weights(data_consistency_lambda_init) if self.term in ("GD", "PROX") else None
        self.alphas = weights(1.0) if self.term == "VS" else None
        self.betas = weights(1.0) if self.term == "VS" else None
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            num_iter=cfg.get("num_iter", 10),
            reg_arch=str(cfg.get("reg_model_architecture", "DIDN")).upper(),
            data_consistency_term=str(cfg.get("data_consistency_term", "GD")).upper(),
            data_consistency_lambda_init=cfg.get("data_consistency_lambda_init", 0.1),
            data_consistency_iterations=cfg.get("data_consistency_iterations", 10),
            cfg=dict(cfg),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del train
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        c, n, sd, cd = self.fft_centered, self.fft_normalization, self.spatial_dims, self.coil_dim
        m = mask[..., None]
        x = init_pred if init_pred is not None and init_pred.ndim >= 4 else self.sense_init(y, sens)
        y_img = sens_reduce(y, sens, mask, c, n, sd, cd) if self.term == "PROX" else None
        for i, reg in enumerate(self.regs):
            x = x + reg(x)
            if self.term == "GD":
                x = x - self.lambdas[i] * full_dc(x, y, sens, mask, 1.0, c, n, sd, cd)[..., 2:]
            elif self.term == "PROX":
                lam = self.lambdas[i]
                lam_c = torch.clamp(lam, min=1e-8)
                x = conjugate_gradient((lam * y_img + x) / lam_c, sens, mask, 1.0 / lam_c,
                                       self.data_consistency_iterations, c, n, sd, cd)
            elif self.term == "VS":
                ax = sens_expand(x, sens, c, n)
                a, b = self.alphas[i], self.betas[i]
                x = b * x + (1 - b) * sens_reduce((1 - m) * ax + m * (a * ax + (1 - a) * y), sens, None, c, n, sd, cd)
        return ModelOutput(prediction=x)
