"""End-to-end Variational Network (counterpart of
``mridc_tpu/models/recon/vn.py``): cascades of (soft DC + NormUnet
regulariser) in k-space, each with its own weights and a learned DC weight.

Module names are the reference torch ones (``cascades.{i}.model.unet...``,
``cascades.{i}.dc_weight``), so ``mridc_tpu.utils.torch_import.import_varnet_params``
reads a port state dict as it is; both ``dc_mode`` s share it.

``dc_mode: full``: ``pred <- pred - soft_dc(pred, y, m, w) - sens_expand(
NormUnet(sens_reduce(pred)))``, then the coil combination of ``ifft2(pred)``.
The cascades mix k-space tensors elementwise only, so ``pred``, ``y`` and the
mask are held in the FFT's own order (:func:`to_fft_order`, once at entry):
each SENSE expansion and reduction then runs on K2's stages around cuFFT with
no shift pass, and the final SENSE combination reads that order too.

``dc_mode: psf1d`` (1D column masks, SENSE combination, soft DC): the
reduced-state recursion of the JAX package's module docstring. The state is
``(x, R, A, B)`` with ``x = x_y + R + B``, ``rho = sum_c |s_c|^2`` and the
q-term ``q = sum_c conj(s_c) C_w (s_c u)`` on K1 (:func:`psf1d_normal`), in
``dc_dtype``; the maps and the operator are cast once per forward. The last
cascade's q-term feeds only A, which no output reads, so it is not computed
(XLA drops it from the JAX package's graph too).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k1_psf1d_dc import psf1d_normal
from mridc_tpu_torch.kernels.k2_full_dc import from_fft_order, sens_expand, sens_reduce, to_fft_order
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, check_dc_mode, drawn, expand_mask
from mridc_tpu_torch.nn.dc import psf1d_gauss_mats, soft_dc
from mridc_tpu_torch.nn.layers import as_torch_dtype
from mridc_tpu_torch.nn.unet import NormUnet
from mridc_tpu_torch.ops.cplx import cabs2, ccombine
from mridc_tpu_torch.ops.fft import ifft2_rv

__all__ = ["VarNet", "VarNetBlock"]


class VarNetBlock(nn.Module):
    """One cascade's weights: the NormUnet regulariser ``model`` and the soft
    DC weight (initialised to one)."""

    def __init__(self, channels: int, pooling_layers: int, padding_size: int, normalize: bool, compute_dtype=None):
        super().__init__()
        self.model = NormUnet(channels, pooling_layers, padding_size=padding_size, normalize=normalize,
                              dtype=compute_dtype)
        self.dc_weight = nn.Parameter(torch.ones(1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.model.reset_parameters(generator)
        nn.init.ones_(self.dc_weight)


class VarNet(BaseReconModel):
    """Config fields and defaults as in the JAX package. ``train`` switches
    the NormUnets' dropout only (its probability is 0)."""

    def __init__(
        self,
        num_cascades: int = 8,
        channels: int = 18,
        pooling_layers: int = 4,
        padding_size: int = 11,
        normalize: bool = True,
        no_dc: bool = False,
        compute_dtype=None,
        dc_mode: str = "full",
        dc_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.no_dc = no_dc
        self.dc_mode = check_dc_mode(dc_mode)
        self.dc_dtype = as_torch_dtype(dc_dtype)
        self.cascades = nn.ModuleList([
            drawn(lambda: VarNetBlock(channels, pooling_layers, padding_size, normalize, compute_dtype), generator)
            for _ in range(num_cascades)
        ])
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        dc_mode = check_dc_mode(str(cfg.get("dc_mode", "full")).lower())
        no_dc = cfg.get("no_dc", False)
        comb = str(cfg.get("coil_combination_method", "SENSE")).upper()
        if dc_mode == "psf1d" and (no_dc or comb != "SENSE"):
            raise ValueError(
                "VarNet dc_mode=psf1d requires no_dc=false and "
                f"coil_combination_method=SENSE (got no_dc={no_dc}, {comb})"
            )
        return cls(
            num_cascades=cfg.get("num_cascades", 8),
            channels=cfg.get("channels", 18),
            pooling_layers=cfg.get("pooling_layers", 4),
            padding_size=cfg.get("padding_size", 11),
            normalize=cfg.get("normalize", True),
            no_dc=no_dc,
            compute_dtype=cfg.get("compute_dtype", None),
            dc_mode=dc_mode,
            dc_dtype=cfg.get("dc_dtype", None),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=comb,
            generator=generator,
        )

    def _psf1d(self, y, sens, mask, train: bool) -> torch.Tensor:
        b, _, h, w, _ = y.shape
        # 1D masks are constant along H: row 0 is the mask
        mats = psf1d_gauss_mats(torch.broadcast_to(mask, (b, 1, h, w))[:, 0, 0, :], self.fft_centered,
                                self.fft_normalization)
        x_y = self.sense_init(y, sens)
        rho = cabs2(sens).sum(dim=self.coil_dim)[..., None]
        dt = self.dc_dtype or torch.float32
        sens_dc, mats_dc = sens.to(dt), mats.to(dt)
        zero_dc = torch.zeros(x_y.shape, dtype=dt, device=x_y.device)
        x, run_r, run_a, run_b = x_y, *(torch.zeros_like(x_y),) * 3
        for i, block in enumerate(self.cascades):
            u = block.model(x, train)
            run_b = run_b - block.dc_weight * (run_a + run_b)
            if i < len(self.cascades) - 1:  # the last cascade's q-term reaches no output
                run_a = run_a - psf1d_normal(u.to(dt), sens_dc, mats_dc, zero_dc).float()
            run_r = run_r - rho * u
            x = x_y + run_r + run_b
        return x

    def _full(self, y, sens, mask, train: bool) -> torch.Tensor:
        c, n = self.fft_centered, self.fft_normalization
        y_f = to_fft_order(y, c)
        mask_f = torch.fft.ifftshift(mask, dim=(-2, -1)) if c else mask
        pred = y_f
        for block in self.cascades:
            image = block.model(sens_reduce(pred, sens, None, c, n, fft_order=True), train)
            model_term = sens_expand(image, sens, c, n, fft_order=True)
            pred = model_term if self.no_dc else pred - soft_dc(pred, y_f, mask_f, block.dc_weight) - model_term
        if self.coil_combination_method == "SENSE":
            return sens_reduce(pred, sens, None, c, n, fft_order=True)
        image = ifft2_rv(from_fft_order(pred, c), c, n, self.spatial_dims)
        return ccombine(image, sens, self.coil_combination_method, self.coil_dim)

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del init_pred
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        route = self._psf1d if self.dc_mode == "psf1d" else self._full
        return ModelOutput(prediction=route(y, sens, mask, train))
