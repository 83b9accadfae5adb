"""Cascades of Independently Recurrent Inference Machines — the flagship model
(counterpart of ``mridc_tpu/models/recon/cirim.py``), inference and training
forward.

Cascades are separate-weight :class:`RIMBlock` s in a ``ModuleList`` named
``cirim``, so the state-dict keys are the reference torch ones
(``cirim.{i}.layers.{h}...``) and :func:`mridc_tpu.utils.torch_import.import_cirim_params`
reads them as they are. Hidden states reset per cascade.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, check_dc_mode, expand_mask
from mridc_tpu_torch.nn.layers import as_torch_dtype
from mridc_tpu_torch.nn.rim import RIMBlock

__all__ = ["CIRIM"]

_REMAT_MODES = ("step+cascade", "cascade", "step", "none")


class CIRIM(BaseReconModel):
    """Config fields and defaults as in the JAX package.

    ``forward(..., train=True)`` runs the DC in ``train_dc_dtype`` and carries
    the estimate in ``train_eta_dtype``; otherwise the DC runs in
    ``infer_dc_dtype``. ``remat_mode`` maps to ``torch.utils.checkpoint`` when
    autograd records: "step" checkpoints each time step's conv/RNN stack (the
    DC stays outside, as the JAX policy saves ``dc_grad``), "cascade" each
    cascade, "step+cascade" both, "none" neither. ``remat_save_dc`` (keep the
    DC outputs across the cascade recompute) changes memory only and is
    ignored: the cascade recompute runs the DC again. ``scan_unroll``,
    ``lane_fold``, ``depth`` and ``train_pointwise_matmul`` shape the TPU
    layout and are accepted and ignored."""

    def __init__(
        self,
        recurrent_layer: str = "IndRNN",
        conv_filters: Sequence[int] = (64, 64, 2),
        conv_kernels: Sequence[int] = (5, 3, 3),
        conv_dilations: Sequence[int] = (1, 2, 1),
        conv_bias: Sequence[bool] = (True, True, False),
        recurrent_filters: Sequence[int] = (64, 64, 0),
        recurrent_kernels: Sequence[int] = (1, 1, 0),
        recurrent_dilations: Sequence[int] = (1, 1, 0),
        recurrent_bias: Sequence[bool] = (True, True, False),
        depth: int = 2,
        time_steps: int = 8,
        num_cascades: int = 5,
        no_dc: bool = True,
        keep_prediction: bool = True,
        compute_dtype=None,
        stack_intermediates: bool = True,
        lane_fold: str = "auto",
        dc_mode: str = "full",
        train_pointwise_matmul: bool = True,
        train_dc_dtype=None,
        train_eta_dtype=None,
        infer_dc_dtype=None,
        scan_unroll: int = 1,
        remat_mode: str = "step+cascade",
        remat_save_dc: bool = False,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        if remat_mode not in _REMAT_MODES:
            raise ValueError(f"remat_mode must be one of {' | '.join(map(repr, _REMAT_MODES))}, got {remat_mode!r}")
        del depth, lane_fold, train_pointwise_matmul, scan_unroll, remat_save_dc
        self.keep_prediction = keep_prediction
        self.stack_intermediates = stack_intermediates
        self.no_dc = no_dc
        self.train_dc_dtype = as_torch_dtype(train_dc_dtype)
        self.train_eta_dtype = as_torch_dtype(train_eta_dtype)
        self.infer_dc_dtype = as_torch_dtype(infer_dc_dtype)
        self.remat_cascade = "cascade" in remat_mode
        block_cfg = dict(
            recurrent_layer=recurrent_layer,
            conv_filters=tuple(conv_filters),
            conv_kernels=tuple(conv_kernels),
            conv_dilations=tuple(conv_dilations),
            conv_bias=tuple(conv_bias),
            recurrent_filters=tuple(recurrent_filters),
            recurrent_kernels=tuple(recurrent_kernels),
            recurrent_dilations=tuple(recurrent_dilations),
            recurrent_bias=tuple(recurrent_bias),
            time_steps=time_steps,
            no_dc=no_dc,
            fft_centered=fft_centered,
            fft_normalization=fft_normalization,
            spatial_dims=tuple(spatial_dims),
            coil_dim=coil_dim,
            compute_dtype=compute_dtype,
            stack_etas=stack_intermediates,
            dc_psf1d=check_dc_mode(dc_mode) == "psf1d",
            remat="step" if "step" in remat_mode else "none",
        )
        # built on the meta device and initialised from `generator` alone, so
        # construction draws nothing from the global random state
        with torch.device("meta"):
            self.cirim = nn.ModuleList([RIMBlock(**block_cfg) for _ in range(num_cascades)])
        self.cirim.to_empty(device="cpu")
        for block in self.cirim:
            block.reset_parameters(generator)
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        remat_mode = str(cfg.get("remat_mode", "step+cascade")).lower()
        return cls(
            recurrent_layer=cfg.get("recurrent_layer", "IndRNN"),
            conv_filters=tuple(cfg.get("conv_filters", (64, 64, 2))),
            conv_kernels=tuple(cfg.get("conv_kernels", (5, 3, 3))),
            conv_dilations=tuple(cfg.get("conv_dilations", (1, 2, 1))),
            conv_bias=tuple(cfg.get("conv_bias", (True, True, False))),
            recurrent_filters=tuple(cfg.get("recurrent_filters", (64, 64, 0))),
            recurrent_kernels=tuple(cfg.get("recurrent_kernels", (1, 1, 0))),
            recurrent_dilations=tuple(cfg.get("recurrent_dilations", (1, 1, 0))),
            recurrent_bias=tuple(cfg.get("recurrent_bias", (True, True, False))),
            depth=cfg.get("depth", 2),
            time_steps=int(cfg.get("time_steps", 8)),
            num_cascades=cfg.get("num_cascades", 5),
            no_dc=cfg.get("no_dc", True),
            keep_prediction=cfg.get("keep_prediction", cfg.get("keep_eta", True)),
            compute_dtype=cfg.get("compute_dtype", None),
            stack_intermediates=cfg.get("stack_intermediates", True),
            dc_mode=str(cfg.get("dc_mode", "full")).lower(),
            remat_mode=remat_mode,
            remat_save_dc=bool(cfg.get("remat_save_dc", False)),
            train_dc_dtype=cfg["train_dc_dtype"] if "train_dc_dtype" in cfg else cfg.get("compute_dtype"),
            train_pointwise_matmul=bool(cfg.get("train_pointwise_matmul", True)),
            train_eta_dtype=cfg.get("train_eta_dtype"),
            infer_dc_dtype=cfg["infer_dc_dtype"] if "infer_dc_dtype" in cfg else cfg.get("compute_dtype"),
            scan_unroll=int(cfg.get("scan_unroll", 1)),
            lane_fold=str(cfg.get("lane_fold", "auto")).lower(),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        y, sens = y.contiguous(), sens.contiguous()
        mask = expand_mask(mask)
        b, _, h, w, _ = y.shape
        mask = torch.broadcast_to(mask, (b, 1, h, w)).to(y.dtype).contiguous()
        dtypes = dict(dc_dtype=self.train_dc_dtype if train else self.infer_dc_dtype,
                      eta_dtype=self.train_eta_dtype if train else None)

        # chaining (reference rim_block.py / cirim.py): a given init_pred is the
        # start of EVERY cascade; otherwise cascade 0 starts from the SENSE init
        # and later ones from the previous final estimate, detached — unless
        # keep_prediction=False, which restarts each from the SENSE init
        have_init = init_pred is not None and init_pred.ndim >= 4
        eta0 = init_pred if have_init else self.sense_init(y, sens)
        if dtypes["eta_dtype"] is not None:
            eta0 = eta0.to(dtypes["eta_dtype"])
        keep = self.keep_prediction
        remat = self.remat_cascade and torch.is_grad_enabled()
        eta, intermediates, finals = eta0, [], []
        for block in self.cirim:
            run = functools.partial(block, y, sens, mask, **dtypes)
            if remat:
                etas, eta_final = checkpoint(run, eta, use_reentrant=False, preserve_rng_state=False)
            else:
                etas, eta_final = run(eta)
            intermediates.append(etas)
            finals.append(eta_final)
            if not (have_init or not keep):
                eta = eta_final.detach()
        if not self.stack_intermediates:
            return ModelOutput(prediction=finals[-1], intermediates=None)
        stacked = torch.stack(intermediates)  # [cascades, T, B, H, W, 2]
        return ModelOutput(prediction=stacked[-1, -1], intermediates=stacked)
