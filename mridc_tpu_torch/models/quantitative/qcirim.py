"""qCIRIM / qRIM: quantitative recurrent inference machines (counterpart of
``mridc_tpu/models/quantitative/qcirim.py``).

Cascades of qRIM blocks over the 4 gamma-normalised maps [R2*, S0, B0, phi].
Each cascade computes the MEGRE likelihood gradient once, at its input maps
(K2's ``normal_op`` on one row per echo, ``signal_model.megre_gradient``),
then runs ``time_steps`` updates of a conv/IndRNN stack on ``[grad / 100,
maps]`` (8 channels): 5x5 replicate-padded conv to 64, IndRNN (K3), dilated
3x3 conv, IndRNN, 3x3 conv to 4 with no bias; R2* is clamped non-negative
after each step. ``remat_mode`` "step" (the default) checkpoints each step's
stack, with the gradient as an input, when autograd records; "none" does not.
``compute_dtype`` runs the convs and cells (and carries the hidden states) in
that dtype; the maps, the gradient and the clamp stay float32.

With ``use_reconstruction_module`` each echo first runs its own CIRIM
cascades (``RIMBlock`` s ``recon.{e * R + c}``, flax's ``RIMBlock_{e * R +
c}``; a later cascade starts from the previous final estimate, detached when
``reconstruction_module_keep_prediction``), y is replaced by the SENSE
expansion of the reconstructed echoes (K2's ``sens_expand``) and the maps are
re-fitted from them (``fit_megre_maps``). The number of echoes is
``len(TEs)`` of the config.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn
from mridc_tpu_torch.models.quantitative.signal_model import (echo_rows, first_echo_mask, fit_megre_maps,
                                                              megre_data_operands, megre_gradient)
from mridc_tpu_torch.nn.layers import ConvNonlinear, as_torch_dtype
from mridc_tpu_torch.nn.rim import ConvRNNStack, RIMBlock
from mridc_tpu_torch.nn.rnn_cells import make_cell

__all__ = ["qRIMBlock", "qCIRIM", "DEFAULT_TES"]

_NONLINEARS = ("relu", "relu", None)
DEFAULT_TES = (3.0, 11.5, 20.0, 28.5)


def _parse_qremat(mode) -> bool:
    mode_s = str(mode).lower()
    if mode is True or mode_s == "step":
        return True
    if mode is False or mode_s == "none":
        return False
    raise ValueError(f"qCIRIM remat_mode must be 'step' or 'none', got {mode!r}")


class qRIMBlock(nn.Module):
    """One cascade: the MEGRE gradient at the input maps, then ``time_steps``
    conv/RNN updates (``layers.{h}.convs``/``.rnn``, ``final_layer.0``: the
    names of :class:`~mridc_tpu_torch.nn.rim.RIMBlock`)."""

    def __init__(
        self,
        recurrent_layer: str = "IndRNN",
        conv_filters: Sequence[int] = (64, 64, 4),
        conv_kernels: Sequence[int] = (5, 3, 3),
        conv_dilations: Sequence[int] = (1, 2, 1),
        conv_bias: Sequence[bool] = (True, True, False),
        recurrent_filters: Sequence[int] = (64, 64, 0),
        recurrent_kernels: Sequence[int] = (1, 1, 0),
        recurrent_dilations: Sequence[int] = (1, 1, 0),
        recurrent_bias: Sequence[bool] = (True, True, False),
        time_steps: int = 8,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        compute_dtype=None,
        remat: bool = True,
    ):
        super().__init__()
        self.time_steps = time_steps
        self.fft_centered = fft_centered
        self.fft_normalization = fft_normalization
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.remat = remat
        self.recurrent_filters = [f for f in recurrent_filters if f != 0]
        layers, final, in_ch = [], None, 8
        for cf, ck, cd, cb, rf, rk, rd, rb, nl in zip(
            conv_filters, conv_kernels, conv_dilations, conv_bias,
            recurrent_filters, recurrent_kernels, recurrent_dilations, recurrent_bias, _NONLINEARS,
        ):
            conv = ConvNonlinear(in_ch, cf, ck, cd, cb, nl, dtype=self.compute_dtype) if cf != 0 else None
            if rf != 0 and nl is not None:
                layers.append(ConvRNNStack(conv, make_cell(recurrent_layer, cf, rf, rk, rd, rb,
                                                           dtype=self.compute_dtype)))
                in_ch = rf
            else:
                final = conv
        self.layers = nn.ModuleList(layers)
        self.final_layer = nn.ModuleList([final])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.layers:
            layer.convs.reset_parameters(generator)
            layer.rnn.reset_parameters(generator)
        self.final_layer[0].reset_parameters(generator)

    def _step(self, grad, maps, *hx):
        """One update: (maps + dx with R2* clamped, new hidden states...)."""
        x = torch.cat([grad, maps], dim=-1)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x.permute(0, 3, 1, 2)  # [B, H, W, 8] -> NCHW channels_last view
        new_hx = []
        for layer, h_ in zip(self.layers, hx):
            x = layer.rnn(layer.convs(x), h_).to(h_.dtype)
            new_hx.append(x)
        maps = maps + self.final_layer[0](x).permute(0, 2, 3, 1).to(maps.dtype)
        r2s = torch.maximum(maps[..., :1], torch.zeros((), dtype=maps.dtype, device=maps.device))
        return (torch.cat([r2s, maps[..., 1:]], dim=-1), *new_hx)

    def forward(self, maps, tes, gamma, operands):
        """``maps`` [B, H, W, 4] normalised, ``operands`` of
        ``megre_data_operands`` -> (the steps' maps [T, B, H, W, 4], the last)."""
        un = maps * gamma
        grad = megre_gradient(un[..., 0], un[..., 1], un[..., 2], un[..., 3], tes, *operands,
                              self.fft_centered, self.fft_normalization)
        grad = torch.nan_to_num(grad.permute(0, 2, 3, 1) / 100.0)
        b, h, w = maps.shape[:3]
        hx_dtype = self.compute_dtype or torch.float32
        hx = [torch.zeros(b, h, w, f, dtype=hx_dtype, device=maps.device).permute(0, 3, 1, 2)
              for f in self.recurrent_filters]
        remat = self.remat and torch.is_grad_enabled()
        steps = []
        for _ in range(self.time_steps):
            if remat:
                maps, *hx = checkpoint(self._step, grad, maps, *hx, use_reentrant=False, preserve_rng_state=False)
            else:
                maps, *hx = self._step(grad, maps, *hx)
            steps.append(maps)
        return torch.stack(steps), maps


class qCIRIM(BaseReconModel):
    """``forward(y, sens, sampling_mask, maps_init, tes, train=False)``: y
    [B, E, C, H, W, 2], sens [B, C, H, W, 2], the mask [B, 1, H, W] (or
    [B, E|1, 1, H, W, 1]), ``maps_init`` [B, H, W, 4], ``tes`` [E] ->
    prediction [B, H, W, 4] (unnormalised), intermediates [cascades, T, B, H,
    W, 4] (normalised), recon_intermediates [E, R, T, B, H, W, 2] with the
    reconstruction module. Config keys and defaults as in the JAX package."""

    def __init__(
        self,
        num_cascades: int = 5,
        time_steps: int = 8,
        recurrent_layer: str = "IndRNN",
        conv_filters: Sequence[int] = (64, 64, 4),
        conv_kernels: Sequence[int] = (5, 3, 3),
        conv_dilations: Sequence[int] = (1, 2, 1),
        conv_bias: Sequence[bool] = (True, True, False),
        recurrent_filters: Sequence[int] = (64, 64, 0),
        recurrent_kernels: Sequence[int] = (1, 1, 0),
        recurrent_dilations: Sequence[int] = (1, 1, 0),
        recurrent_bias: Sequence[bool] = (True, True, False),
        gamma: Sequence[float] = (150.0, 150.0, 600.0, 150.0),
        use_reconstruction_module: bool = False,
        recon_num_cascades: int = 5,
        recon_time_steps: int = 8,
        recon_recurrent_layer: str = "IndRNN",
        recon_conv_filters: Sequence[int] = (64, 64, 2),
        recon_recurrent_filters: Sequence[int] = (64, 64, 0),
        recon_keep_prediction: bool = True,
        num_echoes: int = len(DEFAULT_TES),
        compute_dtype=None,
        remat: bool = True,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.gamma = tuple(float(g) for g in gamma)
        self.use_reconstruction_module = use_reconstruction_module
        self.recon_num_cascades = recon_num_cascades
        self.recon_keep_prediction = recon_keep_prediction
        self.num_echoes = num_echoes
        block_cfg = dict(
            recurrent_layer=recurrent_layer, conv_filters=tuple(conv_filters), conv_kernels=tuple(conv_kernels),
            conv_dilations=tuple(conv_dilations), conv_bias=tuple(conv_bias),
            recurrent_filters=tuple(recurrent_filters), recurrent_kernels=tuple(recurrent_kernels),
            recurrent_dilations=tuple(recurrent_dilations), recurrent_bias=tuple(recurrent_bias),
            time_steps=time_steps, fft_centered=fft_centered, fft_normalization=fft_normalization,
            compute_dtype=compute_dtype, remat=remat,
        )
        # flax creates the reconstruction module's blocks first
        self.recon = nn.ModuleList()
        if use_reconstruction_module:
            recon_cfg = dict(
                recurrent_layer=recon_recurrent_layer, conv_filters=tuple(recon_conv_filters),
                recurrent_filters=tuple(recon_recurrent_filters), time_steps=recon_time_steps,
                fft_centered=fft_centered, fft_normalization=fft_normalization, compute_dtype=compute_dtype,
            )
            for _ in range(num_echoes * recon_num_cascades):
                self.recon.append(drawn(lambda: RIMBlock(**recon_cfg), generator))
        self.qrim = nn.ModuleList([drawn(lambda: qRIMBlock(**block_cfg), generator) for _ in range(num_cascades)])
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        g = lambda k, d: cfg.get(f"quantitative_module_{k}", d)  # noqa: E731
        r = lambda k, d: cfg.get(f"reconstruction_module_{k}", d)  # noqa: E731
        return cls(
            compute_dtype=cfg.get("compute_dtype"),
            use_reconstruction_module=bool(cfg.get("use_reconstruction_module", False)),
            recon_num_cascades=r("num_cascades", 5),
            recon_time_steps=r("time_steps", 8),
            recon_recurrent_layer=r("recurrent_layer", "IndRNN"),
            recon_conv_filters=tuple(r("conv_filters", (64, 64, 2))),
            recon_recurrent_filters=tuple(r("recurrent_filters", (64, 64, 0))),
            recon_keep_prediction=bool(r("keep_prediction", True)),
            num_echoes=len(cfg.get("TEs") or DEFAULT_TES),
            num_cascades=g("num_cascades", 5),
            time_steps=g("time_steps", 8),
            recurrent_layer=g("recurrent_layer", "IndRNN"),
            conv_filters=tuple(g("conv_filters", (64, 64, 4))),
            conv_kernels=tuple(g("conv_kernels", (5, 3, 3))),
            conv_dilations=tuple(g("conv_dilations", (1, 2, 1))),
            conv_bias=tuple(g("conv_bias", (True, True, False))),
            recurrent_filters=tuple(g("recurrent_filters", (64, 64, 0))),
            recurrent_kernels=tuple(g("recurrent_kernels", (1, 1, 0))),
            recurrent_dilations=tuple(g("recurrent_dilations", (1, 1, 0))),
            recurrent_bias=tuple(g("recurrent_bias", (True, True, False))),
            gamma=tuple(g("gamma_regularization_factors", (150.0, 150.0, 600.0, 150.0))),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            remat=_parse_qremat(cfg.get("remat_mode", "step")),
            generator=generator,
        )

    def _reconstruct(self, y, sens, mask4):
        """The per-echo CIRIM: (echo images [B, E, H, W, 2], the stack of the
        cascades' steps [E, R, T, B, H, W, 2])."""
        e_count, r_count = y.shape[1], self.recon_num_cascades
        if e_count != self.num_echoes:
            raise ValueError(f"qCIRIM's reconstruction module was built for {self.num_echoes} echoes (len(TEs)), "
                             f"got k-space of {e_count}")
        echo_preds, recon_inter = [], []
        for e in range(e_count):
            y_e = y[:, e].contiguous()
            eta, casc_etas = None, []
            for c in range(r_count):
                etas, eta_final = self.recon[e * r_count + c](y_e, sens, mask4, eta=eta)
                casc_etas.append(etas)
                eta = eta_final.detach() if self.recon_keep_prediction else None
            echo_preds.append(eta_final)
            recon_inter.append(torch.stack(casc_etas))
        return torch.stack(echo_preds, dim=1), torch.stack(recon_inter)

    def forward(self, y, sens, sampling_mask, maps_init, tes, train: bool = False) -> ModelOutput:
        del train
        y, sens = y.contiguous(), sens.contiguous()
        b, e, _, h, w, _ = y.shape
        sens_be = None
        gamma = torch.tensor(self.gamma, dtype=torch.float32, device=y.device)
        c, n = self.fft_centered, self.fft_normalization
        recon_intermediates = None
        if self.use_reconstruction_module:
            pred, recon_intermediates = self._reconstruct(y, sens, first_echo_mask(sampling_mask))
            # y <- F(S pred): the expansion of the reconstructed echoes, one row per echo
            sens_be = echo_rows(sens, e)
            y = sens_expand(pred.reshape(b * e, h, w, 2), sens_be, c, n).reshape(y.shape)
            maps_init = fit_megre_maps(pred, tes)
        operands = megre_data_operands(y, sens, sampling_mask, c, n, sens_be)
        maps = maps_init.float() / gamma
        all_casc = []
        for block in self.qrim:
            steps, maps = block(maps, tes, gamma, operands)
            all_casc.append(steps)
        intermediates = torch.stack(all_casc)  # [cascades, T, B, H, W, 4]
        return ModelOutput(prediction=intermediates[-1, -1] * gamma, intermediates=intermediates,
                           recon_intermediates=recon_intermediates)
