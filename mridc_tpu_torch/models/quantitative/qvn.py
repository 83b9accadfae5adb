"""qVarNet: a variational network in quantitative-map space (counterpart of
``mridc_tpu/models/quantitative/qvn.py``).

``map_threading: complex`` (the default, the reference graph): complex maps
are threaded between cascades. Per cascade the un-normalised complex maps go
through the complex MEGRE model; the soft DC ``w_i (M F S p_e - M y_e)`` runs
on K2's masked ``sens_expand`` on one row per echo (M y once per forward);
``conj(S) F^-1(.)`` is summed over the ECHO axis, keeping the coils as the
regulariser's channels (the JAX package's pinned reading of the reference,
``tests/test_golden_qvn.py``): by linearity the echoes are summed before one
inverse FFT per coil. A NormUnet (``in_chans`` 2C in torch's
``complex_to_chan_dim`` order, out 8 in ``chan_complex_to_last_dim`` order)
adds a complex residual to the previous cascade's magnitudes; R2*'s real and
imaginary parts are clamped at 0. The final maps are |maps| * gamma.

``map_threading: real``: real 4-channel maps, the echo residuals of the plain
SENSE reduction (K2's ``normal_op`` on one row per echo, as qCIRIM's) stacked
into the regulariser's 2E channels, 4 out.

With ``use_reconstruction_module`` one set of VarNet blocks (``recon.{j}``,
flax's ``_VarNetBlock_{j}``) serves every echo, y is replaced by the SENSE
expansion of the reconstructed echoes and the maps are re-fitted from them.

The regularisers' input width depends on the data (2C coils or 2E echoes), as
flax infers it at ``init``: the ``regs`` are built by :meth:`materialize`
(``QuantitativeTrainer.init_state`` calls it with its first batch), by
``load_state_dict`` from the weights' shapes, or at the first forward, from
the generator the model was built with.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import normal_op, sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn
from mridc_tpu_torch.models.quantitative.qcirim import DEFAULT_TES
from mridc_tpu_torch.models.quantitative.signal_model import (echo_rows, echo_rows_mask, first_echo_mask,
                                                              fit_megre_maps, megre_signal, megre_signal_complex)
from mridc_tpu_torch.models.recon.vn import VarNetBlock
from mridc_tpu_torch.nn.dc import soft_dc
from mridc_tpu_torch.nn.unet import NormUnet
from mridc_tpu_torch.ops.cplx import cmul_conj
from mridc_tpu_torch.ops.fft import ifft2_rv

__all__ = ["qVarNet", "BF16_REFUSAL", "FIRST_CONV"]

BF16_REFUSAL = (
    "compute_dtype=bfloat16 is NOT certified for qVarNet: the 150-600x gamma_regularization_factors amplify bf16 "
    "rounding through the MEGRE exponentials (measured: tools/dtype_cert.py). Use f32 (drop compute_dtype), or "
    "accept uncertified outputs explicitly with quantitative_module_allow_bf16: true"
)
FIRST_CONV = "regs.0.unet.down_sample_layers.0.layers.0.weight"  # its in-channels are the data's width


def _safe_cmag(x: torch.Tensor) -> torch.Tensor:
    """|x| over a real view [..., 2] with gradient 0 at 0 (where the plain
    sqrt's is NaN; the R2* clamp makes such zeros)."""
    sq = x[..., 0] ** 2 + x[..., 1] ** 2
    zero = sq == 0
    return torch.where(zero, torch.zeros((), dtype=sq.dtype, device=sq.device),
                       torch.sqrt(torch.where(zero, torch.ones((), dtype=sq.dtype, device=sq.device), sq)))


class qVarNet(BaseReconModel):
    """``forward(y, sens, sampling_mask, maps_init, tes, train=False)`` as
    :class:`~mridc_tpu_torch.models.quantitative.qcirim.qCIRIM`'s; the
    prediction is [B, H, W, 4] and, with complex threading, intermediates the
    last cascade's complex maps [B, 4, H, W, 2]."""

    def __init__(
        self,
        num_cascades: int = 8,
        channels: int = 18,
        pooling_layers: int = 4,
        padding_size: int = 11,
        normalize: bool = True,
        gamma: Sequence[float] = (150.0, 150.0, 600.0, 150.0),
        map_threading: str = "complex",
        use_reconstruction_module: bool = False,
        recon_num_cascades: int = 8,
        recon_channels: int = 18,
        recon_pooling_layers: int = 4,
        recon_no_dc: bool = False,
        num_echoes: int = len(DEFAULT_TES),
        compute_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        if map_threading not in ("complex", "real"):
            raise ValueError(f"quantitative_module_map_threading must be 'complex' or 'real', got {map_threading!r}")
        self.gamma = tuple(float(g) for g in gamma)
        self.map_threading = map_threading
        self.use_reconstruction_module = use_reconstruction_module
        self.recon_no_dc = recon_no_dc
        self.num_cascades = num_cascades
        self._reg_cfg = dict(chans=channels, num_pools=pooling_layers, out_chans=8 if map_threading == "complex"
                             else 4, padding_size=padding_size, normalize=normalize, dtype=compute_dtype)
        self.recon = nn.ModuleList()
        if use_reconstruction_module:  # flax creates the shared blocks first
            self.recon.extend([
                drawn(lambda: VarNetBlock(recon_channels, recon_pooling_layers, 11, True, compute_dtype), generator)
                for _ in range(recon_num_cascades)
            ])
        self.dc_weights = nn.ParameterList([nn.Parameter(torch.ones(1)) for _ in range(num_cascades)])
        self.regs = nn.ModuleList()
        self._generator_state = None if generator is None else generator.get_state()
        if map_threading == "real":
            self.materialize(2 * num_echoes)
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        g = lambda k, d: cfg.get(f"quantitative_module_{k}", d)  # noqa: E731
        r = lambda k, d: cfg.get(f"reconstruction_module_{k}", d)  # noqa: E731
        threading = str(g("map_threading", "complex")).lower()
        dtype = cfg.get("compute_dtype")
        if dtype and "bf" in str(dtype).lower() and not cfg.get("quantitative_module_allow_bf16", False):
            raise ValueError(BF16_REFUSAL)
        return cls(
            compute_dtype=dtype,
            use_reconstruction_module=bool(cfg.get("use_reconstruction_module", False)),
            recon_num_cascades=r("num_cascades", 8),
            recon_channels=r("channels", 18),
            recon_pooling_layers=r("pooling_layers", 4),
            recon_no_dc=bool(r("no_dc", False)),
            num_echoes=len(cfg.get("TEs") or DEFAULT_TES),
            num_cascades=g("num_cascades", 8),
            channels=g("channels", 18),
            pooling_layers=g("pooling_layers", 4),
            padding_size=g("padding_size", 11),
            normalize=g("normalize", True),
            gamma=tuple(g("gamma_regularization_factors", (150.0, 150.0, 600.0, 150.0))),
            map_threading=threading,
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    # ---- the regularisers, built at the data's width ----

    def input_channels(self, kspace_shape) -> int:
        """The regulariser's input width for k-space of ``kspace_shape`` [B,
        E, C, H, W, 2]: 2C with complex threading, 2E with real."""
        return 2 * int(kspace_shape[2 if self.map_threading == "complex" else 1])

    @property
    def materialized(self) -> bool:
        return len(self.regs) == self.num_cascades

    def materialize(self, in_chans: int, device=None) -> None:
        """Build the regularisers for ``in_chans`` input channels (weights
        from the build's generator, on ``device`` or the CPU); a built model
        checks the width instead."""
        if self.materialized:
            have = self.regs[0].unet.down_sample_layers[0].layers[0].weight.shape[1]
            if have != in_chans:
                raise ValueError(f"qVarNet's regularisers take {have} channels, the data gives {in_chans}")
            return
        generator = None
        if self._generator_state is not None:
            generator = torch.Generator()
            generator.set_state(self._generator_state)
        cfg = dict(self._reg_cfg, in_chans=in_chans)
        regs = [drawn(lambda: NormUnet(**cfg), generator) for _ in range(self.num_cascades)]
        self.regs.extend([reg.to(device=device, memory_format=torch.channels_last) for reg in regs])

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        if not self.materialized and FIRST_CONV in state_dict:
            self.materialize(int(state_dict[FIRST_CONV].shape[1]), self.dc_weights[0].device)
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    # ---- the forward ----

    def _recon_module(self, y, sens, mask4, train: bool):
        """The shared VarNet blocks on each echo's k-space -> the SENSE images
        of the echoes [B, E, H, W, 2]."""
        c, n = self.fft_centered, self.fft_normalization
        echo_preds = []
        for e in range(y.shape[1]):
            y_e = y[:, e].contiguous()
            pred = y_e
            for block in self.recon:
                model_term = sens_expand(block.model(sens_reduce(pred, sens, None, c, n), train), sens, c, n)
                pred = model_term if self.recon_no_dc else pred - soft_dc(pred, y_e, mask4, block.dc_weight) \
                    - model_term
            echo_preds.append(sens_reduce(pred, sens, None, c, n))
        return torch.stack(echo_preds, dim=1)

    def forward(self, y, sens, sampling_mask, maps_init, tes, train: bool = False) -> ModelOutput:
        y, sens = y.contiguous(), sens.contiguous()
        b, e, coils, h, w, _ = y.shape
        c, n = self.fft_centered, self.fft_normalization
        self.materialize(self.input_channels(y.shape), y.device)
        gamma = torch.tensor(self.gamma, dtype=torch.float32, device=y.device)
        sens_be = echo_rows(sens, e)
        mask_be = echo_rows_mask(sampling_mask, b, e, h, w)
        if self.use_reconstruction_module:
            pred_img = self._recon_module(y, sens, first_echo_mask(sampling_mask), train)
            # y <- F(S pred); the DC reads only M y: the masked expansion
            masked_y = sens_expand(pred_img.reshape(b * e, h, w, 2), sens_be, c, n, mask=mask_be)
            maps_init = fit_megre_maps(pred_img, tes)
        else:
            masked_y = y.reshape(b * e, coils, h, w, 2) * mask_be[..., None]
        if self.map_threading != "complex":
            return self._real_cascades(masked_y, sens_be, mask_be, maps_init, tes, gamma, train, (b, e))

        maps_n = maps_init.float() / gamma
        maps_cv = torch.stack([maps_n, torch.zeros_like(maps_n)], dim=-1)  # [B, H, W, 4, 2]
        running_pred = maps_n.permute(0, 3, 1, 2)[..., None] * torch.tensor([1.0, 0.0], device=y.device)
        zero = torch.zeros((), dtype=torch.float32, device=y.device)
        final_pred = None
        for i, unet in enumerate(self.regs):
            scaled = maps_cv * gamma[:, None]
            pred = megre_signal_complex(scaled[..., 0, :], scaled[..., 1, :], scaled[..., 2, :], scaled[..., 3, :],
                                        tes)
            soft = (sens_expand(pred.reshape(b * e, h, w, 2), sens_be, c, n, mask=mask_be) - masked_y) \
                * self.dc_weights[i]
            # sum_e conj(S) F^-1(soft_e) = conj(S) F^-1(sum_e soft_e): over the echoes
            resid = cmul_conj(ifft2_rv(soft.reshape(b, e, coils, h, w, 2).sum(dim=1), c, n), sens)
            # torch complex_to_chan_dim: [re_c0..re_cN, im_c0..im_cN]
            reg_in = resid.permute(0, 4, 1, 2, 3).reshape(b, 2 * coils, h, w).permute(0, 2, 3, 1)
            out = unet(reg_in, train)  # [B, H, W, 8]
            # chan_complex_to_last_dim: [B, 2*4, H, W] -> [B, 4, H, W, 2]
            upd = out.permute(0, 3, 1, 2).reshape(b, 2, 4, h, w).permute(0, 2, 3, 4, 1)
            new_pred = running_pred + upd
            new_pred = torch.cat([torch.maximum(new_pred[:, :1], zero), new_pred[:, 1:]], dim=1)
            final_pred = new_pred
            maps_cv = new_pred.permute(0, 2, 3, 1, 4)
            mag = _safe_cmag(new_pred)
            running_pred = torch.stack([mag, torch.zeros_like(mag)], dim=-1)
        final = _safe_cmag(final_pred).permute(0, 2, 3, 1) * gamma
        return ModelOutput(prediction=final, intermediates=final_pred)

    def _real_cascades(self, masked_y, sens_be, mask_be, maps_init, tes, gamma, train, be):
        """Real 4-channel maps, the echo residuals stacked into the regulariser."""
        b, e = be
        c, n = self.fft_centered, self.fft_normalization
        h, w = masked_y.shape[2:4]
        x0 = sens_reduce(masked_y, sens_be, None, c, n)
        zero = torch.zeros((), dtype=torch.float32, device=masked_y.device)
        maps = maps_init.float() / gamma
        for i, unet in enumerate(self.regs):
            un = maps * gamma
            pred = megre_signal(un[..., 0], un[..., 1], un[..., 2], un[..., 3], tes)
            resid = (normal_op(pred.reshape(b * e, h, w, 2), sens_be, mask_be, 0.0, c, n) - x0) * self.dc_weights[i]
            reg_in = resid.reshape(b, e, h, w, 2).permute(0, 2, 3, 1, 4).reshape(b, h, w, 2 * e)
            maps = maps + unet(reg_in, train)
            maps = torch.cat([torch.maximum(maps[..., :1], zero), maps[..., 1:]], dim=-1)
        return ModelOutput(prediction=maps * gamma)
