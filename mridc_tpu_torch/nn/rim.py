"""Recurrent Inference Machine block (counterpart of ``mridc_tpu/nn/rim.py``).

The JAX package scans the time steps with ``nn.scan``; here they are a Python
loop. Per step: the likelihood-gradient DC (K1 for ``psf1d``, K2 for ``full``)
-> replicate-padded conv -> IndRNN (K3) -> dilated conv -> IndRNN -> conv to
2 channels -> ``eta += dx``.

Layout: the estimate ``eta`` is [B, H, W, 2]; the DC output [B, H, W, 4] is
used as the NCHW channels_last tensor it already is physically, so the conv/RNN
stack runs channels-last with no transposes. Hidden states are NCHW
channels_last inside and NHWC ``[B, H, W, F]`` at the public boundary
(``hx``/``return_hx``), as in the JAX package.

Step rematerialisation (``remat`` True or "step", when autograd records): each
step's conv/RNN stack runs under ``torch.utils.checkpoint`` with the DC output
as an input, computed outside the checkpointed region, so the backward's
recompute skips the DC as the JAX package's ``save_only_these_names("dc_grad")``
policy does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mridc_tpu_torch.kernels.k2_full_dc import full_dc, sens_expand, sens_reduce
from mridc_tpu_torch.kernels.k1_psf1d_dc import psf1d_dc
from mridc_tpu_torch.nn.dc import psf1d_gauss_mats, soft_dc
from mridc_tpu_torch.nn.layers import ConvNonlinear, as_torch_dtype
from mridc_tpu_torch.nn.rnn_cells import make_cell

__all__ = ["RIMBlock", "ConvRNNStack"]

_NONLINEARS = ("relu", "relu", None)
_OWN = object()  # RIMBlock.forward's dtype arguments: the block's own setting


class ConvRNNStack(nn.Module):
    """One conv + recurrent cell layer (reference ``rim/conv_layers.py`` naming:
    ``convs`` and ``rnn``)."""

    def __init__(self, convs: nn.Module, rnn: nn.Module):
        super().__init__()
        self.convs = convs
        self.rnn = rnn


class RIMBlock(nn.Module):
    """Cascade block: ``time_steps`` RIM updates, optional soft DC.

    ``remat`` (True or "step": checkpoint each step's conv/RNN stack when
    autograd records) changes memory, not values. ``scan_unroll`` and
    ``lane_fold`` are TPU-layout settings of the JAX package, accepted and
    ignored.
    """

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
        time_steps: int = 8,
        no_dc: bool = True,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        compute_dtype=None,
        remat=True,
        stack_etas: bool = True,
        dc_psf1d: bool = False,
        dc_dtype=None,
        eta_dtype=None,
        pointwise_matmul: bool = False,
        scan_unroll: int = 1,
        lane_fold: str = "never",
    ):
        super().__init__()
        del scan_unroll, lane_fold
        self.remat_step = remat is True or remat == "step"
        self.time_steps = time_steps
        self.no_dc = no_dc
        self.fft_centered = fft_centered
        self.fft_normalization = fft_normalization
        self.spatial_dims = tuple(spatial_dims)
        self.coil_dim = coil_dim
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.stack_etas = stack_etas
        self.dc_psf1d = dc_psf1d
        self.dc_dtype = as_torch_dtype(dc_dtype)
        self.eta_dtype = as_torch_dtype(eta_dtype)
        self.recurrent_filters = [f for f in recurrent_filters if f != 0]

        layers, final, in_ch = [], None, 4
        for cf, ck, cd, cb, rf, rk, rd, rb, nl in zip(
            conv_filters, conv_kernels, conv_dilations, conv_bias,
            recurrent_filters, recurrent_kernels, recurrent_dilations, recurrent_bias, _NONLINEARS,
        ):
            conv = ConvNonlinear(in_ch, cf, ck, cd, cb, nl, dtype=self.compute_dtype) if cf != 0 else None
            if rf != 0 and nl is not None:
                cell = make_cell(recurrent_layer, cf, rf, rk, rd, rb, dtype=self.compute_dtype,
                                 pointwise_matmul=pointwise_matmul)
                layers.append(ConvRNNStack(conv, cell))
                in_ch = rf
            else:
                final = conv
        self.layers = nn.ModuleList(layers)
        self.final_layer = nn.ModuleList([final])
        if not no_dc:
            self.dc_weight = nn.Parameter(torch.ones(1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.layers:
            layer.convs.reset_parameters(generator)
            layer.rnn.reset_parameters(generator)
        self.final_layer[0].reset_parameters(generator)
        if not self.no_dc:
            nn.init.ones_(self.dc_weight)

    def _sens_reduce(self, kspace, sens, mask=None):
        return sens_reduce(kspace, sens, mask, self.fft_centered, self.fft_normalization,
                           self.spatial_dims, self.coil_dim)

    def _step(self, x, eta, *hx):
        """One time step's conv/RNN stack on the DC output ``x`` [B, H, W, 4]:
        returns (eta + dx, new hidden states...)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x.permute(0, 3, 1, 2)  # [B, H, W, 4] -> NCHW channels_last view
        new_hx = []
        for layer, h_ in zip(self.layers, hx):
            x = layer.rnn(layer.convs(x), h_).to(h_.dtype)
            new_hx.append(x)
        dx = self.final_layer[0](x)
        return (eta + dx.permute(0, 2, 3, 1).to(eta.dtype), *new_hx)

    def forward(
        self,
        y: torch.Tensor,
        sens: torch.Tensor,
        mask: torch.Tensor,
        eta: Optional[torch.Tensor] = None,
        sigma: float = 1.0,
        hx: Optional[Tuple[torch.Tensor, ...]] = None,
        return_hx: bool = False,
        dc_dtype=_OWN,
        eta_dtype=_OWN,
    ):
        """Returns (etas [T, B, H, W, 2] or None, final eta [B, H, W, 2]), plus
        the final hidden states (NHWC) when ``return_hx``. ``dc_dtype`` and
        ``eta_dtype`` override the block's own (CIRIM passes its train or
        inference settings)."""
        dc_dtype = self.dc_dtype if dc_dtype is _OWN else as_torch_dtype(dc_dtype)
        eta_dtype = self.eta_dtype if eta_dtype is _OWN else as_torch_dtype(eta_dtype)
        if eta is None:
            eta = self._sens_reduce(y, sens)
        if eta_dtype is not None:
            eta = eta.to(eta_dtype)
        b, h, w = eta.shape[0], eta.shape[1], eta.shape[2]
        hx_dtype = self.compute_dtype or torch.float32
        if hx is None:
            hx = [torch.zeros(b, h, w, f, dtype=hx_dtype, device=eta.device) for f in self.recurrent_filters]
        else:
            hx = [h_.to(hx_dtype).contiguous() for h_ in hx]
        hx = [h_.permute(0, 3, 1, 2) for h_ in hx]  # NHWC -> NCHW channels_last view

        if self.dc_psf1d:
            # a 1D mask's rows are identical, so row 0 defines the operator; the
            # operator and the data term are built once per block, not per step
            mats = psf1d_gauss_mats(mask[:, 0, 0, :], self.fft_centered, self.fft_normalization)
            z0 = self._sens_reduce(y, sens, mask)
            sens_dc = sens
            if dc_dtype is not None:
                sens_dc, mats, z0 = sens.to(dc_dtype), mats.to(dc_dtype), z0.to(dc_dtype)

        remat = self.remat_step and torch.is_grad_enabled()
        etas = []
        for _ in range(self.time_steps):
            # the DC kernels take one dtype: eta in the DC's (the JAX package
            # promotes a bf16 eta to the float32 of the maps)
            if self.dc_psf1d:
                x = psf1d_dc(eta.to(dc_dtype or torch.float32), sens_dc, mats, z0, sigma)
            else:
                x = full_dc(eta.float(), y, sens, mask, sigma, self.fft_centered, self.fft_normalization,
                            self.spatial_dims, self.coil_dim)
            if remat:
                eta, *hx = checkpoint(self._step, x, eta, *hx, use_reentrant=False, preserve_rng_state=False)
            else:
                eta, *hx = self._step(x, eta, *hx)
            if self.stack_etas:
                etas.append(eta)
        etas = torch.stack(etas) if self.stack_etas else None
        hx_out = tuple(h_.permute(0, 2, 3, 1) for h_ in hx)

        if not self.no_dc:
            # soft DC: project the estimate back to k-space with a learned weight
            pred_k = sens_expand(eta, sens, self.fft_centered, self.fft_normalization)
            current_kspace = y - soft_dc(pred_k, y, mask, self.dc_weight) - pred_k
            eta = self._sens_reduce(current_kspace.contiguous(), sens)
        if return_hx:
            return etas, eta, hx_out
        return etas, eta
