"""Convolutional recurrent cells for RIM-family models (counterpart of
``mridc_tpu/nn/rnn_cells.py``), NCHW in channels_last memory format.

Input-to-hidden conv ``ih`` carries bias, hidden-to-hidden ``hh`` does not; GRU
gates are (r, z, n) with ``h' = n*(1-z) + z*h``; MGU uses ``h' = c + f*(h-c)``;
IndRNN uses a per-channel scalar recurrence ``relu(Wx + u*h)``. Parameter names
follow the reference torch modules (``ih.weight``, ``ih.bias``, ``hh``).

The IndRNN cell runs through K3 (:func:`mridc_tpu_torch.kernels.indrnn`) at
every width and input kernel: a 1x1 cell at the widths the kernels' tiles
hold (the flagship's, and that of every IndRNN config in ``projects/``) in one
launch, other widths in chunks, and a larger input kernel on its gathered
patch channels (``kernels.k3_indrnn.plan``). GRU and MGU are plain PyTorch on
every device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mridc_tpu_torch.kernels.k3_indrnn import indrnn
from mridc_tpu_torch.nn.layers import Conv, as_torch_dtype

__all__ = ["ConvGRUCell", "ConvMGUCell", "IndRNNCell", "make_cell"]


def _gate_conv(in_features, features, kernel_size, dilation, use_bias, dtype=None):
    return Conv(in_features, features, kernel_size, dilation, "SAME", use_bias, dtype)


class _GatedCell(nn.Module):
    gates = 1

    def __init__(self, in_features, hidden_size, kernel_size=1, dilation=1, use_bias=True, dtype=None,
                 pointwise_matmul=False):
        super().__init__()
        del pointwise_matmul
        self.hidden_size = hidden_size
        self.ih = _gate_conv(in_features, self.gates * hidden_size, kernel_size, dilation, use_bias, dtype)
        self.hh = _gate_conv(hidden_size, self.gates * hidden_size, kernel_size, dilation, False, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in (self.ih, self.hh):
            nn.init.orthogonal_(conv.weight, generator=generator)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)


class ConvGRUCell(_GatedCell):
    gates = 3

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ih_r, ih_z, ih_n = self.ih(x).chunk(3, dim=1)
        hh_r, hh_z, hh_n = self.hh(h).chunk(3, dim=1)
        r = torch.sigmoid(ih_r + hh_r)
        z = torch.sigmoid(ih_z + hh_z)
        n = torch.tanh(ih_n + r * hh_n)
        return n * (1 - z) + z * h


class ConvMGUCell(_GatedCell):
    gates = 2

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ih_f, ih_c = self.ih(x).chunk(2, dim=1)
        hh_f, hh_c = self.hh(h).chunk(2, dim=1)
        f = torch.sigmoid(ih_f + hh_f)
        c = torch.tanh(ih_c + f * hh_c)
        return c + f * (h - c)


class IndRNNCell(nn.Module):
    def __init__(self, in_features, hidden_size, kernel_size=1, dilation=1, use_bias=True, dtype=None,
                 pointwise_matmul=False, lane_fold=False):
        super().__init__()
        del pointwise_matmul, lane_fold
        self.hidden_size = hidden_size
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.ih = Conv(in_features, hidden_size, kernel_size, dilation, "SAME", use_bias, dtype)
        self.hh = nn.Parameter(torch.empty(1, hidden_size, 1, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        std = 1.0 / (self.hidden_size * (1 + self.kernel_size**2))
        nn.init.normal_(self.ih.weight, std=std, generator=generator)
        if self.ih.bias is not None:
            nn.init.zeros_(self.ih.bias)
        nn.init.normal_(self.hh, std=std, generator=generator)

    def kernel_args(self, x: torch.Tensor, h: torch.Tensor) -> tuple:
        """K3's operands for a call on ``x`` and ``h``: ``(x, h, weight, bias,
        hh)`` in the compute dtype, activations channels_last."""
        dt = self.ih.compute_dtype or torch.promote_types(x.dtype, self.ih.weight.dtype)
        bias = None if self.ih.bias is None else self.ih.bias.to(dt)
        cl = torch.channels_last
        return (x.to(dt).contiguous(memory_format=cl), h.to(dt).contiguous(memory_format=cl),
                self.ih.weight.to(dt), bias, self.hh.to(dt))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return indrnn(*self.kernel_args(x, h), dilation=self.dilation)


_CELLS = {"GRU": ConvGRUCell, "MGU": ConvMGUCell, "INDRNN": IndRNNCell}


def make_cell(
    kind: str,
    in_features: int,
    hidden_size: int,
    kernel_size: int,
    dilation: int,
    use_bias: bool,
    dtype=None,
    pointwise_matmul: bool = False,
    lane_fold: bool = False,
):
    kind = kind.upper()
    if kind not in _CELLS:
        raise ValueError(f"Unknown recurrent layer {kind!r}; choose from {sorted(_CELLS)}")
    if lane_fold and kind != "INDRNN":
        raise ValueError("lane_fold is currently supported for the IndRNN cell only")
    dtype = as_torch_dtype(dtype)
    return _CELLS[kind](in_features, hidden_size, kernel_size, dilation, use_bias, dtype, pointwise_matmul)
