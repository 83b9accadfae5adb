"""Convolutional LSTM and the ConvLSTM-fronted NormUnet (counterpart of
``mridc_tpu/nn/convlstm.py``).

``ConvLSTMCell``: one 4-gate convolution over [x, h] (zero "SAME" padding,
bias), gates in the order i, f, o, g: i, f, o sigmoid, g tanh, c' = f c + i
g, h' = o tanh(c'). ``ConvLSTM``: per layer a cell from a zero state over
the time axis, the last layer's outputs. ``ConvLSTMNormUnet``: the
:class:`~mridc_tpu_torch.nn.unet.NormUnet` wrapper (group norm with ddof 1
and +1e-12, zero pad to a multiple of ``padding_size + 1``) around one
zero-state ConvLSTM step and then the U-Net.

Layout: NCHW in ``torch.channels_last`` memory inside (``ConvLSTM`` takes
[B, T, C, H, W]); ``ConvLSTMNormUnet`` takes and returns NHWC ``[B, H, W,
C]``. Flax scopes: ``ConvLSTM_0/ConvLSTMCell_{l}/Conv_0`` and ``Unet_0``
(``flax_scope``, read by ``utils/params.py``). ``dtype``: the ConvLSTM's and
the U-Net's compute dtype (the input is cast at the ConvLSTM's entry; the
norm and its statistics stay float32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mridc_tpu_torch.nn.layers import Conv, as_torch_dtype
from mridc_tpu_torch.nn.seg_blocks import name_unet
from mridc_tpu_torch.nn.unet import NormUnet, Unet

__all__ = ["ConvLSTMCell", "ConvLSTM", "ConvLSTMNormUnet"]


class ConvLSTMCell(nn.Module):
    def __init__(self, in_chans: int, hidden_dim: int, kernel_size: int = 3, use_bias: bool = True, dtype=None):
        super().__init__()
        self.conv = Conv(in_chans + hidden_dim, 4 * hidden_dim, kernel_size, use_bias=use_bias, dtype=dtype)
        self.conv.flax_scope = "Conv_0"

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        h, c = state
        gates = self.conv(torch.cat([x, h], dim=1))
        cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=1)
        c_next = torch.sigmoid(cc_f) * c + torch.sigmoid(cc_i) * torch.tanh(cc_g)
        h_next = torch.sigmoid(cc_o) * torch.tanh(c_next)
        return h_next, c_next


class ConvLSTM(nn.Module):
    """Multi-layer ConvLSTM over [B, T, C, H, W] from a zero state -> the last
    layer's [B, T, hidden, H, W]."""

    def __init__(self, in_chans: int, hidden_dim: int, kernel_size: int = 3, num_layers: int = 1,
                 use_bias: bool = True, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.hidden_dim = hidden_dim
        self.cells = nn.ModuleList()
        for layer in range(num_layers):
            cell = ConvLSTMCell(in_chans if layer == 0 else hidden_dim, hidden_dim, kernel_size, use_bias, dtype)
            cell.flax_scope = f"ConvLSTMCell_{layer}"
            self.cells.append(cell)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for cell in self.cells:
            cell.conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        b, t, _, hgt, wdt = x.shape
        seq = [x[:, s].contiguous(memory_format=torch.channels_last) for s in range(t)]
        for cell in self.cells:
            h = torch.zeros((b, self.hidden_dim, hgt, wdt), dtype=x.dtype, device=x.device).contiguous(
                memory_format=torch.channels_last)
            c = torch.zeros_like(h)
            outs = []
            for step in seq:
                h, c = cell(step, (h, c))
                outs.append(h)
            seq = outs
        return torch.stack(seq, dim=1)


class ConvLSTMNormUnet(NormUnet):
    """NormUnet with a one-layer ConvLSTM input stage: norm, pad, one
    zero-state ConvLSTM step (``in_chans`` -> ``chans``), the U-Net
    (``chans`` -> ``out_chans``), crop, unnorm."""

    def __init__(self, chans: int, num_pools: int, in_chans: int = 2, out_chans: int = 2, drop_prob: float = 0.0,
                 padding_size: int = 15, normalize: bool = True, norm_groups: int = 2, dtype=None):
        super().__init__(chans, num_pools, chans, out_chans, drop_prob, padding_size, normalize, norm_groups, dtype)
        self.convlstm = ConvLSTM(in_chans, chans, kernel_size=3, num_layers=1, dtype=dtype)
        self.convlstm.flax_scope = "ConvLSTM_0"
        name_unet(self.unet).flax_scope = "Unet_0"

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.convlstm.reset_parameters(generator)
        self.unet.reset_parameters(generator)

    def _trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.unet(self.convlstm(x[:, None])[:, 0], train)
