"""Multi-level wavelet CNN, the image regulariser of XPDNet and KIKINet
(counterpart of ``mridc_tpu/nn/mwcnn.py``): Haar DWT downsampling (4x the
channels), a conv block and a dilated conv block per scale, IWT upsampling with
residual skips, and a last conv whose ReLU the reference keeps.

Takes and returns NHWC ``[B, H, W, C]``; inside, NCHW in
``torch.channels_last`` memory. :func:`dwt2` and :func:`iwt2` take NCHW and
are the JAX package's functions term for term (the channel order LL, HL, LH,
HH; the same additions in the same order), so they agree bit for bit.

Module names: ``down_cb.{i}`` / ``down_dil.{i}`` (flax ``_CB_{i}`` /
``_DilCB_{i}``), ``up_dil.{i}`` (``_DilCB_{n + i}``), ``up_cb.{i}``
(``_CB_{n + i}``), ``out`` (``Conv_0``); a block's conv is ``convs.{j}``, its
BatchNorm ``bns.{j}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.nn.layers import BatchNorm, Conv, as_torch_dtype

__all__ = ["dwt2", "iwt2", "pad_even", "MWCNN", "MWCNNHead"]


def dwt2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2] in the channel order LL, HL, LH, HH."""
    x01 = x[:, :, 0::2] / 2
    x02 = x[:, :, 1::2] / 2
    x1 = x01[..., 0::2]
    x2 = x02[..., 0::2]
    x3 = x01[..., 1::2]
    x4 = x02[..., 1::2]
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], dim=1)


def iwt2(x: torch.Tensor) -> torch.Tensor:
    """[B, 4C, H, W] -> [B, C, 2H, 2W], the inverse of :func:`dwt2`."""
    c = x.shape[1] // 4
    x1, x2, x3, x4 = (x[:, i * c : (i + 1) * c] / 2 for i in range(4))
    b, _, h, w = x1.shape
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    out[:, :, 0::2, 0::2] = x1 - x2 - x3 + x4
    out[:, :, 1::2, 0::2] = x1 - x2 + x3 - x4
    out[:, :, 0::2, 1::2] = x1 + x2 - x3 - x4
    out[:, :, 1::2, 1::2] = x1 + x2 + x3 + x4
    return out


def pad_even(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad an odd H or W of an NCHW tensor by one at the end."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    return F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x


class _Block(nn.Module):
    """3x3 zero-SAME convs (one per dilation), each followed by a float32
    BatchNorm (eps 1e-4, momentum 0.95) when ``batchnorm`` and a ReLU: the JAX
    package's ``_CB`` (one conv to ``features``) and ``_DilCB`` (channels
    kept)."""

    def __init__(self, in_channels: int, features: int, dilations: Sequence[int], batchnorm: bool, live_bn: bool,
                 dtype):
        super().__init__()
        widths = [in_channels] + [features] * len(dilations)
        self.convs = nn.ModuleList([Conv(widths[j], widths[j + 1], 3, d, dtype=dtype)
                                    for j, d in enumerate(dilations)])
        self.bns = nn.ModuleList([BatchNorm(features, 1e-4, 0.95, live_bn) for _ in dilations] if batchnorm else [])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for j, conv in enumerate(self.convs):
            conv.reset_parameters(generator)
            if self.bns:
                self.bns[j].reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for j, conv in enumerate(self.convs):
            x = conv(x)
            if self.bns:
                x = self.bns[j](x, train)
            x = F.relu(x)
        return x


class MWCNN(nn.Module):
    """``input_channels`` in and out; ``num_scales`` scales of
    ``first_conv_hidden_channels * 2**i`` channels. The convs are flax's
    plain ``nn.Conv`` (``lecun_normal`` kernels, zero biases). ``dtype`` is
    the compute dtype of the convs and the DWT/IWT ladders; BatchNorm runs in
    float32 and the output is in the input's dtype."""

    def __init__(self, input_channels: int = 2, first_conv_hidden_channels: int = 16, num_scales: int = 4,
                 batchnorm: bool = False, live_bn: bool = False, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        hc, n = first_conv_hidden_channels, num_scales

        def block(cin, feats, dil):
            return _Block(cin, feats, dil, batchnorm, live_bn, dtype)

        self.down_cb = nn.ModuleList([block(input_channels if i == 0 else 4 * hc * 2 ** (i - 1), hc * 2**i, (1,))
                                      for i in range(n)])
        self.down_dil = nn.ModuleList([block(hc * 2**i, hc * 2**i, (2, 1) if i != n - 1 else (2, 3))
                                       for i in range(n)])
        scales = [n - 1 - i for i in range(n)]
        self.up_dil = nn.ModuleList([block(hc * 2**s, hc * 2**s, (2, 1) if s != n - 1 else (3, 2)) for s in scales])
        self.up_cb = nn.ModuleList([block(hc * 2**s, hc * 2 ** (s + 1), (1,)) for s in scales if s != 0])
        self.out = Conv(hc, input_channels, 3, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for blk in (*self.down_cb, *self.down_dil, *self.up_dil, *self.up_cb, self.out):
            blk.reset_parameters(generator)

    def forward(self, x: torch.Tensor, res: bool = False, train: bool = False) -> torch.Tensor:
        inp = x
        h, w = x.shape[1], x.shape[2]
        x = pad_even(x.permute(0, 3, 1, 2))  # NHWC -> NCHW (channels_last)
        if self.dtype is not None:
            x = x.to(self.dtype)
        n = len(self.down_cb)
        skips = []
        for i in range(n):
            x = self.down_cb[i](x if i == 0 else dwt2(x), train)
            x = self.down_dil[i](x, train)
            if i != n - 1:
                x = pad_even(x)
                skips.append(x)
        for i in range(n):
            scale = n - 1 - i
            x = self.up_dil[i](x, train)
            if scale != 0:
                x = iwt2(self.up_cb[i](x, train))
                skip = skips[scale - 1]
                x = x[:, :, : skip.shape[2], : skip.shape[3]] + skip
            else:
                x = F.relu(self.out(x))
        x = x[:, :, :h, :w].to(inp.dtype).permute(0, 2, 3, 1).contiguous()
        return x + inp if res else x


class MWCNNHead(nn.Module):
    """An :class:`MWCNN` then a ``kernel`` x ``kernel`` zero-SAME conv to
    ``out_channels`` (the primal models of XPDNet and LPDNet; the JAX
    package's ``_Wrap``), output in the input's dtype."""

    def __init__(self, mwcnn: MWCNN, in_channels: int, out_channels: int, kernel: int, dtype=None):
        super().__init__()
        self.mwcnn = mwcnn
        self.head = Conv(in_channels, out_channels, kernel, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mwcnn.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.head(self.mwcnn(x).permute(0, 3, 1, 2))
        return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
