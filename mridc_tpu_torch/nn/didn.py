"""Deep iterative down-up CNN, the k-space regulariser of KIKINet and the
regulariser of DUNet (counterpart of ``mridc_tpu/nn/didn.py``): strided-conv
downsampling, pixel-shuffle upsampling, down-up blocks whose outputs all go
through one shared reconstruction block, aggregated by a 1x1 conv.

Takes and returns NHWC ``[B, H, W, C]``; inside, NCHW in
``torch.channels_last`` memory. The strided convs pad k // 2 on every side
(torch's ``padding=k//2``, the JAX package's explicit padding, not flax's
right-heavy SAME); an odd size entering a down-up block is reflect-padded at
its end. :class:`Subpixel`'s depth-to-space is ``F.pixel_shuffle``: the JAX
package lays the NHWC channels out in PixelShuffle's order (channel
``c * r**2 + i * r + j`` to pixel ``(i, j)`` of output channel c).

Module names are the reference torch ones (``conv_in``, ``down``,
``dubs.{i}`` with ``conv1_1``, ``down1``, ``conv2_1``, ``down2``,
``conv3_1``, ``up1``, ``conv_agg_1``, ``conv2_2``, ``up2``, ``conv_agg_2``,
``conv1_2``, ``conv_out``; ``recon_block.convs.{j}``, ``recon_agg``,
``conv``, ``up2``, ``conv_out``); a PReLU conv is ``{name}.conv`` and
``{name}.prelu``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.nn.layers import Conv, as_torch_dtype, prelu
from mridc_tpu_torch.nn.mwcnn import pad_even

__all__ = ["PConv", "Subpixel", "DUB", "ReconBlock", "DIDN"]


class PConv(nn.Module):
    """A k x k conv with k // 2 zeros on every side, then (``act``) a
    one-alpha PReLU starting at 0.25."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1, act: bool = True,
                 dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, padding=kernel // 2, stride=stride, dtype=dtype)
        self.prelu = nn.Parameter(torch.full((1,), 0.25)) if act else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.conv.reset_parameters(generator)
        if self.prelu is not None:
            nn.init.constant_(self.prelu, 0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.prelu is None else prelu(x, self.prelu)


class Subpixel(nn.Module):
    """A ``kernel`` x ``kernel`` zero-SAME conv to ``features * upscale**2``
    channels, then ``F.pixel_shuffle``."""

    def __init__(self, in_channels: int, features: int, upscale: int = 2, kernel: int = 1, dtype=None):
        super().__init__()
        self.upscale = upscale
        self.conv = Conv(in_channels, features * upscale**2, kernel, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), self.upscale)


def _seq(in_channels: int, features: int, n: int, dtype) -> nn.ModuleList:
    return nn.ModuleList([PConv(in_channels if i == 0 else features, features, dtype=dtype) for i in range(n)])


def _run(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


class DUB(nn.Module):
    """Down-up block at ``channels``: two stride-2 levels (2x and 4x the
    channels), pixel-shuffle back up with 1x1 aggregation of the skips, and a
    residual around the whole."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        c = channels
        self.conv1_1 = _seq(c, c, 2, dtype)
        self.down1 = PConv(c, 2 * c, stride=2, act=False, dtype=dtype)
        self.conv2_1 = _seq(2 * c, 2 * c, 1, dtype)
        self.down2 = PConv(2 * c, 4 * c, stride=2, act=False, dtype=dtype)
        self.conv3_1 = _seq(4 * c, 4 * c, 1, dtype)
        self.up1 = Subpixel(4 * c, 2 * c, dtype=dtype)
        self.conv_agg_1 = Conv(4 * c, 2 * c, 1, dtype=dtype)
        self.conv2_2 = _seq(2 * c, 2 * c, 1, dtype)
        self.up2 = Subpixel(2 * c, c, dtype=dtype)
        self.conv_agg_2 = Conv(2 * c, c, 1, dtype=dtype)
        self.conv1_2 = _seq(c, c, 2, dtype)
        self.conv_out = _seq(c, c, 1, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in (*self.conv1_1, self.down1, *self.conv2_1, self.down2, *self.conv3_1, self.up1, self.conv_agg_1,
                  *self.conv2_2, self.up2, self.conv_agg_2, *self.conv1_2, *self.conv_out):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = pad_even(x)
        x1 = x1 + _run(self.conv1_1, x1)
        x2 = self.down1(x1)
        x2 = x2 + _run(self.conv2_1, x2)
        out = self.down2(x2)
        out = out + _run(self.conv3_1, out)
        out = self.up1(out)[:, :, : x2.shape[2], : x2.shape[3]]
        out = self.conv_agg_1(torch.cat([x2, out], dim=1))
        out = out + _run(self.conv2_2, out)
        out = self.up2(out)[:, :, : x1.shape[2], : x1.shape[3]]
        out = self.conv_agg_2(torch.cat([x1, out], dim=1))
        out = out + _run(self.conv1_2, out)
        out = _run(self.conv_out, out)
        return x + out[:, :, : x.shape[2], : x.shape[3]]


class ReconBlock(nn.Module):
    """``num_convs`` 3x3 PReLU convs (the last without its PReLU) and a
    residual."""

    def __init__(self, channels: int, num_convs: int = 9, dtype=None):
        super().__init__()
        self.convs = nn.ModuleList([PConv(channels, channels, act=i < num_convs - 1, dtype=dtype)
                                    for i in range(num_convs)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.convs:
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _run(self.convs, x)


class DIDN(nn.Module):
    """``in_channels`` -> ``out_channels`` at ``hidden_channels`` inside:
    a conv, a stride-2 conv, ``num_dubs`` down-up blocks, the ONE
    reconstruction block on every block's output, a 1x1 aggregation, a conv,
    a pixel-shuffle back to full size and the output conv; cropped to the
    input's size, plus the input's first channels with ``skip_connection``.
    ``dtype`` is the convs' compute dtype; the output is in the input's."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2, hidden_channels: int = 128, num_dubs: int = 6,
                 num_convs_recon: int = 9, skip_connection: bool = False, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.out_channels = out_channels
        self.skip_connection = skip_connection
        hc = hidden_channels
        self.conv_in = PConv(in_channels, hc, dtype=dtype)
        self.down = PConv(hc, hc, stride=2, act=False, dtype=dtype)
        self.dubs = nn.ModuleList([DUB(hc, dtype) for _ in range(num_dubs)])
        self.recon_block = ReconBlock(hc, num_convs_recon, dtype)
        self.recon_agg = Conv(hc * num_dubs, hc, 1, dtype=dtype)
        self.conv = PConv(hc, hc, dtype=dtype)
        self.up2 = Subpixel(hc, hc, dtype=dtype)
        self.conv_out = PConv(hc, out_channels, act=False, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in (self.conv_in, self.down, *self.dubs, self.recon_block, self.recon_agg, self.conv, self.up2,
                  self.conv_out):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x_in = x
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (channels_last)
        if self.dtype is not None:
            x = x.to(self.dtype)
        out = self.down(self.conv_in(x))
        dub_outs = []
        for dub in self.dubs:
            out = dub(out)
            dub_outs.append(out)
        out = self.recon_agg(torch.cat([self.recon_block(d) for d in dub_outs], dim=1))
        out = self.conv_out(self.up2(self.conv(out)))
        out = out[:, :, :h, :w].to(x_in.dtype).permute(0, 2, 3, 1).contiguous()
        return x_in[..., : self.out_channels] + out if self.skip_connection else out
