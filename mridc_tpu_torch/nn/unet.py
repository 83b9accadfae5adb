"""fastMRI-style U-Net family (counterpart of ``mridc_tpu/nn/unet.py``): two 3x3
conv + InstanceNorm + LeakyReLU(0.2) blocks, average-pool downsampling,
transpose-conv upsampling with skip concat, and the group-normalised, padded
wrapper for complex inputs.

Layout: NCHW in ``torch.channels_last`` memory inside; :class:`NormUnet`
takes and returns NHWC ``[B, H, W, C]`` as the JAX package's does. Module and
parameter names are the reference torch ones
(``mridc/collections/reconstruction/nn/unet_base/unet_block.py``:
``unet.down_sample_layers.{i}.layers.0.weight``, ``unet.conv``,
``unet.up_transpose_conv.{i}.layers.0.weight``, ``unet.up_conv.{i}``, the last
``up_conv`` a ``(ConvBlock, 1x1 Conv)`` pair), so
``mridc_tpu.utils.torch_import.import_normunet_params`` reads a port state dict
as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.nn.layers import Conv, ConvTranspose, InstanceNorm, as_torch_dtype

__all__ = ["ConvBlock", "TransposeConvBlock", "Unet", "NormUnet"]


def _run(layers: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
    for layer in layers:
        x = F.dropout(x, layer.p, train) if isinstance(layer, nn.Dropout) else layer(x)
    return x


class ConvBlock(nn.Module):
    """(3x3 zero-SAME conv without bias, InstanceNorm, LeakyReLU(0.2),
    dropout) twice; the convs compute in ``dtype``."""

    def __init__(self, in_chans: int, out_chans: int, drop_prob: float = 0.0, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(
            Conv(in_chans, out_chans, 3, use_bias=False, dtype=dtype), InstanceNorm(), nn.LeakyReLU(0.2),
            nn.Dropout(drop_prob),
            Conv(out_chans, out_chans, 3, use_bias=False, dtype=dtype), InstanceNorm(), nn.LeakyReLU(0.2),
            nn.Dropout(drop_prob),
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.layers[0].reset_parameters(generator)
        self.layers[4].reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _run(self.layers, x, train)


class TransposeConvBlock(nn.Module):
    """2x2 stride-2 transpose conv without bias, InstanceNorm, LeakyReLU(0.2)."""

    def __init__(self, in_chans: int, out_chans: int, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(ConvTranspose(in_chans, out_chans, 2, dtype=dtype), InstanceNorm(),
                                    nn.LeakyReLU(0.2))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.layers[0].reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class Unet(nn.Module):
    """Channels chans, 2 chans, ... down, 2^pools chans at the bottleneck, and
    back up. ``dtype``: the convs' compute dtype; the input is cast to it at
    entry and the output back to float32 (parameters stay float32)."""

    def __init__(self, in_chans: int, out_chans: int, chans: int = 32, num_pool_layers: int = 4,
                 drop_prob: float = 0.0, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.down_sample_layers = nn.ModuleList([ConvBlock(in_chans, chans, drop_prob, dtype)])
        ch = chans
        for _ in range(num_pool_layers - 1):
            self.down_sample_layers.append(ConvBlock(ch, ch * 2, drop_prob, dtype))
            ch *= 2
        self.conv = ConvBlock(ch, ch * 2, drop_prob, dtype)
        self.up_conv = nn.ModuleList()
        self.up_transpose_conv = nn.ModuleList()
        for _ in range(num_pool_layers - 1):
            self.up_transpose_conv.append(TransposeConvBlock(ch * 2, ch, dtype))
            self.up_conv.append(ConvBlock(ch * 2, ch, drop_prob, dtype))
            ch //= 2
        self.up_transpose_conv.append(TransposeConvBlock(ch * 2, ch, dtype))
        self.up_conv.append(nn.Sequential(ConvBlock(ch * 2, ch, drop_prob, dtype),
                                          Conv(ch, out_chans, 1, dtype=dtype)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's draw order: the down blocks, the bottleneck, then each
        transpose conv before its up block, the final 1x1 conv last."""
        for block in self.down_sample_layers:
            block.reset_parameters(generator)
        self.conv.reset_parameters(generator)
        for up, block in zip(self.up_transpose_conv, self.up_conv):
            up.reset_parameters(generator)
            (block[0] if isinstance(block, nn.Sequential) else block).reset_parameters(generator)
        self.up_conv[-1][1].reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: NCHW (channels_last) -> NCHW float32 (in x's dtype without ``dtype``)."""
        out = x if self.dtype is None else x.to(self.dtype)
        stack = []
        for block in self.down_sample_layers:
            out = block(out, train)
            stack.append(out)
            out = F.avg_pool2d(out, 2, 2)
        out = self.conv(out, train)
        for up, block in zip(self.up_transpose_conv, self.up_conv):
            skip = stack.pop()
            out = up(out)
            # odd sizes: reflect-pad right and bottom to the skip's size
            pad_h, pad_w = skip.shape[2] - out.shape[2], skip.shape[3] - out.shape[3]
            if pad_h or pad_w:
                out = F.pad(out, (0, pad_w, 0, pad_h), mode="reflect")
            out = torch.cat([out, skip], dim=1)
            out = _run(block, out, train) if isinstance(block, nn.Sequential) else block(out, train)
        return out if self.dtype is None else out.float()


class NormUnet(nn.Module):
    """Group-normalised U-Net over channelised complex input, zero-padded to
    ``((n - 1) | padding_size) + 1`` on each spatial axis.

    Input and output: NHWC ``[B, H, W, C]`` real channels (C = 2 for one
    complex image). The normalisation and padding run in float32; ``dtype`` is
    the wrapped Unet's compute dtype."""

    def __init__(self, chans: int = 32, num_pools: int = 4, in_chans: int = 2, out_chans: int = 2,
                 drop_prob: float = 0.0, padding_size: int = 15, normalize: bool = True, norm_groups: int = 2,
                 dtype=None):
        super().__init__()
        self.padding_size = padding_size
        self.normalize = normalize
        self.norm_groups = norm_groups
        self.unet = Unet(in_chans, out_chans, chans, num_pools, drop_prob, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.unet.reset_parameters(generator)

    def _norm(self, x: torch.Tensor):
        """x NCHW -> groups over channels in channel-major order; std with
        ddof 1 plus 1e-12."""
        b, c, h, w = x.shape
        xg = x.reshape(b, self.norm_groups, -1)
        mean = xg.mean(-1, keepdim=True)
        std = xg.std(-1, keepdim=True, correction=1) + 1e-12
        return ((xg - mean) / std).reshape(b, c, h, w), mean, std

    def _unnorm(self, x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        return (x.reshape(b, self.norm_groups, -1) * std + mean).reshape(b, c, h, w)

    def _pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        h_mult = ((h - 1) | self.padding_size) + 1
        w_mult = ((w - 1) | self.padding_size) + 1
        return (w_mult - w) // 2, (w_mult - w + 1) // 2, (h_mult - h) // 2, (h_mult - h + 1) // 2

    def _trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The network between the padding and the crop (NCHW)."""
        return self.unet(x, train)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        mean = std = None
        if self.normalize:
            x, mean, std = self._norm(x)
        h, w = x.shape[2], x.shape[3]
        left, right, top, bottom = self._pads(h, w)
        x = F.pad(x, (left, right, top, bottom)).contiguous(memory_format=torch.channels_last)
        x = self._trunk(x, train)[:, :, top : top + h, left : left + w]
        if self.normalize:
            x = self._unnorm(x, mean, std)
        return x.permute(0, 2, 3, 1).contiguous()
