"""Shared multitask blocks (counterpart of ``mridc_tpu/models/multitask/blocks.py``):
the weighted k-space DC, the channel-group statistics and norms, and the
U-Net encoder and decoder that expose the encoder's feature stack.

:class:`KSpaceDC`: ``(ref + w * pred) / (m + w)`` with a learned ``dc_weight``
of shape (1,) initialised to ones. :func:`group_stats` (ddof 1) and
:func:`apply_group_norm` (biased variance, eps 1e-5, any rank) take their
channel groups over the LAST axis (NHWC), as the JAX package does.

:class:`UnetEncoder` takes NHWC ``[B, H, W, C]`` (optionally group-normalised
and zero-padded to ``((n - 1) | padding_size) + 1``, then cast to ``dtype``)
and returns its feature stack as NCHW ``channels_last`` tensors in the
compute dtype; :class:`UnetDecoder` takes such a stack and returns NHWC
float32, cropped and un-normalised; its up path reflect-pads odd sizes at
the ends, as the fastMRI U-Net's does. Flax scopes (``flax_scope``):
``ConvBlock_{k}``, ``TransposeConvBlock_{i}`` and the decoder's final
``Conv_0``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.nn.layers import Conv, as_torch_dtype
from mridc_tpu_torch.nn.seg_blocks import _conv_block, _init_weights, _reflect_to, _transpose_block
from mridc_tpu_torch.nn.unet import ConvBlock, TransposeConvBlock

__all__ = ["KSpaceDC", "UnetEncoder", "UnetDecoder", "group_stats", "apply_group_norm", "group_scale"]


class KSpaceDC(nn.Module):
    """Weighted k-space replacement DC (flax ``KSpaceDC_{k}/dc_weight``)."""

    flax_params = {"dc_weight": "dc_weight"}

    def __init__(self):
        super().__init__()
        self.dc_weight = nn.Parameter(torch.ones(1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.dc_weight)

    def forward(self, pred_kspace: torch.Tensor, ref_kspace: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None] if mask.ndim == pred_kspace.ndim - 1 else mask
        w = self.dc_weight
        return (ref_kspace + w * pred_kspace) / (m + w)


def group_stats(x: torch.Tensor, groups: int, ddof: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel-group) mean and std [B, groups] of an NHWC tensor."""
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    g = x.reshape(b, h, w, groups, c // groups)
    axes = (1, 2, 4)
    return g.mean(axes), torch.sqrt(g.var(axes, correction=ddof))


def group_scale(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x * scale + shift with per-(sample, group) scalars, NHWC."""
    b, h, w, c = x.shape
    groups = scale.shape[1]
    g = x.reshape(b, h, w, groups, c // groups)
    g = g * scale[:, None, None, :, None] + shift[:, None, None, :, None]
    return g.reshape(b, h, w, c)


def apply_group_norm(x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``F.group_norm`` semantics (no affine) with the channel groups over the
    last axis: biased variance, (x - mean) / sqrt(var + eps) per (sample,
    group); any rank >= 2."""
    b, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    g = x.reshape(b, *x.shape[1:-1], groups, c // groups)
    axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
    mean = g.mean(axes, keepdim=True)
    var = g.var(axes, keepdim=True, correction=0)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)


class UnetEncoder(nn.Module):
    """The U-Net's down path returning its feature stack (module docstring)."""

    def __init__(self, in_chans: int, chans: int = 32, num_pools: int = 4, normalize: bool = True,
                 padding: bool = True, padding_size: int = 11, norm_groups: int = 2, dtype=None):
        super().__init__()
        self.normalize, self.padding, self.padding_size, self.norm_groups = normalize, padding, padding_size, norm_groups
        self.dtype = as_torch_dtype(dtype)
        self.blocks = nn.ModuleList()
        ch, cin = chans, in_chans
        for i in range(num_pools):
            self.blocks.append(ConvBlock(cin, ch, dtype=dtype))
            cin = ch
            if i < num_pools - 1:
                ch *= 2
        self.blocks.append(ConvBlock(ch, ch * 2, dtype=dtype))
        for k, block in enumerate(self.blocks):
            _conv_block(block).flax_scope = f"ConvBlock_{k}"

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weights(self, generator)

    def pad_sizes(self, h: int, w: int):
        w_mult = ((w - 1) | self.padding_size) + 1
        h_mult = ((h - 1) | self.padding_size) + 1
        w_pad = (math.floor((w_mult - w) / 2), math.ceil((w_mult - w) / 2))
        h_pad = (math.floor((h_mult - h) / 2), math.ceil((h_mult - h) / 2))
        return h_pad, w_pad, h_mult, w_mult

    def forward(self, x: torch.Tensor, train: bool = False):
        """x NHWC -> (stack of NCHW features, pad sizes, mean, std); the last
        three are None where padding or normalisation is off."""
        mean = std = pad_sizes = None
        if self.normalize:
            mean, std = group_stats(x, self.norm_groups, ddof=1)
            x = group_scale(x, 1.0 / std, -mean / std)
        if self.padding:
            h_pad, w_pad, h_mult, w_mult = pad_sizes = self.pad_sizes(x.shape[1], x.shape[2])
            x = F.pad(x, (0, 0) + w_pad + h_pad)
        out = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.dtype is not None:
            out = out.to(self.dtype)
        stack: List[torch.Tensor] = []
        for i, block in enumerate(self.blocks):
            out = block(out, train)
            stack.append(out)
            if i < len(self.blocks) - 1:
                out = F.avg_pool2d(out, 2, 2)
        return stack, pad_sizes, mean, std


class UnetDecoder(nn.Module):
    """The U-Net's up path over an encoder's feature stack (module docstring)."""

    def __init__(self, out_chans: int = 2, chans: int = 32, num_pools: int = 4, normalize: bool = True,
                 padding: bool = True, norm_groups: int = 2, dtype=None):
        super().__init__()
        self.normalize, self.padding = normalize, padding
        self.dtype = as_torch_dtype(dtype)
        self.ups, self.blocks = nn.ModuleList(), nn.ModuleList()
        ch = chans * 2 ** (num_pools - 1)
        for i in range(num_pools):
            self.ups.append(_transpose_block(TransposeConvBlock(2 * ch, ch, dtype)))
            self.ups[-1].flax_scope = f"TransposeConvBlock_{i}"
            self.blocks.append(_conv_block(ConvBlock(2 * ch, ch, dtype=dtype)))
            self.blocks[-1].flax_scope = f"ConvBlock_{i}"
            if i < num_pools - 1:
                ch //= 2
        self.final = Conv(ch, out_chans, 1, dtype=dtype)
        self.final.flax_scope = "Conv_0"

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weights(self, generator)

    def forward(self, stack: Sequence[torch.Tensor], pad_sizes=None, mean: Optional[torch.Tensor] = None,
                std: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        stack = list(stack)
        if self.dtype is not None:
            stack = [s.to(self.dtype) for s in stack]
        out = stack.pop()
        for up, block in zip(self.ups, self.blocks):
            skip = stack.pop()
            out = block(torch.cat([_reflect_to(up(out), skip), skip], 1), train)
        out = self.final(out).float().permute(0, 2, 3, 1)
        if self.padding and pad_sizes is not None:
            h_pad, w_pad, h_mult, w_mult = pad_sizes
            out = out[:, h_pad[0]: h_mult - h_pad[1], w_pad[0]: w_mult - w_pad[1]]
        if self.normalize and mean is not None and std is not None:
            out = group_scale(out, std, mean)
        return out
