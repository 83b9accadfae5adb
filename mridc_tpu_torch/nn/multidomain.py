"""Multi-domain (image and k-space) conv blocks and U-Net (counterpart of
``mridc_tpu/nn/multidomain.py``): every conv has an image branch and a
k-space branch, ``out_channels // 2`` filters each and no bias; the k-space
branch transforms each consecutive (re, im) channel pair with the 2D FFT,
convolves, and transforms back (always in float32, cast back to the compute
dtype), and the two are concatenated [image, k-space].

Layout: NCHW in ``torch.channels_last`` inside; :class:`MultiDomainUnet2d`
takes and returns NHWC ``[N, H, W, C]`` as the JAX package's does. Module
names: ``down_sample_layers.{i}``, ``conv`` (the bottleneck),
``up_transpose_conv.{i}``, ``up_conv.{i}``, ``final_conv``; a block's
``convs.{0,1}``; a multi-domain conv's ``image_conv`` and ``kspace_conv``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.nn.layers import Conv, ConvTranspose, InstanceNorm, as_torch_dtype
from mridc_tpu_torch.ops.cplx import cmul
from mridc_tpu_torch.ops.fft import fft2, ifft2

__all__ = ["pairwise_fft", "MultiDomainConv", "MultiDomainConvBlock", "StandardizationLayer", "MultiDomainUnet2d"]


def pairwise_fft(x: torch.Tensor, inverse: bool, fft_centered: bool = False,
                 fft_normalization: str = "backward") -> torch.Tensor:
    """The 2D FFT (``inverse``: its inverse) of each (re, im) channel pair of
    an NCHW tensor (channels 2j and 2j + 1 are pair j), in float32; returned
    in x's dtype and channels_last."""
    n, c, h, w = x.shape
    z = torch.view_as_complex(x.float().reshape(n, c // 2, 2, h, w).permute(0, 1, 3, 4, 2).contiguous())
    z = (ifft2 if inverse else fft2)(z, fft_centered, fft_normalization)
    out = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(n, c, h, w)
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)


class MultiDomainConv(nn.Module):
    """A 3x3 zero-SAME conv (``transpose``: a 2x2 stride-2 transpose conv) in
    the image domain beside the same on the pairwise FFT of its input, whose
    output is transformed back; [image, k-space] concatenated."""

    def __init__(self, in_channels: int, out_channels: int, transpose: bool = False, fft_centered: bool = False,
                 fft_normalization: str = "backward", dtype=None):
        super().__init__()
        self.fft = (fft_centered, fft_normalization)
        half = out_channels // 2
        if transpose:
            self.image_conv = ConvTranspose(in_channels, half, 2, dtype=dtype)
            self.kspace_conv = ConvTranspose(in_channels, half, 2, dtype=dtype)
        else:
            self.image_conv = Conv(in_channels, half, 3, use_bias=False, dtype=dtype)
            self.kspace_conv = Conv(in_channels, half, 3, use_bias=False, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.image_conv.reset_parameters(generator)
        self.kspace_conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        img = self.image_conv(x)
        k = self.kspace_conv(pairwise_fft(x, False, *self.fft))
        return torch.cat([img, pairwise_fft(k, True, *self.fft)], dim=1)


class MultiDomainConvBlock(nn.Module):
    """(multi-domain conv, InstanceNorm, LeakyReLU(0.2), dropout) twice."""

    def __init__(self, in_channels: int, out_channels: int, drop_prob: float = 0.0, fft_centered: bool = False,
                 fft_normalization: str = "backward", dtype=None):
        super().__init__()
        self.drop_prob = drop_prob
        self.convs = nn.ModuleList([
            MultiDomainConv(cin, out_channels, False, fft_centered, fft_normalization, dtype)
            for cin in (in_channels, out_channels)
        ])
        self.norm = InstanceNorm()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in self.convs:
            conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for conv in self.convs:
            x = F.dropout(F.leaky_relu(self.norm(conv(x)), 0.2), self.drop_prob, train)
        return x


class StandardizationLayer(nn.Module):
    """Per-coil (SENSE-combined, residual) pairs: coil images and maps [B, C,
    H, W, 2] -> [B, C, H, W, 4] = [combined, combined - s_c combined]. The
    combination ``sum_c conj(s_c) x_c`` is K2's reduce stage (its plain
    version on CPU tensors); the coil images and maps take no gradient."""

    def __init__(self, coil_dim: int = 1):
        super().__init__()
        if coil_dim != 1:
            raise ValueError("StandardizationLayer takes [B, C, H, W, 2] with coils on axis 1")

    def forward(self, coil_images: torch.Tensor, sens: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (coil_images.requires_grad or sens.requires_grad):
            raise ValueError("StandardizationLayer: the coil images and maps take no gradient")
        combined = k2.reduce(torch.view_as_complex(coil_images.contiguous()), sens.contiguous(), None, False)[:, None]
        residual = combined - cmul(combined, sens)
        return torch.cat([combined.expand_as(residual), residual], dim=-1)


class MultiDomainUnet2d(nn.Module):
    """``num_pool_layers`` down blocks (chans, 2 chans, ...) with 2x2 average
    pooling, a bottleneck block at twice the last width, and per level a
    transpose multi-domain conv, InstanceNorm, LeakyReLU(0.2), a reflect pad
    to the skip's size, the concatenation [out, skip] and a block; a 1x1 conv
    with bias to ``out_channels``. ``dtype``: the convs' compute dtype (the
    input is cast to it, the output back to the input's dtype)."""

    def __init__(self, in_channels: int, out_channels: int = 2, chans: int = 32, num_pool_layers: int = 4,
                 drop_prob: float = 0.0, fft_centered: bool = False, fft_normalization: str = "backward",
                 dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        fft = (fft_centered, fft_normalization)
        ch, cin = chans, in_channels
        self.down_sample_layers = nn.ModuleList()
        for i in range(num_pool_layers):
            self.down_sample_layers.append(MultiDomainConvBlock(cin, ch, drop_prob, *fft, dtype))
            cin = ch
            if i < num_pool_layers - 1:
                ch *= 2
        self.conv = MultiDomainConvBlock(ch, 2 * ch, drop_prob, *fft, dtype)
        cin = 2 * ch
        self.up_transpose_conv, self.up_conv = nn.ModuleList(), nn.ModuleList()
        for i in range(num_pool_layers):
            self.up_transpose_conv.append(MultiDomainConv(cin, ch, True, *fft, dtype))
            self.up_conv.append(MultiDomainConvBlock(2 * ch, ch, drop_prob, *fft, dtype))
            cin = ch
            if i < num_pool_layers - 1:
                ch //= 2
        self.final_conv = Conv(ch, out_channels, 1, dtype=dtype)
        self.norm = InstanceNorm()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's lecun-normal kernels in its creation order (down blocks,
        bottleneck, then per level the transpose conv and its block; the 1x1
        conv last), zero bias."""
        for block in list(self.down_sample_layers) + [self.conv]:
            block.reset_parameters(generator)
        for up_t, up_c in zip(self.up_transpose_conv, self.up_conv):
            up_t.reset_parameters(generator)
            up_c.reset_parameters(generator)
        self.final_conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        in_dtype = x.dtype
        out = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.dtype is not None:
            out = out.to(self.dtype)
        stack = []
        for block in self.down_sample_layers:
            out = block(out, train)
            stack.append(out)
            out = F.avg_pool2d(out, 2)
        out = self.conv(out, train)
        for up_t, up_c in zip(self.up_transpose_conv, self.up_conv):
            skip = stack.pop()
            out = F.leaky_relu(self.norm(up_t(out)), 0.2)
            pad_h, pad_w = skip.shape[2] - out.shape[2], skip.shape[3] - out.shape[3]
            if pad_h or pad_w:
                out = F.pad(out, (0, pad_w, 0, pad_h), mode="reflect")
            out = up_c(torch.cat([out, skip], dim=1), train)
        return self.final_conv(out).to(in_dtype).permute(0, 2, 3, 1)
