"""Segmentation trunks (counterpart of ``mridc_tpu/nn/seg_blocks.py``): the
attention-gated U-Net, the lambda U-Net, V-Net, MONAI's DynUNet, the ViT and
UNETR, and the 3D U-Net.

Layout: NCHW tensors in ``torch.channels_last`` memory (NCDHW for the 3D
U-Net), which is physically the JAX package's NHWC; every trunk takes and
returns NCHW, the wrappers of ``models/segmentation`` take NHWC images.

Names: each module that is a flax scope carries its flax auto-name in
``flax_scope`` (``{Class}_{k}``, counted per class in the order flax creates
it), so that ``utils/params.py`` reads the weight mapping off the module
tree: a conv's ``kernel`` and ``bias``, a TorchBatchNorm's ``scale``,
``bias``, ``mean`` and ``var``, a Dense kernel [in, out], and the leaves a
module names in ``flax_params``.

Compute dtype (``dtype``, opt-in bfloat16): the input is cast at entry, the
convolutions and products run in it, the norms' statistics, the softmaxes
and the BatchNorms in float32, and the logits come out in float32; the
parameters stay float32, as in the JAX package.

Dropout: every rate of the ``projects/`` configs is 0 but V-Net's (0.5 by
default, and the skip's fixed ``Dropout2d(0.5)``). Channel dropout goes
through :func:`dropout2d`, which takes its keep masks from
:func:`dropout_masks` while that is active, so that a test or a check can
hand the same masks to both packages.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.nn.layers import (BatchNorm, Conv, Conv3d, ConvTranspose, ConvTranspose3d, Dense, InstanceNorm,
                                       as_torch_dtype, bilinear_resize, nearest_resize)
from mridc_tpu_torch.nn.unet import ConvBlock, TransposeConvBlock

__all__ = ["AttentionGate", "AttentionUnet", "LambdaLayer", "LambdaBlock", "LambdaUnet", "VNet", "UnetBasicBlock",
           "UnetResBlock", "UnetUpBlock", "UnetOutBlock", "DynUNet", "SABlock", "MLPBlock", "TransformerBlock",
           "PatchEmbedding", "ViT", "UnetrPrUpBlock", "UnetrUpBlock", "UNETR", "Conv3dBlock", "TransposeConv3dBlock",
           "UNet3D", "dropout2d", "dropout_masks", "name_unet"]


# ---------------------------------------------------------------- shared


class _Names:
    """flax's auto-names: ``{Class}_{k}`` counted per class in creation order;
    a call names ``module`` and returns it."""

    _FLAX_CLASS = ((Conv3d, "Conv"), (Conv, "Conv"), (ConvTranspose3d, "ConvTranspose"),
                   (ConvTranspose, "ConvTranspose"), (BatchNorm, "TorchBatchNorm"), (Dense, "Dense"))

    def __init__(self):
        self.count = {}

    def __call__(self, module: nn.Module) -> nn.Module:
        cls = next((n for t, n in self._FLAX_CLASS if isinstance(module, t)), type(module).__name__)
        k = self.count.get(cls, 0)
        self.count[cls] = k + 1
        module.flax_scope = f"{cls}_{k}"
        return module


def _conv_block(block: ConvBlock) -> ConvBlock:
    """The fastMRI ``ConvBlock``'s two convs are flax's ``Conv_0``/``Conv_1``."""
    block.layers[0].flax_scope, block.layers[4].flax_scope = "Conv_0", "Conv_1"
    return block


def _transpose_block(block: TransposeConvBlock) -> TransposeConvBlock:
    block.layers[0].flax_scope = "ConvTranspose_0"
    return block


def name_unet(unet):
    """Name a fastMRI :class:`~mridc_tpu_torch.nn.unet.Unet`'s scopes as flax
    does: ``ConvBlock_{k}`` down, bottleneck, up; ``TransposeConvBlock_{i}``
    from the bottom up; the final 1x1 conv ``Conv_0``."""
    pools = len(unet.down_sample_layers)
    blocks = list(unet.down_sample_layers) + [unet.conv] + [
        b[0] if isinstance(b, nn.Sequential) else b for b in unet.up_conv]
    for k, block in enumerate(blocks):
        _conv_block(block).flax_scope = f"ConvBlock_{k}"
    for i, up in enumerate(unet.up_transpose_conv):
        _transpose_block(up).flax_scope = f"TransposeConvBlock_{i}"
    unet.up_conv[pools - 1][1].flax_scope = "Conv_0"
    return unet


def _init_weights(root: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every weight below ``root`` by flax's initialisers (each module
    with parameters or buffers of its own resets them from ``generator``)."""
    for m in root.modules():
        if m is not root and (next(m.parameters(recurse=False), None) is not None
                              or next(m.buffers(recurse=False), None) is not None):
            m.reset_parameters(generator)


class _Trunk(nn.Module):
    """A trunk: its weights drawn by :func:`_init_weights`."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weights(self, generator)


_MASKS: Optional[Callable] = None


@contextlib.contextmanager
def dropout_masks(draw: Callable):
    """While active, :func:`dropout2d` keeps channel (b, c) where
    ``draw((B, C), p)`` (a boolean array or tensor, one per call in call
    order) is true, whatever the device."""
    global _MASKS
    prev, _MASKS = _MASKS, draw
    try:
        yield
    finally:
        _MASKS = prev


def dropout2d(x: torch.Tensor, p: float, train: bool) -> torch.Tensor:
    """flax ``Dropout(p, broadcast_dims=(1, 2))`` on NHWC, torch's
    ``Dropout2d`` here: whole channels of a sample zeroed, the rest scaled by
    1 / (1 - p); identity in eval mode or at p = 0."""
    if not train or p == 0.0:
        return x
    if _MASKS is None:
        return F.dropout2d(x, p, True)
    keep = torch.as_tensor(_MASKS(tuple(x.shape[:2]), p), device=x.device).bool()
    return torch.where(keep[:, :, None, None], x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _dropout(x: torch.Tensor, p: float, train: bool) -> torch.Tensor:
    return F.dropout(x, p, train) if p else x


def _reflect_to(out: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Odd sizes: reflect-pad ``out``'s last two axes at their ends to the
    skip's."""
    pad_h, pad_w = skip.shape[-2] - out.shape[-2], skip.shape[-1] - out.shape[-1]
    if pad_h or pad_w:
        out = F.pad(out, (0, pad_w, 0, pad_h), mode="reflect")
    return out


# ---------------------------------------------------------------- Attention UNet


class AttentionGate(nn.Module):
    """Additive attention gate: W_x a strided 2x2 conv without bias, W_g a 1x1
    conv resized bilinearly onto W_x's grid, sigmoid(psi(relu(.))) resized
    back onto x's grid gates x (float32, as in the JAX package)."""

    def __init__(self, x_chans: int, g_chans: int, out_chans: int):
        super().__init__()
        names = _Names()
        self.W_x = names(Conv(x_chans, out_chans, 2, padding="VALID", use_bias=False, stride=2))
        self.W_g = names(Conv(g_chans, out_chans, 1))
        self.psi = names(Conv(out_chans, 1, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in (self.W_x, self.W_g, self.psi):
            conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        wx = self.W_x(x)
        wg = bilinear_resize(self.W_g(g), wx.shape[2], wx.shape[3])
        a = torch.sigmoid(self.psi(F.relu(wx + wg)))
        return bilinear_resize(a, x.shape[2], x.shape[3]) * x


class AttentionUnet(_Trunk):
    """The fastMRI U-Net with attention-gated skips: the gate takes the skip
    and the decoder feature before its upsampling; the concat is [decoder,
    gated skip]."""

    first_conv = "down_sample_layers.0.layers.0.weight"

    def __init__(self, in_chans: int, out_chans: int, chans: int = 32, num_pool_layers: int = 4,
                 drop_prob: float = 0.0, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        names = _Names()
        self.down_sample_layers = nn.ModuleList()
        ch, cin = chans, in_chans
        for i in range(num_pool_layers):
            self.down_sample_layers.append(names(_conv_block(ConvBlock(cin, ch, drop_prob, dtype))))
            cin = ch
            if i < num_pool_layers - 1:
                ch *= 2
        self.conv = names(_conv_block(ConvBlock(ch, ch * 2, drop_prob, dtype)))
        self.gates, self.up_transpose_conv, self.up_conv = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for i in range(num_pool_layers):
            self.gates.append(names(AttentionGate(ch, 2 * ch, ch)))
            self.up_transpose_conv.append(names(_transpose_block(TransposeConvBlock(2 * ch, ch, dtype))))
            self.up_conv.append(names(_conv_block(ConvBlock(2 * ch, ch, drop_prob, dtype))))
            if i < num_pool_layers - 1:
                ch //= 2
        self.final = names(Conv(ch, out_chans, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        skips = []
        for block in self.down_sample_layers:
            x = block(x, train)
            skips.append(x)
            x = F.avg_pool2d(x, 2, 2)
        x = self.conv(x, train)
        for gate, up, block in zip(self.gates, self.up_transpose_conv, self.up_conv):
            skip = skips.pop()
            gated = gate(skip.float(), x.float())
            if self.dtype is not None:
                gated = gated.to(self.dtype)
            x = _reflect_to(up(x), gated)
            x = block(torch.cat([x, gated], 1), train)
        x = self.final(x)
        return x if self.dtype is None else x.float()


# ---------------------------------------------------------------- Lambda UNet


class LambdaLayer(nn.Module):
    """Lambda layer: the content lambda (keys softmaxed over positions in
    float32), the position lambda (a Conv3d(u -> k, (1, rk, rk)) over the
    value map [b, u, v, H, W], SAME) and, for ``temporal_kernel`` >= 3, the
    temporal lambda (a Conv2d(u -> k, (1, tk)) over rows grouped (g, t) by
    ``num_slices``). q and v go through BatchNorm; the channel splits of q, k
    and v are channel-major (head, then depth)."""

    def __init__(self, in_chans: int, out_channels: int, query_depth: int = 16, intra_depth: int = 1,
                 receptive_kernel: int = 3, temporal_kernel: int = 1, heads: int = 4, num_slices: int = 1,
                 live_bn: bool = False, dtype=None):
        super().__init__()
        if out_channels % heads:
            raise ValueError("out_channels must be divisible by the number of heads")
        if temporal_kernel >= 3 and (temporal_kernel > num_slices or temporal_kernel % 2 != 1):
            raise ValueError("temporal_kernel must be odd and <= num_slices")
        self.kd, self.u, self.heads, self.vd = query_depth, intra_depth, heads, out_channels // heads
        self.num_slices = num_slices
        self.dtype = as_torch_dtype(dtype)
        kd, u, vd = self.kd, self.u, self.vd
        names = _Names()
        self.to_q = names(Conv(in_chans, kd * heads, 1, use_bias=False, dtype=dtype))
        self.q_bn = names(BatchNorm(kd * heads, live=live_bn))
        self.to_k = names(Conv(in_chans, kd * u, 1, use_bias=False, dtype=dtype))
        self.to_v = names(Conv(in_chans, vd * u, 1, use_bias=False, dtype=dtype))
        self.v_bn = names(BatchNorm(vd * u, live=live_bn))
        self.pos_conv = names(Conv3d(u, kd, (1, receptive_kernel, receptive_kernel), dtype=dtype))
        self.temp_conv = names(Conv(u, kd, (1, temporal_kernel), dtype=dtype)) if temporal_kernel >= 3 else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        b, _, hh, ww = x.shape
        kd, u, h, vd, n = self.kd, self.u, self.heads, self.vd, hh * ww
        q = self.q_bn(self.to_q(x), train).reshape(b, h, kd, n)
        k = self.to_k(x).reshape(b, u, kd, n)
        v = self.v_bn(self.to_v(x), train).reshape(b, u, vd, n)
        k = torch.softmax(k.float(), dim=-1).to(k.dtype)
        lam_c = torch.einsum("bukm,buvm->bkv", k, v)
        y = torch.einsum("bhkn,bkv->bhvn", q, lam_c)
        lam_p = self.pos_conv(v.reshape(b, u, vd, hh, ww)).reshape(b, kd, vd, n)
        y = y + torch.einsum("bhkn,bkvn->bhvn", q, lam_p)
        if self.temp_conv is not None:
            t = self.num_slices
            g = b // t
            v_t = v.reshape(g, t, u, vd, n).permute(0, 4, 2, 3, 1).reshape(g * n, u, vd, t)
            lam_t = self.temp_conv(v_t).reshape(g, n, kd, vd, t).permute(0, 4, 2, 3, 1).reshape(b, kd, vd, n)
            y = y + torch.einsum("bhkn,bkvn->bhvn", q, lam_t)
        return y.reshape(b, h * vd, hh, ww)


class LambdaBlock(nn.Module):
    """(LambdaLayer, InstanceNorm, LeakyReLU(0.2), dropout) twice, with
    max(1, out_chans // 32) heads."""

    def __init__(self, in_chans: int, out_chans: int, drop_prob: float = 0.0, query_depth: int = 16,
                 intra_depth: int = 4, receptive_kernel: int = 3, temporal_kernel: int = 1, num_slices: int = 1,
                 live_bn: bool = False, dtype=None):
        super().__init__()
        names = _Names()
        kw = dict(query_depth=query_depth, intra_depth=intra_depth, receptive_kernel=receptive_kernel,
                  temporal_kernel=temporal_kernel, heads=max(1, out_chans // 32), num_slices=num_slices,
                  live_bn=live_bn, dtype=dtype)
        self.layers = nn.ModuleList([names(LambdaLayer(in_chans, out_chans, **kw)),
                                     names(LambdaLayer(out_chans, out_chans, **kw))])
        self.norm = InstanceNorm()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self.layers:
            x = _dropout(F.leaky_relu(self.norm(layer(x, train)), 0.2), self.drop_prob, train)
        return x


class LambdaUnet(_Trunk):
    """The fastMRI U-Net skeleton with LambdaBlocks in place of ConvBlocks
    (average-pool downs, TransposeConvBlock ups, a final 1x1 conv)."""

    first_conv = "down_sample_layers.0.layers.0.to_q.weight"

    def __init__(self, in_chans: int, out_chans: int, chans: int = 32, num_pool_layers: int = 4,
                 drop_prob: float = 0.0, query_depth: int = 16, intra_depth: int = 4, receptive_kernel: int = 3,
                 temporal_kernel: int = 1, num_slices: int = 1, live_bn: bool = False, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        kw = dict(drop_prob=drop_prob, query_depth=query_depth, intra_depth=intra_depth,
                  receptive_kernel=receptive_kernel, temporal_kernel=temporal_kernel, num_slices=num_slices,
                  live_bn=live_bn, dtype=dtype)
        names = _Names()
        self.down_sample_layers = nn.ModuleList()
        ch, cin = chans, in_chans
        for i in range(num_pool_layers):
            self.down_sample_layers.append(names(LambdaBlock(cin, ch, **kw)))
            cin = ch
            if i < num_pool_layers - 1:
                ch *= 2
        self.conv = names(LambdaBlock(ch, ch * 2, **kw))
        self.up_transpose_conv, self.up_conv = nn.ModuleList(), nn.ModuleList()
        for i in range(num_pool_layers):
            self.up_transpose_conv.append(names(_transpose_block(TransposeConvBlock(2 * ch, ch, dtype))))
            self.up_conv.append(names(LambdaBlock(2 * ch, ch, **kw)))
            if i < num_pool_layers - 1:
                ch //= 2
        self.final = names(Conv(ch, out_chans, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        skips = []
        for block in self.down_sample_layers:
            x = block(x, train)
            skips.append(x)
            x = F.avg_pool2d(x, 2, 2)
        x = self.conv(x, train)
        for up, block in zip(self.up_transpose_conv, self.up_conv):
            skip = skips.pop()
            x = block(torch.cat([_reflect_to(up(x), skip), skip], 1), train)
        x = self.final(x)
        return x if self.dtype is None else x.float()


# ---------------------------------------------------------------- VNet


class _PReLU(nn.Module):
    """torch's ``nn.PReLU``: one learned slope (shape (1,), 0.25), as the JAX
    package's ``where(x >= 0, x, alpha * x)``."""

    flax_params = {"alpha": "alpha"}

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator
        nn.init.constant_(self.alpha, 0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class _Act(nn.Module):
    """V-Net's activation: elu, relu, leakyrelu (0.01) or prelu (a
    ``_PReLU_{k}`` scope of the parent, ``prelu``)."""

    def __init__(self, name: str, names: _Names):
        super().__init__()
        self.name = str(name).lower()
        if self.name not in ("elu", "relu", "leakyrelu", "prelu"):
            raise ValueError(f"Activation {name!r} not supported (relu/prelu/leakyrelu/elu)")
        self.prelu = names(_PReLU()) if self.name == "prelu" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "elu":
            return F.elu(x)
        if self.name == "relu":
            return F.relu(x)
        if self.name == "leakyrelu":
            return torch.where(x >= 0, x, 0.01 * x)
        return self.prelu(x)


class _LUConv(nn.Module):
    """5x5 conv, BatchNorm, activation."""

    def __init__(self, in_chans: int, channels: int, act: str = "elu", use_bias: bool = False,
                 live_bn: bool = False, dtype=None):
        super().__init__()
        names = _Names()
        self.conv = names(Conv(in_chans, channels, 5, use_bias=use_bias, dtype=dtype))
        self.bn = names(BatchNorm(channels, live=live_bn))
        self.act = _Act(act, names)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.act(self.bn(self.conv(x), train))


class _VNetDown(nn.Module):
    """Strided 2x2 conv doubling the channels, BatchNorm, activation, channel
    dropout, ``convs`` LUConvs, the residual add and the activation."""

    def __init__(self, in_channels: int, convs: int, act: str = "elu", dropout_prob: float = 0.0,
                 use_bias: bool = False, live_bn: bool = False, dtype=None):
        super().__init__()
        out = 2 * in_channels
        names = _Names()
        self.down_conv = names(Conv(in_channels, out, 2, padding="VALID", use_bias=use_bias, dtype=dtype, stride=2))
        self.bn1 = names(BatchNorm(out, live=live_bn))
        self.act1 = _Act(act, names)
        self.dropout_prob = dropout_prob
        self.ops = nn.ModuleList([names(_LUConv(out, out, act, use_bias, live_bn, dtype)) for _ in range(convs)])
        self.act2 = _Act(act, names)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        down = self.act1(self.bn1(self.down_conv(x), train))
        out = dropout2d(down, self.dropout_prob, train)
        for op in self.ops:
            out = op(out, train)
        return self.act2(out + down)


class _VNetUp(nn.Module):
    """Channel dropout of x (``dropout_prob``) and of the skip (0.5, always),
    a 2x2 transpose conv to out // 2 (with bias), BatchNorm, activation, the
    concat with the skip, ``convs`` LUConvs, the residual add of the concat
    and the activation."""

    def __init__(self, in_channels: int, out_channels: int, convs: int, act: str = "elu", dropout_prob: float = 0.0,
                 live_bn: bool = False, dtype=None):
        super().__init__()
        names = _Names()
        self.dropout_prob = dropout_prob
        self.up_conv = names(ConvTranspose(in_channels, out_channels // 2, 2, dtype=dtype, use_bias=True))
        self.bn1 = names(BatchNorm(out_channels // 2, live=live_bn))
        self.act1 = _Act(act, names)
        self.ops = nn.ModuleList([names(_LUConv(out_channels, out_channels, act, live_bn=live_bn, dtype=dtype))
                                  for _ in range(convs)])
        self.act2 = _Act(act, names)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = dropout2d(x, self.dropout_prob, train)
        skip = dropout2d(skip, 0.5, train)
        out = self.act1(self.bn1(self.up_conv(x), train))
        xcat = torch.cat([out, skip.to(out.dtype)], 1)
        out = xcat
        for op in self.ops:
            out = op(out, train)
        return self.act2(out + xcat)


class VNet(_Trunk):
    """V-Net's fixed 16 -> 256 schedule: the input transition (a 5x5 conv to
    16 channels plus the input tiled to 16 channels, so 16 % in_chans must be
    0), four down and four up transitions, the output transition (5x5 conv,
    BatchNorm, activation, 1x1 conv)."""

    first_conv = "in_conv.weight"

    def __init__(self, in_chans: int, out_chans: int = 1, act: str = "elu", drop_prob: float = 0.5,
                 use_bias: bool = False, live_bn: bool = False, dtype=None):
        super().__init__()
        if 16 % in_chans != 0:
            raise ValueError(f"16 should be divisible by in_chans, got {in_chans}")
        self.in_chans = in_chans
        self.dtype = as_torch_dtype(dtype)
        lb, names = live_bn, _Names()
        self.in_conv = names(Conv(in_chans, 16, 5, use_bias=use_bias, dtype=dtype))
        self.in_bn = names(BatchNorm(16, live=lb))
        self.in_act = _Act(act, names)
        self.down_tr32 = names(_VNetDown(16, 1, act, use_bias=use_bias, live_bn=lb, dtype=dtype))
        self.down_tr64 = names(_VNetDown(32, 2, act, use_bias=use_bias, live_bn=lb, dtype=dtype))
        self.down_tr128 = names(_VNetDown(64, 3, act, drop_prob, use_bias, lb, dtype))
        self.down_tr256 = names(_VNetDown(128, 2, act, drop_prob, use_bias, lb, dtype))
        self.up_tr256 = names(_VNetUp(256, 256, 2, act, drop_prob, lb, dtype))
        self.up_tr128 = names(_VNetUp(256, 128, 2, act, drop_prob, lb, dtype))
        self.up_tr64 = names(_VNetUp(128, 64, 1, act, live_bn=lb, dtype=dtype))
        self.up_tr32 = names(_VNetUp(64, 32, 1, act, live_bn=lb, dtype=dtype))
        self.out_conv = names(Conv(32, out_chans, 5, use_bias=use_bias, dtype=dtype))
        self.out_bn = names(BatchNorm(out_chans, live=lb))
        self.out_act = _Act(act, names)
        self.final = names(Conv(out_chans, out_chans, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        out = self.in_bn(self.in_conv(x), train)
        out16 = self.in_act(out + x.repeat(1, 16 // self.in_chans, 1, 1))
        out32 = self.down_tr32(out16, train)
        out64 = self.down_tr64(out32, train)
        out128 = self.down_tr128(out64, train)
        out256 = self.down_tr256(out128, train)
        y = self.up_tr256(out256, out128, train)
        y = self.up_tr128(y, out64, train)
        y = self.up_tr64(y, out32, train)
        y = self.up_tr32(y, out16, train)
        y = self.final(self.out_act(self.out_bn(self.out_conv(y), train)))
        return y if self.dtype is None else y.float()


# ---------------------------------------------------------------- DynUNet (MONAI)


def _monai_padding(kernel: int, stride: int) -> int:
    """MONAI's get_padding: (k - s + 1) // 2, which must not be negative."""
    p = (kernel - stride + 1) / 2
    if p < 0:
        raise ValueError("padding must not be negative (kernel >= stride - 1)")
    return int(p)


def _monai_conv(cin: int, cout: int, kernel: int, stride: int, use_bias: bool = False, dtype=None) -> Conv:
    """torch's Conv2d with MONAI's symmetric padding."""
    return Conv(cin, cout, kernel, padding=_monai_padding(kernel, stride), use_bias=use_bias, dtype=dtype,
                stride=stride)


class _TorchConvTranspose(nn.Module):
    """torch's ConvTranspose2d(k, s, p, 2p + s - k) with MONAI's p: an output
    of in * s (flax's VALID transpose conv cropped at p), no bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, use_bias: bool = False, dtype=None):
        super().__init__()
        p = _monai_padding(kernel, stride)
        self.conv = _Names()(ConvTranspose(cin, cout, kernel, dtype, stride=stride, padding=p,
                                           output_padding=2 * p + stride - kernel, use_bias=use_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetBasicBlock(nn.Module):
    """MONAI's UnetBasicBlock: (conv, InstanceNorm, LeakyReLU(0.01)) twice,
    the first conv strided."""

    def __init__(self, cin: int, out_channels: int, kernel_size: int = 3, stride: int = 1, dtype=None):
        super().__init__()
        names = _Names()
        self.conv1 = names(_monai_conv(cin, out_channels, kernel_size, stride, dtype=dtype))
        self.conv2 = names(_monai_conv(out_channels, out_channels, kernel_size, 1, dtype=dtype))
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        x = F.leaky_relu(self.norm(self.conv1(x)), 0.01)
        return F.leaky_relu(self.norm(self.conv2(x)), 0.01)


class UnetResBlock(nn.Module):
    """MONAI's UnetResBlock: conv-IN-LeakyReLU, conv-IN, a strided 1x1
    shortcut conv where the shape changes, the shortcut always
    instance-normalised, add, LeakyReLU(0.01)."""

    def __init__(self, cin: int, out_channels: int, kernel_size: int = 3, stride: int = 1, dtype=None):
        super().__init__()
        names = _Names()
        self.conv1 = names(_monai_conv(cin, out_channels, kernel_size, stride, dtype=dtype))
        self.conv2 = names(_monai_conv(out_channels, out_channels, kernel_size, 1, dtype=dtype))
        self.conv3 = names(_monai_conv(cin, out_channels, 1, stride, dtype=dtype)) \
            if cin != out_channels or stride != 1 else None
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        out = F.leaky_relu(self.norm(self.conv1(x)), 0.01)
        out = self.norm(self.conv2(out))
        residual = x if self.conv3 is None else self.conv3(x)
        residual = self.norm(residual.to(out.dtype))
        return F.leaky_relu(out + residual, 0.01)


class UnetUpBlock(nn.Module):
    """MONAI's UnetUpBlock: transpose conv (kernel = stride = the upsample
    kernel), concat [up, skip], UnetBasicBlock."""

    def __init__(self, cin: int, out_channels: int, kernel_size: int = 3, upsample_kernel_size: int = 2,
                 trans_bias: bool = False, dtype=None):
        super().__init__()
        names = _Names()
        self.transp_conv = names(_TorchConvTranspose(cin, out_channels, upsample_kernel_size, upsample_kernel_size,
                                                     trans_bias, dtype))
        self.conv_block = names(UnetBasicBlock(2 * out_channels, out_channels, kernel_size, 1, dtype))

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.transp_conv(x)
        return self.conv_block(torch.cat([out, skip.to(out.dtype)], 1), train)


class UnetOutBlock(nn.Module):
    """A 1x1 conv with bias; float32 logits."""

    def __init__(self, cin: int, out_channels: int, dtype=None):
        super().__init__()
        self.conv = _Names()(Conv(cin, out_channels, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x).float()


class DynUNet(_Trunk):
    """MONAI's DynUNet: an input block, strided downsamples, a bottleneck and
    UnetUpBlocks, with nnU-Net's filters min(2 ** (5 + i), 512) unless
    ``filters`` is given. With ``deep_supervision`` a train-mode forward
    returns [B, 1 + heads, classes, H, W]: the logits, then the heads of the
    up outputs 1..deep_supr_num (shallowest first), each resized (nearest)
    onto the logits' grid."""

    first_conv = "input_block.conv1.weight"

    def __init__(self, in_chans: int, out_chans: int, kernel_size: Sequence[int] = (3, 3, 3, 3),
                 strides: Sequence[int] = (1, 2, 2, 2), filters: Optional[Sequence[int]] = None,
                 res_block: bool = False, deep_supervision: bool = False, deep_supr_num: int = 1, dtype=None):
        super().__init__()
        n = len(strides)
        if len(kernel_size) != n or n < 3:
            raise ValueError("kernel_size and strides must have equal length >= 3")
        self.dtype = as_torch_dtype(dtype)
        self.deep_supervision, self.deep_supr_num = deep_supervision, deep_supr_num
        filters = list(filters) if filters is not None else [min(2 ** (5 + i), 512) for i in range(n)]
        block = UnetResBlock if res_block else UnetBasicBlock
        names = _Names()
        self.input_block = names(block(in_chans, filters[0], kernel_size[0], strides[0], dtype))
        self.downsamples = nn.ModuleList([names(block(filters[i - 1], filters[i], kernel_size[i], strides[i], dtype))
                                          for i in range(1, n - 1)])
        self.bottleneck = names(block(filters[-2], filters[-1], kernel_size[-1], strides[-1], dtype))
        self.upsamples, self.heads = nn.ModuleList(), nn.ModuleList()
        self.head_levels: List[int] = []
        cin = filters[-1]
        for i in range(n - 1):
            j = n - 2 - i
            self.upsamples.append(names(UnetUpBlock(cin, filters[j], kernel_size[j + 1], strides[j + 1],
                                                    dtype=dtype)))
            cin = filters[j]
            if deep_supervision and 0 < j <= deep_supr_num:
                self.heads.append(names(UnetOutBlock(cin, out_chans, dtype)))
                self.head_levels.append(i)
        self.output_block = names(UnetOutBlock(cin, out_chans, dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        out = self.input_block(x, train)
        down_outs = [out]
        for block in self.downsamples:
            out = block(out, train)
            down_outs.append(out)
        out = self.bottleneck(out, train)
        heads = []
        for i, up in enumerate(self.upsamples):
            out = up(out, down_outs[len(down_outs) - 1 - i], train)
            if i in self.head_levels:
                heads.append(self.heads[self.head_levels.index(i)](out))
        logits = self.output_block(out)
        if self.deep_supervision and train:
            heads = [nearest_resize(h, logits.shape[2], logits.shape[3]) for h in heads]
            return torch.stack([logits] + heads[::-1], dim=1)
        return logits


# ---------------------------------------------------------------- ViT / UNETR


class SABlock(nn.Module):
    """ViT self-attention: one fused qkv Dense (channel split (qkv, heads,
    dim)), per-head scaled dot products (scaled after the product) with a
    float32 softmax, the output Dense. Two plain ``torch.matmul``s, as the
    JAX package's two einsums."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0, qkv_bias: bool = False,
                 dtype=None):
        super().__init__()
        names = _Names()
        self.num_heads, self.hidden_size, self.dropout_rate = num_heads, hidden_size, dropout_rate
        self.qkv = names(Dense(hidden_size, 3 * hidden_size, use_bias=qkv_bias, dtype=dtype))
        self.out_proj = names(Dense(hidden_size, hidden_size, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.num_heads
        d = self.hidden_size // h
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        att = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
        att = _dropout(torch.softmax(att.float(), dim=-1).to(att.dtype), self.dropout_rate, train)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, n, self.hidden_size)
        return _dropout(self.out_proj(out), self.dropout_rate, train)


class MLPBlock(nn.Module):
    """Dense, exact GELU, dropout, Dense, dropout."""

    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0, dtype=None):
        super().__init__()
        names = _Names()
        self.linear1 = names(Dense(hidden_size, mlp_dim, dtype=dtype))
        self.linear2 = names(Dense(mlp_dim, hidden_size, dtype=dtype))
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _dropout(F.gelu(self.linear1(x), approximate="none"), self.dropout_rate, train)
        return _dropout(self.linear2(x), self.dropout_rate, train)


def _token_instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch's InstanceNorm2d on a [B, L, D] token tensor, which it reads as
    one unbatched (C, H, W) image: each batch element normalised over all its
    tokens and features jointly, float32, no affine (not a LayerNorm)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2), keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + SA(norm(x)), then x + MLP(norm(x))."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int, dropout_rate: float = 0.0,
                 qkv_bias: bool = False, dtype=None):
        super().__init__()
        names = _Names()
        self.attn = names(SABlock(hidden_size, num_heads, dropout_rate, qkv_bias, dtype))
        self.mlp = names(MLPBlock(hidden_size, mlp_dim, dropout_rate, dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x + self.attn(_token_instance_norm(x), train)
        return x + self.mlp(_token_instance_norm(x), train)


class PatchEmbedding(nn.Module):
    """Patches (a p x p stride-p conv, or the perceptron's rearrange
    ``b c (h p1) (w p2) -> b (h w) (p1 p2 c)`` and a Dense) plus the learned
    position embeddings [1, num_patches, hidden]."""

    flax_params = {"position_embeddings": "position_embeddings"}

    def __init__(self, in_chans: int, patch_size: int, hidden_size: int, num_patches: int, pos_embed: str = "conv",
                 dropout_rate: float = 0.0, dtype=None):
        super().__init__()
        self.patch_size, self.pos_embed, self.dropout_rate = patch_size, pos_embed, dropout_rate
        names = _Names()
        if pos_embed == "conv":
            self.patch_embeddings = names(Conv(in_chans, hidden_size, patch_size, padding="VALID", dtype=dtype,
                                               stride=patch_size))
        elif pos_embed == "perceptron":
            self.patch_embeddings = names(Dense(patch_size * patch_size * in_chans, hidden_size, dtype=dtype))
        else:
            raise ValueError(f"Unknown pos_embed {pos_embed!r}")
        self.position_embeddings = nn.Parameter(torch.zeros(1, num_patches, hidden_size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``truncated_normal(0.02, -2, 2)``: std 0.02 cut at +-0.04."""
        nn.init.trunc_normal_(self.position_embeddings, std=0.02, a=-0.04, b=0.04, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, c, hh, ww = x.shape
        p = self.patch_size
        if self.pos_embed == "conv":
            tok = self.patch_embeddings(x).flatten(2).transpose(1, 2)
        else:
            tok = x.reshape(b, c, hh // p, p, ww // p, p).permute(0, 2, 4, 3, 5, 1).reshape(b, -1, p * p * c)
            tok = self.patch_embeddings(tok)
        return _dropout(tok + self.position_embeddings.to(tok.dtype), self.dropout_rate, train)


class _LayerNorm(nn.Module):
    """torch's LayerNorm over the last axis, float32, with ``scale`` and
    ``bias``."""

    flax_params = {"scale": "weight", "bias": "bias"}

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
        return ((xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias).to(x.dtype)


class ViT(nn.Module):
    """Patch embedding, ``num_layers`` TransformerBlocks (every hidden state
    returned) and a final LayerNorm."""

    def __init__(self, in_chans: int, num_patches: int, patch_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_layers: int = 12, num_heads: int = 12, pos_embed: str = "conv",
                 dropout_rate: float = 0.0, qkv_bias: bool = False, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        names = _Names()
        self.patch_embedding = names(PatchEmbedding(in_chans, patch_size, hidden_size, num_patches, pos_embed,
                                                    dropout_rate, dtype))
        self.blocks = nn.ModuleList([names(TransformerBlock(hidden_size, mlp_dim, num_heads, dropout_rate, qkv_bias,
                                                            dtype)) for _ in range(num_layers)])
        self.norm = names(_LayerNorm(hidden_size))

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x if self.dtype is None else x.to(self.dtype)
        tok = self.patch_embedding(x, train)
        hidden_states = []
        for block in self.blocks:
            tok = block(tok, train)
            hidden_states.append(tok)
        return self.norm(tok), hidden_states


class UnetrPrUpBlock(nn.Module):
    """A k2 s2 transpose conv, then ``num_layer`` (transpose conv, Basic or Res
    block) stages."""

    def __init__(self, cin: int, out_channels: int, num_layer: int, kernel_size: int = 3,
                 upsample_kernel_size: int = 2, conv_block: bool = True, res_block: bool = True, dtype=None):
        super().__init__()
        up = upsample_kernel_size
        names = _Names()
        block = UnetResBlock if res_block else UnetBasicBlock
        self.transp_conv_init = names(_TorchConvTranspose(cin, out_channels, up, up, dtype=dtype))
        self.blocks = nn.ModuleList()
        for _ in range(num_layer):
            stage = nn.ModuleList([names(_TorchConvTranspose(out_channels, out_channels, up, up, dtype=dtype))])
            if conv_block:
                stage.append(names(block(out_channels, out_channels, kernel_size, 1, dtype)))
            self.blocks.append(stage)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.transp_conv_init(x)
        for stage in self.blocks:
            x = stage[0](x)
            if len(stage) > 1:
                x = stage[1](x, train)
        return x


class UnetrUpBlock(nn.Module):
    """Transpose conv, concat the skip, Basic or Res block."""

    def __init__(self, cin: int, out_channels: int, kernel_size: int = 3, upsample_kernel_size: int = 2,
                 res_block: bool = True, dtype=None):
        super().__init__()
        up = upsample_kernel_size
        names = _Names()
        self.transp_conv = names(_TorchConvTranspose(cin, out_channels, up, up, dtype=dtype))
        block = UnetResBlock if res_block else UnetBasicBlock
        self.conv_block = names(block(2 * out_channels, out_channels, kernel_size, 1, dtype))

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.transp_conv(x)
        return self.conv_block(torch.cat([out, skip.to(out.dtype)], 1), train)


class UNETR(_Trunk):
    """UNETR: the ViT trunk (patch 16, 12 layers) tapped at hidden states 3,
    6 and 9 and at its normed output, a convolutional encoder per tap, a
    transpose-conv decoder. H and W must be multiples of 16; the position
    embeddings are sized by the image's patch count."""

    first_conv = "encoder1.conv1.weight"
    patch_param = "vit.patch_embedding.position_embeddings"

    def __init__(self, in_chans: int, out_chans: int, num_patches: int, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12, pos_embed: str = "conv",
                 conv_block: bool = True, res_block: bool = True, dropout_rate: float = 0.0, qkv_bias: bool = False,
                 dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        f = feature_size
        names = _Names()
        self.vit = names(ViT(in_chans, num_patches, 16, hidden_size, mlp_dim, 12, num_heads, pos_embed, dropout_rate,
                             qkv_bias, dtype))
        basic = UnetResBlock if res_block else UnetBasicBlock
        self.encoder1 = names(basic(in_chans, f, 3, 1, dtype))
        kw = dict(conv_block=conv_block, res_block=res_block, dtype=dtype)
        self.encoder2 = names(UnetrPrUpBlock(hidden_size, f * 2, 2, **kw))
        self.encoder3 = names(UnetrPrUpBlock(hidden_size, f * 4, 1, **kw))
        self.encoder4 = names(UnetrPrUpBlock(hidden_size, f * 8, 0, **kw))
        self.decoder5 = names(UnetrUpBlock(hidden_size, f * 8, res_block=res_block, dtype=dtype))
        self.decoder4 = names(UnetrUpBlock(f * 8, f * 4, res_block=res_block, dtype=dtype))
        self.decoder3 = names(UnetrUpBlock(f * 4, f * 2, res_block=res_block, dtype=dtype))
        self.decoder2 = names(UnetrUpBlock(f * 2, f, res_block=res_block, dtype=dtype))
        self.out = names(UnetOutBlock(f, out_chans, dtype))
        self.dtype = as_torch_dtype(dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, _, hh, ww = x.shape
        if hh % 16 or ww % 16:
            raise ValueError("UNETR requires H and W divisible by the fixed patch size 16")
        x = x if self.dtype is None else x.to(self.dtype)
        fh, fw = hh // 16, ww // 16

        def proj_feat(tokens):
            return tokens.transpose(1, 2).reshape(b, self.hidden_size, fh, fw)

        normed, hidden = self.vit(x, train)
        enc1 = self.encoder1(x, train)
        enc2 = self.encoder2(proj_feat(hidden[3]), train)
        enc3 = self.encoder3(proj_feat(hidden[6]), train)
        enc4 = self.encoder4(proj_feat(hidden[9]), train)
        dec3 = self.decoder5(proj_feat(normed), enc4, train)
        dec2 = self.decoder4(dec3, enc3, train)
        dec1 = self.decoder3(dec2, enc2, train)
        return self.out(self.decoder2(dec1, enc1, train))


# ---------------------------------------------------------------- UNet3D


class Conv3dBlock(nn.Module):
    """(3x3x3 SAME conv without bias, InstanceNorm, LeakyReLU(0.2), dropout)
    twice."""

    def __init__(self, cin: int, out_chans: int, drop_prob: float = 0.0, dtype=None):
        super().__init__()
        names = _Names()
        self.conv1 = names(Conv3d(cin, out_chans, 3, use_bias=False, dtype=dtype))
        self.conv2 = names(Conv3d(out_chans, out_chans, 3, use_bias=False, dtype=dtype))
        self.norm = InstanceNorm()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, train: bool = False, norm_dims=None) -> torch.Tensor:
        for conv in (self.conv1, self.conv2):
            x = _dropout(F.leaky_relu(self.norm(conv(x), norm_dims), 0.2), self.drop_prob, train)
        return x


class TransposeConv3dBlock(nn.Module):
    """(1, 2, 2) transpose conv without bias, InstanceNorm, LeakyReLU(0.2):
    in-plane upsampling, the depth kept."""

    def __init__(self, cin: int, out_chans: int, dtype=None):
        super().__init__()
        self.conv = _Names()(ConvTranspose3d(cin, out_chans, (1, 2, 2), dtype=dtype))
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor, norm_dims=None) -> torch.Tensor:
        return F.leaky_relu(self.norm(self.conv(x), norm_dims), 0.2)


class UNet3D(_Trunk):
    """The fastMRI U-Net pattern over NCDHW volumes with 3D blocks and
    in-plane (1, 2, 2) pooling and upsampling.

    An NCHW input [B, C, H, W] is taken as the JAX package takes a 4D batch:
    flax's 3D convs and pooling read it as one unbatched volume, so the batch
    axis is the depth (the convs mix neighbouring rows of the batch), while
    its InstanceNorms normalise each row over H and W alone. The output is
    then NCHW too."""

    first_conv = "down_sample_layers.0.conv1.weight"

    def __init__(self, in_chans: int, out_chans: int, chans: int = 16, num_pool_layers: int = 3,
                 drop_prob: float = 0.0, dtype=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        names = _Names()
        self.down_sample_layers = nn.ModuleList()
        ch, cin = chans, in_chans
        for i in range(num_pool_layers):
            self.down_sample_layers.append(names(Conv3dBlock(cin, ch, drop_prob, dtype)))
            cin = ch
            if i < num_pool_layers - 1:
                ch *= 2
        self.conv = names(Conv3dBlock(ch, ch * 2, drop_prob, dtype))
        self.up_transpose_conv, self.up_conv = nn.ModuleList(), nn.ModuleList()
        for i in range(num_pool_layers):
            self.up_transpose_conv.append(names(TransposeConv3dBlock(2 * ch, ch, dtype)))
            self.up_conv.append(names(Conv3dBlock(2 * ch, ch, drop_prob, dtype)))
            if i < num_pool_layers - 1:
                ch //= 2
        self.final = names(Conv3d(ch, out_chans, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        rows = x.ndim == 4
        nd = None
        if rows:  # [B, C, H, W] -> one volume [1, C, B, H, W], normalised per row
            x, nd = x.transpose(0, 1)[None], (3, 4)
        out = x if self.dtype is None else x.to(self.dtype)
        stack = []
        for block in self.down_sample_layers:
            out = block(out, train, nd)
            stack.append(out)
            b, c, d, h, w = out.shape  # (1, 2, 2) average pooling, a 2D pool over the depth's planes
            out = F.avg_pool2d(out.reshape(b, c * d, h, w), 2, 2).reshape(b, c, d, h // 2, w // 2)
        out = self.conv(out, train, nd)
        for up, block in zip(self.up_transpose_conv, self.up_conv):
            skip = stack.pop()
            out = _reflect_to(up(out, nd), skip)
            out = block(torch.cat([out, skip], 1), train, nd)
        out = self.final(out)
        out = out if self.dtype is None else out.float()
        return out[0].transpose(0, 1) if rows else out
