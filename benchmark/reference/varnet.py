"""The end-to-end variational network as published (Sriram et al.,
arXiv:2004.06688; ``projects/reconstruction/conf/base_vn_train.yaml``), in
plain PyTorch, with the coil maps given.

k-space is refined cascade by cascade:
``k <- k - w M (k - y) - E(U(E^H k))`` with E = FFT(s_c .) and E^H its
adjoint, and the output is E^H k. U is a normalised U-Net: the two real
channels of the image are each normalised by their mean and standard
deviation (ddof 1), zero-padded to a multiple of ``padding_size + 1``, passed
through a U-Net (3x3 convolutions without bias, instance norm, LeakyReLU 0.2,
twice a level; 2x2 average pooling down, 2x2 stride-2 transpose convolutions
up with the skip concatenated; a 1x1 convolution with bias at the end),
cropped and un-normalised. The data term is computed as written whatever the
mask.

Weights are a dict keyed as the benchmark names them
(``cascades.{i}.model.unet.down_sample_layers.{k}.layers.{0,4}.weight`` and
so on); convolution weights are [out, in, kH, kW], transpose convolution
weights [in, out, kH, kW].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from reference.common import Precision, sense_expand, sense_reduce

__all__ = ["forward", "unet"]

EPS = 1e-5  # instance norm


def _norm_act(x):
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return F.leaky_relu((x - mean) * torch.rsqrt(var + EPS), 0.2)


def _block(w, p, x, prec):
    x = _norm_act(prec.conv(x, w[p + "layers.0.weight"], padding=1))
    return _norm_act(prec.conv(x, w[p + "layers.4.weight"], padding=1))


def unet(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor, pools: int, prec: Precision) -> torch.Tensor:
    """The U-Net of prefix ``p`` on x [B, 2, H, W] (H, W divisible by 2^pools)."""
    skips = []
    for k in range(pools):
        x = _block(w, f"{p}down_sample_layers.{k}.", x, prec)
        skips.append(x)
        x = F.avg_pool2d(x, 2, 2)
    x = _block(w, f"{p}conv.", x, prec)
    for j in range(pools):
        x = _norm_act(prec.conv_transpose(x, w[f"{p}up_transpose_conv.{j}.layers.0.weight"], 2))
        x = torch.cat([x, skips.pop()], dim=1)
        if j < pools - 1:
            x = _block(w, f"{p}up_conv.{j}.", x, prec)
        else:
            x = _block(w, f"{p}up_conv.{j}.0.", x, prec)
            x = prec.conv(x, w[f"{p}up_conv.{j}.1.weight"], w[f"{p}up_conv.{j}.1.bias"])
    return x


def _norm_unet(w, p, image, cfg, prec):
    x = torch.stack([image.real, image.imag], dim=1)
    b, _, h, wd = x.shape
    flat = x.reshape(b, 2, -1)
    mean = flat.mean(-1, keepdim=True)
    std = flat.std(-1, keepdim=True, correction=1) + 1e-12
    x = ((flat - mean) / std).reshape(b, 2, h, wd)
    ps = cfg["padding_size"]
    hm, wm = ((h - 1) | ps) + 1, ((wd - 1) | ps) + 1
    top, left = (hm - h) // 2, (wm - wd) // 2
    x = F.pad(x, (left, wm - wd - left, top, hm - h - top))
    x = unet(w, p + "model.unet.", x, cfg["pooling_layers"], prec)[:, :, top:top + h, left:left + wd]
    x = (x.reshape(b, 2, -1) * std + mean).reshape(b, 2, h, wd)
    return torch.complex(x[:, 0], x[:, 1])


def forward(w: Dict[str, torch.Tensor], cfg: dict, y: torch.Tensor, sens: torch.Tensor, mask: torch.Tensor,
            centered: bool, norm: str, prec: Precision = Precision()):
    """The reconstruction [B, H, W] complex, as a list of one (the
    references' common form). ``y``, ``sens``: [B, C, H, W] complex;
    ``mask``: [B, 1, H, W] real."""
    k = y
    for i in range(cfg["num_cascades"]):
        p = f"cascades.{i}."
        u = _norm_unet(w, p, sense_reduce(k, sens, centered, norm), cfg, prec)
        k = k - w[p + "dc_weight"] * mask * (k - y) - sense_expand(u, sens, centered, norm)
    return [sense_reduce(k, sens, centered, norm)]
