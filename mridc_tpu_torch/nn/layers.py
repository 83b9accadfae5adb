"""Shared NN building blocks (counterpart of ``mridc_tpu/nn/layers.py``):
padded convolutions with a compute dtype.

Layout: NCHW tensors in ``torch.channels_last`` memory format, which is
physically NHWC like the JAX package's layout. Kernels are OIHW (the JAX
package's HWIO transposed); parameters stay float32 and are cast to the
compute dtype at each call, as flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv", "ConvNonlinear", "as_torch_dtype", "activation", "replicate_pad", "fan_in_truncated_normal_"]

# std of a unit normal cut at +-2, by which flax's truncated_normal divides
TRUNC_STD = 0.87962566103423978


def fan_in_truncated_normal_(
    weight: torch.Tensor, scale: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` on an OIHW
    kernel: a normal with std s = sqrt(scale / fan_in) / TRUNC_STD cut at +-2s,
    whose variance is scale / fan_in (``kaiming_normal``: scale 2,
    ``lecun_normal``: scale 1)."""
    s = math.sqrt(scale / weight[0].numel()) / TRUNC_STD
    return nn.init.trunc_normal_(weight, std=s, a=-2 * s, b=2 * s, generator=generator)


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """None | torch dtype | name ("bfloat16", "float32", ...) -> torch dtype or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype).lower(), None)
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f"Unknown compute dtype {dtype!r}")
    return out


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def activation(x: torch.Tensor, nonlinear: Optional[str]) -> torch.Tensor:
    if nonlinear is None or nonlinear.lower() == "none":
        return x
    if nonlinear.lower() == "relu":
        return F.relu(x)
    if nonlinear.lower() == "leakyrelu":
        return F.leaky_relu(x, 0.01)
    raise ValueError(f"Unknown nonlinearity {nonlinear!r}")


class Conv(nn.Conv2d):
    """Stride-1 conv with flax padding semantics: ``"SAME"`` zero-pads
    ``d*(k-1)`` split low-first (torch's ``padding="same"``), ``"VALID"`` pads
    nothing. ``dtype`` is the compute dtype (None: promote input and weight).

    ``pointwise_matmul``, ``lane_fold`` and ``fold_pad_mode`` select TPU
    lowerings in the JAX package that leave the numbers unchanged; they are
    accepted and ignored.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Union[int, Tuple[int, int]] = 3,
        kernel_dilation: Union[int, Tuple[int, int]] = 1,
        padding: str = "SAME",
        use_bias: bool = True,
        dtype=None,
        pointwise_matmul: bool = False,
        lane_fold: bool = False,
        fold_pad_mode: str = "zero",
    ):
        del pointwise_matmul, lane_fold, fold_pad_mode
        pad = {"SAME": "same", "VALID": 0}[padding.upper()]
        super().__init__(
            in_features, features, _pair(kernel_size), dilation=_pair(kernel_dilation), padding=pad, bias=use_bias
        )
        self.compute_dtype = as_torch_dtype(dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``nn.Conv``'s defaults: ``lecun_normal`` kernel, zero bias."""
        fan_in_truncated_normal_(self.weight, 1.0, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def replicate_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge padding of the last two axes, equal to ``F.pad(x, (pad,) * 4,
    mode="replicate")`` but written into a tensor of x's own memory format:
    one strided copy of the interior plus four thin copies of the halo, where
    F.pad's replication kernel is several times slower on a channels_last
    tensor on the card."""
    b, c, h, w = x.shape
    fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format
    out = torch.empty((b, c, h + 2 * pad, w + 2 * pad), dtype=x.dtype, device=x.device, memory_format=fmt)
    out[:, :, pad : pad + h, pad : pad + w] = x
    out[:, :, :pad, pad : pad + w] = x[:, :, :1]
    out[:, :, pad + h :, pad : pad + w] = x[:, :, -1:]
    out[:, :, :, :pad] = out[:, :, :, pad : pad + 1]  # the corners come with the rows above
    out[:, :, :, pad + w :] = out[:, :, :, pad + w - 1 : pad + w]
    return out


class ConvNonlinear(nn.Module):
    """Replicate-padded conv + nonlinearity: the JAX package pads with
    ``mode="edge"`` and runs a VALID conv (``mridc_tpu/nn/layers.py:277-290``),
    so the halo repeats the border instead of adding zeros."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        dilation: int = 1,
        use_bias: bool = True,
        nonlinear: Optional[str] = "relu",
        dtype=None,
        lane_fold: bool = False,
    ):
        super().__init__()
        del lane_fold
        self.pad = dilation * (kernel_size - 1) // 2
        self.nonlinear = nonlinear
        self.conv_layer = Conv(in_features, features, kernel_size, dilation, "VALID", use_bias, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``kaiming_normal`` kernel (``mridc_tpu/nn/layers.py:286``), zero bias."""
        fan_in_truncated_normal_(self.conv_layer.weight, 2.0, generator)
        if self.conv_layer.bias is not None:
            nn.init.zeros_(self.conv_layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = replicate_pad(x, self.pad)
        return activation(self.conv_layer(x), self.nonlinear)
