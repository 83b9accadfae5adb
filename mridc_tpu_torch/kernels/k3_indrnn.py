"""K3: the IndRNN cell with a 1x1 input kernel (``csrc/indrnn.cu``) and its
plain version.

Stands for ``mridc_tpu/nn/rnn_cells.py:88-109``
``IndRNNCell.__call__``: ``relu(conv1x1(x, W) + b + u * h)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mridc_tpu_torch.kernels.binding import launch
from mridc_tpu_torch.kernels.common import check_forward_only, check_operand, device_of

__all__ = ["indrnn", "indrnn_plain", "SYMBOLS"]

SYMBOLS = {torch.float32: "k3_indrnn_f32", torch.bfloat16: "k3_indrnn_bf16"}


def indrnn_plain(x, h, weight, bias: Optional[torch.Tensor], hh) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the kernel's oracle)."""
    return F.relu(F.conv2d(x, weight, bias) + hh * h)


def indrnn(x, h, weight, bias: Optional[torch.Tensor], hh) -> torch.Tensor:
    """``x`` [B, CI, H, W], ``h`` [B, F, H, W] (channels_last on the card),
    ``weight`` [F, CI, 1, 1], ``bias`` [F] or None, ``hh`` [1, F, 1, 1]; all
    already in the compute dtype (float32 or bfloat16 on the card).
    Returns h' [B, F, H, W] in that dtype."""
    dev = device_of("indrnn", x, h, weight, bias, hh)
    if dev.type == "cpu":
        return indrnn_plain(x, h, weight, bias, hh)
    check_forward_only("indrnn", (x, h, weight, bias, hh))
    if x.ndim != 4 or h.ndim != 4:
        raise ValueError(f"indrnn: x and h must be [B, C, H, W], got {tuple(x.shape)} and {tuple(h.shape)}")
    b, ci, hgt, wid = x.shape
    f = h.shape[1]
    if weight.shape != (f, ci, 1, 1):
        raise ValueError(f"indrnn: the kernel takes a 1x1 weight [{f}, {ci}, 1, 1], got {tuple(weight.shape)}")
    dts = (x.dtype,) if x.dtype in SYMBOLS else tuple(SYMBOLS)
    if x.dtype == torch.bfloat16 and (ci % 16 or f % 8 or f > 128):
        raise ValueError(f"indrnn: the bf16 kernel needs in-channels % 16 == 0 and out-channels % 8 == 0, <= 128; "
                         f"got {ci} -> {f}")
    if x.dtype == torch.float32 and (f % 4 or f > 256):
        raise ValueError(f"indrnn: the float32 kernel needs out-channels % 4 == 0, <= 256; got {f}")
    check_operand("indrnn.x", x, (b, ci, hgt, wid), dts, channels_last=True)
    check_operand("indrnn.h", h, (b, f, hgt, wid), dts, channels_last=True)
    for name, p in (("weight", weight), ("bias", bias), ("hh", hh)):
        if p is not None and p.dtype != x.dtype:
            raise TypeError(f"indrnn.{name}: expected dtype {x.dtype}, got {p.dtype}")
    # float32 copies of the (already rounded) parameters: the kernel reads W,
    # b and u as float32; for float32 parameters these are views, not copies
    w32 = weight.reshape(f, ci).float().contiguous()
    b32 = None if bias is None else bias.reshape(f).float().contiguous()
    u32 = hh.reshape(f).float().contiguous()
    out = torch.empty_like(h, memory_format=torch.channels_last)
    launch(
        "indrnn", SYMBOLS[x.dtype], dev,
        x.data_ptr(), h.data_ptr(), w32.data_ptr(), None if b32 is None else b32.data_ptr(), u32.data_ptr(),
        out.data_ptr(), b * hgt * wid, ci, f,
    )
    return out
