"""K3: the IndRNN cell with a 1x1 input kernel (``csrc/indrnn.cu``, backward
``csrc/indrnn_bwd.cu``) and their plain versions.

Stands for ``mridc_tpu/nn/rnn_cells.py:88-109``
``IndRNNCell.__call__``: ``h' = relu(conv1x1(x, W) + b + u * h)``. With
``g' = g * [h' > 0]`` the backward is ``dx = g' W``, ``dh = u * g'``,
``dW = sum_p g'^T x``, ``db = sum_p g'`` and ``du = sum_p h * g'``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mridc_tpu_torch.kernels.binding import launch, query
from mridc_tpu_torch.kernels.common import check_operand, dense, device_of
from mridc_tpu_torch.nn.layers import conv2d

__all__ = ["indrnn", "indrnn_plain", "indrnn_bwd", "indrnn_bwd_plain", "bwd_setup", "SYMBOLS", "BWD_SYMBOLS"]

SYMBOLS = {torch.float32: "k3_indrnn_f32", torch.bfloat16: "k3_indrnn_bf16"}
BWD_SYMBOLS = {torch.float32: "k3_indrnn_bwd_f32", torch.bfloat16: "k3_indrnn_bwd_bf16"}
BWD_SETUP_KEYS = ("blocks", "smem_bytes", "blocks_per_sm", "threads", "tile_pixels", "stages", "route")
BWD_ROUTES = ("tensor cores", "wide")


def indrnn_plain(x, h, weight, bias: Optional[torch.Tensor], hh) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the kernel's oracle; its
    float32 convolution in full float32)."""
    return F.relu(conv2d(x, weight, bias) + hh * h)


def indrnn_bwd_plain(g, x, h, out, weight, hh):
    """Plain version of the backward kernel: ``(dx, dh, dW [F, CI], db [F],
    du [F])`` for the upstream ``g`` of h' = ``out``; dx and dh in the
    operands' dtype, the sums over pixels in float32 (float64 operands:
    float64), as the kernel sums them."""
    gp = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype))
    f, ci = weight.shape[0], weight.shape[1]
    dx = conv2d(gp, weight.reshape(f, ci).t().reshape(ci, f, 1, 1))
    dh = hh * gp
    acc = torch.promote_types(g.dtype, torch.float32)
    gs = gp.to(acc)
    dw = torch.einsum("bohw,bihw->oi", gs, x.to(acc))
    return dx, dh, dw, gs.sum((0, 2, 3)), (h.to(acc) * gs).sum((0, 2, 3))


def _check_widths(name, dtype, ci, f):
    if dtype == torch.bfloat16 and (ci % 16 or f % 8 or f > 128):
        raise ValueError(f"{name}: the bf16 kernel needs in-channels % 16 == 0 and out-channels % 8 == 0, <= 128; "
                         f"got {ci} -> {f}")
    if dtype == torch.float32 and (f % 4 or f > 256):
        raise ValueError(f"{name}: the float32 kernel needs out-channels % 4 == 0, <= 256; got {f}")


def _forward_kernel(x, h, weight, bias, hh) -> torch.Tensor:
    dev = x.device
    if x.ndim != 4 or h.ndim != 4:
        raise ValueError(f"indrnn: x and h must be [B, C, H, W], got {tuple(x.shape)} and {tuple(h.shape)}")
    b, ci, hgt, wid = x.shape
    f = h.shape[1]
    if weight.shape != (f, ci, 1, 1):
        raise ValueError(f"indrnn: the kernel takes a 1x1 weight [{f}, {ci}, 1, 1], got {tuple(weight.shape)}")
    dts = (x.dtype,) if x.dtype in SYMBOLS else tuple(SYMBOLS)
    _check_widths("indrnn", x.dtype, ci, f)
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
        out.data_ptr(), b * hgt * wid, ci, f, dev.index,
    )
    return out


def bwd_setup(dtype: torch.dtype, p: int, ci: int, f: int, device: torch.device) -> dict:
    """The backward kernel's launch setup for ``p`` pixels and ``ci -> f``
    channels in ``dtype`` on ``device``: blocks of its one-wave grid, shared
    memory bytes a block, blocks per SM, threads, pixels a tile, stages and
    route (bf16: tensor cores; float32: tensor cores where the 3xTF32 kernel
    takes the widths, else the wide route). ``blocks`` is 0 where no kernel
    takes the widths."""
    index = torch.cuda.current_device() if device.index is None else device.index
    info = (ctypes.c_int * len(BWD_SETUP_KEYS))()
    query("indrnn_bwd", "k3_indrnn_bwd_setup", device, int(dtype == torch.bfloat16), p, ci, f, index, info)
    out = dict(zip(BWD_SETUP_KEYS, list(info)))
    out["route"] = BWD_ROUTES[out["route"]]
    return out


def indrnn_bwd(g, x, h, out, weight, hh, need_dx: bool = True, need_dh: bool = True):
    """The backward kernel's wrapper: ``(dx, dh, dW [F, CI], db [F], du [F])``,
    dx/dh in the activations' dtype (None where not needed), the sums in
    float32 (plain version for CPU tensors)."""
    dev = device_of("indrnn_bwd", g, x, h, out, weight, hh)
    if dev.type == "cpu":
        dx, dh, dw, db, du = indrnn_bwd_plain(g, x, h, out, weight, hh)
        return (dx if need_dx else None), (dh if need_dh else None), dw, db, du
    b, ci, hgt, wid = x.shape
    f = h.shape[1]
    _check_widths("indrnn_bwd", x.dtype, ci, f)
    if x.dtype not in BWD_SYMBOLS:
        raise TypeError(f"indrnn_bwd: expected dtype in {[str(d) for d in BWD_SYMBOLS]}, got {x.dtype}")
    p = b * hgt * wid
    # the persistent grid (one wave), for the rows of partials
    blocks = bwd_setup(x.dtype, p, ci, f, dev)["blocks"]
    if blocks == 0:
        raise ValueError(f"indrnn_bwd: the {x.dtype} kernel does not take {ci} -> {f} channels: it holds dW in "
                         "registers (bf16: in-channels <= 256 at out-channels <= 64, <= 128 above; float32: the "
                         "wide route takes out-channels x in-channels rounded up to 4 <= 32768, and its tile "
                         "within shared memory)")
    dts = (x.dtype,)
    g = dense("indrnn_bwd", g.to(x.dtype), channels_last=True)
    for name, t, c in (("x", x, ci), ("h", h, f), ("out", out, f), ("g", g, f)):
        check_operand(f"indrnn_bwd.{name}", t, (b, c, hgt, wid), dts, channels_last=True)
    # W and u in the activations' dtype, as the kernel reads them: views of the
    # parameters' casts, no copies
    w, u = weight.reshape(f, ci).contiguous(), hh.reshape(f).contiguous()
    check_operand("indrnn_bwd.weight", w, (f, ci), dts)
    check_operand("indrnn_bwd.hh", u, (f,), dts)
    dx = torch.empty_like(x, memory_format=torch.channels_last) if need_dx else None
    dh = torch.empty_like(h, memory_format=torch.channels_last) if need_dh else None
    n = f * ci + 2 * f
    part = torch.empty((blocks, n), dtype=torch.float32, device=dev)
    sums = torch.empty((n,), dtype=torch.float32, device=dev)
    launch(
        "indrnn_bwd", BWD_SYMBOLS[x.dtype], dev,
        x.data_ptr(), h.data_ptr(), out.data_ptr(), g.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if dx is None else dx.data_ptr(), None if dh is None else dh.data_ptr(), part.data_ptr(),
        sums.data_ptr(), p, ci, f, blocks, dev.index,
    )
    return dx, dh, sums[: f * ci].view(f, ci), sums[f * ci : f * ci + f], sums[f * ci + f :]


class _IndRNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, weight, bias, hh):
        out = indrnn_plain(x, h, weight, bias, hh) if x.device.type == "cpu" else _forward_kernel(
            x, h, weight, bias, hh)
        ctx.save_for_backward(x, h, out, weight, hh)
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, h, out, weight, hh = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dh, dw, db, du = indrnn_bwd(g, x, h, out, weight, hh, need[0], need[1])
        return (
            dx, dh,
            dw.reshape(weight.shape).to(weight.dtype) if need[2] else None,
            db.to(weight.dtype) if need[3] and ctx.has_bias else None,
            du.reshape(hh.shape).to(hh.dtype) if need[4] else None,
        )


def indrnn(x, h, weight, bias: Optional[torch.Tensor], hh) -> torch.Tensor:
    """``x`` [B, CI, H, W], ``h`` [B, F, H, W] (channels_last on the card),
    ``weight`` [F, CI, 1, 1], ``bias`` [F] or None, ``hh`` [1, F, 1, 1]; all
    already in the compute dtype (float32 or bfloat16 on the card).
    Returns h' [B, F, H, W] in that dtype; differentiable in every input."""
    device_of("indrnn", x, h, weight, bias, hh)
    return _IndRNN.apply(x, h, weight, bias, hh)
