"""K4: the edge pad and the bias-and-activation epilogue around every
``ConvNonlinear`` conv (``csrc/conv_epilogue.cu``), forward and backward, and
their plain versions.

Stands for the chain that XLA fuses around ``mridc_tpu/nn/layers.py:261-297``
``ConvNonlinear.__call__``: ``jnp.pad(x, mode="edge")`` (:279) in front of a
VALID conv, and the conv's bias with ``nn.relu`` or ``nn.leaky_relu``
(:280-296) behind it; RecurrentVarNet's edge pads
(``mridc_tpu/models/recon/rvn.py:53,74,97``) take the same pad. The conv in
between stays cuDNN's, run without its bias.

- :func:`edge_pad` ``x`` [B, C, H, W] -> [B, C, H + 2p, W + 2p], each border
  pixel repeated; its gradient sums, for each input pixel, the gradient
  entries the forward copied from it (one inside, p + 1 on a border,
  (p + 1)^2 at a corner) in float32, in row-major order over (output row,
  output column), rounded once.
- :func:`bias_act` ``act(y + b)``: the sum in float32 rounded once to y's
  dtype, then relu, leaky relu (slope 0.01) or none, as ATen's ``add_`` and
  ``relu`` compute them; its gradient ``g_y = g * act'(out)`` with the JAX
  package's value at a tie (relu: ``out > 0``, as ``jax.nn.relu``'s
  gradient is 0 at 0; leaky relu: ``out >= 0``, as ``jax.nn.leaky_relu``'s is
  1 there) and ``db``, the sum of g_y over pixels in float32.

Layouts: the pad takes a channels_last or a contiguous tensor (the kernel
reads either as [N, H, W, C] with C fastest: N = B, or N = B*C and C = 1);
the epilogue takes channels_last. Any other layout raises on the card; the
callers (``nn/layers.py``) hand over one of these. Every launch is counted
(``kernels/binding.py``); on the CPU each Function runs its plain versions,
looked up at call time, so the tests can count them. While a model is
exported, the forwards are the custom ops ``mridc_tpu_torch::k4_edge_pad`` and
``mridc_tpu_torch::k4_bias_act`` (``kernels/common.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from mridc_tpu_torch.kernels.binding import launch
from mridc_tpu_torch.kernels.common import check_operand, dense, device_of

__all__ = ["edge_pad", "edge_pad_plain", "edge_pad_bwd", "edge_pad_bwd_plain", "bias_act", "bias_act_plain",
           "bias_act_bwd", "bias_act_bwd_plain", "act_code", "bwd_blocks", "PAD_SYMBOLS", "PAD_BWD_SYMBOLS",
           "ACT_SYMBOLS", "ACT_BWD_SYMBOLS", "ACTS", "LEAKY_SLOPE"]

PAD_SYMBOLS = {torch.float32: "k4_edge_pad_f32", torch.bfloat16: "k4_edge_pad_bf16"}
PAD_BWD_SYMBOLS = {torch.float32: "k4_edge_pad_bwd_f32", torch.bfloat16: "k4_edge_pad_bwd_bf16"}
ACT_SYMBOLS = {torch.float32: "k4_bias_act_f32", torch.bfloat16: "k4_bias_act_bf16"}
ACT_BWD_SYMBOLS = {torch.float32: "k4_bias_act_bwd_f32", torch.bfloat16: "k4_bias_act_bwd_bf16"}
ACTS = ("none", "relu", "leakyrelu")  # the kernels' activation codes 0, 1, 2
LEAKY_SLOPE = 0.01
# rows of partial sums of the epilogue's backward at most: 8 blocks of 256
# threads on each of an H100's 132 SMs, one wave (a function of the shape
# only, so the sums' order does not depend on the card)
BWD_BLOCKS = 1056
_INT_MAX = 2**31 - 1


def act_code(nonlinear: Optional[str]) -> int:
    """``ConvNonlinear``'s ``nonlinear`` (None, "none", "relu", "leakyrelu",
    any case) as the kernels' code."""
    name = "none" if nonlinear is None else nonlinear.lower()
    if name not in ACTS:
        raise ValueError(f"Unknown nonlinearity {nonlinear!r}")
    return ACTS.index(name)


def bwd_blocks(p: int) -> int:
    """Blocks (rows of partial sums) of the epilogue's backward over ``p``
    pixels."""
    return max(1, min(BWD_BLOCKS, -(-p // 256)))


# ---- plain versions ------------------------------------------------------------


def edge_pad_plain(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Plain version of the pad: ``F.pad(x, (pad,) * 4, mode="replicate")``
    written into a tensor of x's own memory format, one copy of the interior
    plus four thin copies of the halo."""
    b, c, h, w = x.shape
    fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format
    out = torch.empty((b, c, h + 2 * pad, w + 2 * pad), dtype=x.dtype, device=x.device, memory_format=fmt)
    out[:, :, pad : pad + h, pad : pad + w] = x
    out[:, :, :pad, pad : pad + w] = x[:, :, :1]
    out[:, :, pad + h :, pad : pad + w] = x[:, :, -1:]
    out[:, :, :, :pad] = out[:, :, :, pad : pad + 1]  # the corners come with the rows above
    out[:, :, :, pad + w :] = out[:, :, :, pad + w - 1 : pad + w]
    return out


def _fold(n: int, pad: int) -> List[Tuple[slice, List[slice]]]:
    """Along one axis of n pixels padded by ``pad``: (the pixels, the padded
    positions copied from them, in order), the first pixel, the inside and
    the last pixel (one class if n = 1)."""
    if n == 1:
        return [(slice(0, 1), [slice(o, o + 1) for o in range(2 * pad + 1)])]
    out = [(slice(0, 1), [slice(o, o + 1) for o in range(pad + 1)])]
    if n > 2:
        out.append((slice(1, n - 1), [slice(pad + 1, pad + n - 1)]))
    out.append((slice(n - 1, n), [slice(o, o + 1) for o in range(n - 1 + pad, n + 2 * pad)]))
    return out


def edge_pad_bwd_plain(g: torch.Tensor, pad: int) -> torch.Tensor:
    """Plain version of the pad's backward: ``g`` [B, C, H + 2p, W + 2p] ->
    dx [B, C, H, W] in g's dtype. Each pixel's terms are summed in float32
    (float64 for float64) from zero in the kernel's order, row-major over
    (output row, output column), and rounded once."""
    acc = torch.promote_types(g.dtype, torch.float32)
    gf = g.to(acc)
    b, c, hp, wp = g.shape
    h, w = hp - 2 * pad, wp - 2 * pad
    dx = torch.empty((b, c, h, w), dtype=acc, device=g.device)
    for rows, row_src in _fold(h, pad):
        for cols, col_src in _fold(w, pad):
            s = torch.zeros_like(dx[:, :, rows, cols])
            for rs in row_src:
                for cs in col_src:
                    s = s + gf[:, :, rs, cs]
            dx[:, :, rows, cols] = s
    return dx.to(g.dtype)


def _act_plain(s: torch.Tensor, act: int) -> torch.Tensor:
    if act == 1:
        return F.relu(s)
    if act == 2:
        return F.leaky_relu(s, LEAKY_SLOPE)
    return s


def bias_act_plain(y: torch.Tensor, bias: Optional[torch.Tensor], act: int) -> torch.Tensor:
    """Plain version of the epilogue: ``act(y + bias)`` in y's dtype (ATen
    takes a bfloat16 sum in float32 and rounds it once)."""
    s = y.clone() if bias is None else y + bias.reshape(1, -1, 1, 1)
    return _act_plain(s, act)


def bias_act_bwd_plain(g: torch.Tensor, out: Optional[torch.Tensor], act: int, want_db: bool):
    """Plain version of the epilogue's backward: ``(g_y, db)``, g_y in g's
    dtype and db [C] the sum of g_y over pixels in float32 (float64 for
    float64), None unless ``want_db``."""
    if act == 1:
        gy = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype))
    elif act == 2:
        gy = torch.where(out >= 0, g, g * LEAKY_SLOPE)
    else:
        gy = g
    db = gy.to(torch.promote_types(g.dtype, torch.float32)).sum((0, 2, 3)) if want_db else None
    return gy, db


# ---- the kernels' wrappers -------------------------------------------------------


def _pad_view(name: str, t: torch.Tensor):
    """(memory format, N, H, W, C) of the kernel's [N, H, W, C] view of a
    dense [B, C, H, W] tensor; raises on any other layout."""
    if t.ndim != 4:
        raise ValueError(f"{name}: expected a [B, C, H, W] tensor, got {tuple(t.shape)}")
    b, c, h, w = t.shape
    if t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last, b, h, w, c
    if t.is_contiguous():
        return torch.contiguous_format, b * c, h, w, 1
    raise ValueError(f"{name}: the kernel takes a channels_last or contiguous tensor")


def _dtypes(t: torch.Tensor, symbols) -> tuple:
    return (t.dtype,) if t.dtype in symbols else tuple(symbols)


def _edge_pad_kernel(x: torch.Tensor, pad: int) -> torch.Tensor:
    fmt, n, h, w, c = _pad_view("edge_pad", x)
    check_operand("edge_pad.x", x, x.shape, _dtypes(x, PAD_SYMBOLS), fmt == torch.channels_last, x.element_size())
    b = x.shape[0]
    out = torch.empty((b, x.shape[1], h + 2 * pad, w + 2 * pad), dtype=x.dtype, device=x.device, memory_format=fmt)
    launch("conv_epilogue", PAD_SYMBOLS[x.dtype], x.device, x.data_ptr(), out.data_ptr(), n, h, w, c, pad)
    return out


def edge_pad_bwd(g: torch.Tensor, pad: int) -> torch.Tensor:
    """The pad's backward kernel's wrapper: ``g`` [B, C, H + 2p, W + 2p] ->
    dx [B, C, H, W] in g's dtype and layout (the plain version for CPU
    tensors)."""
    dev = device_of("edge_pad_bwd", g)
    if dev.type == "cpu":
        return edge_pad_bwd_plain(g, pad)
    if not (g.is_contiguous(memory_format=torch.channels_last) or g.is_contiguous()):
        g = dense("edge_pad_bwd", g, channels_last=True)
    fmt, n, hp, wp, c = _pad_view("edge_pad_bwd", g)
    check_operand("edge_pad_bwd.g", g, g.shape, _dtypes(g, PAD_BWD_SYMBOLS), fmt == torch.channels_last,
                  g.element_size())
    h, w = hp - 2 * pad, wp - 2 * pad
    dx = torch.empty((g.shape[0], g.shape[1], h, w), dtype=g.dtype, device=dev, memory_format=fmt)
    launch("conv_epilogue", PAD_BWD_SYMBOLS[g.dtype], dev, g.data_ptr(), dx.data_ptr(), n, h, w, c, pad)
    return dx


def _pc(name: str, t: torch.Tensor) -> Tuple[int, int]:
    b, c, h, w = t.shape
    if t.numel() > _INT_MAX:
        raise ValueError(f"{name}: the kernel takes fewer than 2^31 elements, got {t.numel()}")
    return b * h * w, c


def _bias_act_kernel(y: torch.Tensor, bias: Optional[torch.Tensor], act: int) -> torch.Tensor:
    if y.ndim != 4:
        raise ValueError(f"bias_act: expected a [B, C, H, W] tensor, got {tuple(y.shape)}")
    check_operand("bias_act.y", y, y.shape, _dtypes(y, ACT_SYMBOLS), True, y.element_size())
    p, c = _pc("bias_act", y)
    if bias is not None:
        check_operand("bias_act.bias", bias, (c,), (y.dtype,), align=bias.element_size())
    out = torch.empty_like(y, memory_format=torch.channels_last)
    launch("conv_epilogue", ACT_SYMBOLS[y.dtype], y.device, y.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr(), p, c, act)
    return out


def bias_act_bwd(g: torch.Tensor, out: Optional[torch.Tensor], act: int, want_db: bool):
    """The epilogue's backward kernel's wrapper: ``(g_y, db)`` as
    :func:`bias_act_bwd_plain` gives them (the plain version for CPU
    tensors); ``out`` is the forward's output (None for act none)."""
    dev = device_of("bias_act_bwd", g, out)
    if dev.type == "cpu":
        return bias_act_bwd_plain(g, out, act, want_db)
    if act == 0 and not want_db:
        return g, None
    g = dense("bias_act_bwd", g, channels_last=True)
    dts = _dtypes(g, ACT_BWD_SYMBOLS)
    check_operand("bias_act_bwd.g", g, g.shape, dts, True, g.element_size())
    if act:
        check_operand("bias_act_bwd.out", out, g.shape, (g.dtype,), True, out.element_size())
    p, c = _pc("bias_act_bwd", g)
    gy = torch.empty_like(g, memory_format=torch.channels_last) if act else None
    blocks = bwd_blocks(p)
    part = torch.empty((blocks, c), dtype=torch.float32, device=dev) if want_db else None
    db = torch.empty((c,), dtype=torch.float32, device=dev) if want_db else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    launch("conv_epilogue", ACT_BWD_SYMBOLS[g.dtype], dev, g.data_ptr(), ptr(out if act else None), ptr(gy),
           ptr(part), ptr(db), p, c, act, blocks)
    return (gy if act else g), db


# ---- custom ops (export) ----------------------------------------------------------


@torch.library.custom_op("mridc_tpu_torch::k4_edge_pad", mutates_args=())
def edge_pad_op(x: torch.Tensor, pad: int) -> torch.Tensor:
    """The pad's launch as a custom op: the plain version (CPU)."""
    return edge_pad_plain(x, pad)


edge_pad_op.register_kernel("cuda")(_edge_pad_kernel)


@edge_pad_op.register_fake
def _(x, pad):
    b, c, h, w = x.shape
    fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format
    return torch.empty((b, c, h + 2 * pad, w + 2 * pad), dtype=x.dtype, device=x.device, memory_format=fmt)


@torch.library.custom_op("mridc_tpu_torch::k4_bias_act", mutates_args=())
def bias_act_op(y: torch.Tensor, bias: Optional[torch.Tensor], act: int) -> torch.Tensor:
    """The epilogue's launch as a custom op: the plain version (CPU)."""
    return bias_act_plain(y, bias, act)


bias_act_op.register_kernel("cuda")(_bias_act_kernel)


@bias_act_op.register_fake
def _(y, bias, act):
    return torch.empty_like(y)


# ---- autograd -----------------------------------------------------------------------


class _EdgePad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        if torch.compiler.is_exporting():
            return edge_pad_op(x, pad)
        if x.device.type == "cpu":
            return edge_pad_plain(x, pad)
        return _edge_pad_kernel(x, pad)

    @staticmethod
    def backward(ctx, g):
        return edge_pad_bwd(g, ctx.pad), None


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, act):
        if torch.compiler.is_exporting():
            out = bias_act_op(y, bias, act)
        elif y.device.type == "cpu":
            out = bias_act_plain(y, bias, act)
        else:
            out = _bias_act_kernel(y, bias, act)
        ctx.act = act
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(out if act else None)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        want_db = ctx.bias_dtype is not None and ctx.needs_input_grad[1]
        gy, db = bias_act_bwd(g, out, ctx.act, want_db)
        return (gy if ctx.needs_input_grad[0] else None), (db.to(ctx.bias_dtype) if want_db else None), None


def edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` [B, C, H, W] edge-padded by ``pad`` on both sides of H and W, in
    x's dtype and memory format (channels_last or contiguous on the card:
    float32 or bfloat16); differentiable in x."""
    device_of("edge_pad", x)
    return _EdgePad.apply(x, pad)


def bias_act(y: torch.Tensor, bias: Optional[torch.Tensor], nonlinear: Optional[str]) -> torch.Tensor:
    """``act(y + bias)`` for a conv output ``y`` [B, C, H, W] (channels_last
    on the card: float32 or bfloat16) and ``bias`` [C] of y's dtype or None;
    ``nonlinear`` as ``ConvNonlinear`` takes it. Differentiable in y and the
    bias. With neither a bias nor an activation, returns y as it is."""
    act = act_code(nonlinear)
    if bias is None and act == 0:
        return y
    device_of("bias_act", y, bias)
    return _BiasAct.apply(y, bias, act)
