"""K3: the IndRNN cell (``csrc/indrnn.cu``, backward ``csrc/indrnn_bwd.cu``)
and their plain versions.

Stands for ``mridc_tpu/nn/rnn_cells.py:88-109``
``IndRNNCell.__call__``: ``h' = relu(conv(x, W) + b + u * h)``, the conv
``"SAME"``-padded with dilation d. With ``g' = g * [h' > 0]`` the backward is
``dx = g' W``, ``dh = u * g'``, ``dW = sum_p g'^T x``, ``db = sum_p g'`` and
``du = sum_p h * g'``.

The kernels take a 1x1 input kernel at the widths their tiles hold. Every
other call is split into launches of widths they take (:func:`plan`), each
split exact:

- an input kernel k x k > 1 gathers x into its k^2 CI patch channels (data
  movement; autograd scatters dx back) and runs as a 1x1 cell on them, W
  reshaped to [F, k^2 CI] in the same order;
- in-channels are zero-padded to the bf16 kernels' 16, out-channels to 8
  (bf16) or 4 (float32): zero columns of W and zero channels add nothing,
  and padded output channels are sliced off;
- out-channel chunks, forward and backward: output channel f depends only on
  row f of W and on b[f], u[f] and h[f]; dx is the chunks' dx summed in
  chunk order, dW, db, du and dh are disjoint;
- in-channel chunks in the backward: dx[:, chunk] = g' W[:, chunk] and
  dW[:, chunk] = g'^T x[chunk]; db, du and dh come from the first chunk.

Every launch is counted (``kernels/binding.py``). On the CPU each launch of the
plan runs the plain version, so the tests see the card's splits. While a model
is exported, each forward launch is the custom op
``mridc_tpu_torch::k3_indrnn`` (``kernels/common.py``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import asdict, dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mridc_tpu_torch.kernels.binding import launch, query
from mridc_tpu_torch.kernels.common import check_operand, dense, device_of
from mridc_tpu_torch.nn.layers import conv2d

__all__ = ["indrnn", "indrnn_plain", "indrnn_bwd", "indrnn_bwd_plain", "bwd_setup", "plan", "Plan", "SYMBOLS",
           "BWD_SYMBOLS"]

SYMBOLS = {torch.float32: "k3_indrnn_f32", torch.bfloat16: "k3_indrnn_bf16"}
BWD_SYMBOLS = {torch.float32: "k3_indrnn_bwd_f32", torch.bfloat16: "k3_indrnn_bwd_bf16"}
BWD_SETUP_KEYS = ("blocks", "smem_bytes", "blocks_per_sm", "threads", "tile_pixels", "stages", "route")
BWD_ROUTES = ("tensor cores", "wide")


def _same_pads(k: int, dilation: int) -> Tuple[int, int]:
    """flax's ``"SAME"`` zero padding of a stride-1 conv, low side first."""
    total = dilation * (k - 1)
    return total // 2, total - total // 2


def indrnn_plain(x, h, weight, bias: Optional[torch.Tensor], hh, dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the kernel's oracle; its
    float32 convolution in full float32): ``weight`` [F, CI, k, k], a
    ``"SAME"``-padded conv with ``dilation``."""
    k = weight.shape[-1]
    if k > 1:
        lo, hi = _same_pads(k, dilation)
        x = F.pad(x, (lo, hi, lo, hi))
    return F.relu(conv2d(x, weight, bias, dilation=(dilation, dilation)) + hh * h)


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


MAX_SMEM = 232448  # shared memory a block can opt in to on Hopper (csrc/common.cuh)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


# The launchers' width rules, mirrored so that a plan is known on any device
# (csrc/indrnn.cu: k3_indrnn_f32/_bf16 and f32::launch; csrc/indrnn_bwd.cu:
# Setup, tc::pick, tf32::pick, f32::pick). chip_smoke.py holds each planned
# backward launch against k3_indrnn_bwd_setup on the card.
def _fwd_takes(bf16: bool, ci: int, f: int) -> bool:
    if bf16:  # W [F][CI+8] and a 64-pixel x tile in shared memory
        return ci % 16 == 0 and f % 8 == 0 and 0 < f <= 128 and (f + 64) * (ci + 8) * 2 <= MAX_SMEM
    if f % 4 or not 0 < f <= 256:
        return False
    cip, fp = _up(ci, 8), _up(f, 8)  # f32::Layout at its narrowest, 16-pixel tile
    ldw = cip // 2 + (4 if (cip // 2) % 8 == 0 else 0)
    return fp * ldw * 16 + 2 * fp * 4 + 2 * 16 * (cip + 4 + fp + 8) * 4 <= MAX_SMEM


def _bwd_route(bf16: bool, ci: int, f: int) -> Optional[str]:
    """The backward kernel's route at these widths, None if none takes them."""
    if bf16:  # dW in registers: CI <= 256 at F <= 64, <= 128 above
        if ci % 16 or f % 8 or not 0 < f <= 128 or ci > (256 if f <= 64 else 128):
            return None
        fp, lx = _up(f, 16), ci + 8
        stage = 64 * (lx + fp + 8 + 2 * f)
        return BWD_ROUTES[0] if 2 * (fp * lx + 64 * lx + 2 * stage) <= MAX_SMEM else None
    if f % 4 or f <= 0:
        return None
    if ci % 4 == 0 and (_up(f, 64), _up(ci, 64)) in ((64, 64), (64, 128), (128, 64)):
        return BWD_ROUTES[0]
    cip = _up(ci, 4)  # the wide route: dW in registers, a 16-pixel tile at the narrowest
    if f > 256 or (f // 4) * (cip // 4) > 256 * 8 or (f * cip + 16 * cip + 32 * f) * 4 > MAX_SMEM:
        return None
    return BWD_ROUTES[1]


def _splits(n: int, parts: int, unit: int) -> Tuple[Tuple[int, int], ...]:
    """[0, n) in ``parts`` chunks of a width rounded up to ``unit`` (the last
    one narrower)."""
    w = _up(-(-n // parts), unit)
    return tuple((a, min(a + w, n)) for a in range(0, n, w))


@dataclass(frozen=True)
class Plan:
    """The launches one call of the cell takes (:func:`plan`). Widths are the
    1x1 cell's after the gather: ``ci`` = k^2 in-channels, padded to
    ``ci_pad``; ``f`` out-channels, padded to ``f_pad``. ``fwd``: the out-channel
    chunks of the forward; ``bwd``: (out-channel chunk, in-channel chunk,
    route) of each backward launch, in the order their dx is summed, on the
    kernel of ``bwd_dtype`` (float32 for a bf16 cell whose backward needs
    out-channel chunks: its operands upcast, dx rounded once)."""

    dtype: str
    k: int
    ci: int
    f: int
    ci_pad: int
    f_pad: int
    fwd: Tuple[Tuple[int, int], ...]
    bwd: Tuple[Tuple[Tuple[int, int], Tuple[int, int], str], ...]
    bwd_dtype: str

    @property
    def launches(self) -> Tuple[int, int]:
        """(forward, backward) launches of one call."""
        return len(self.fwd), len(self.bwd)

    def as_dict(self) -> dict:
        return {**asdict(self), "launches": list(self.launches)}


@functools.lru_cache(maxsize=None)
def plan(dtype: torch.dtype, ci: int, f: int, k: int = 1) -> Plan:
    """The launches of a ``ci -> f`` cell with a k x k input kernel in
    ``dtype`` (module docstring): the fewest launches the kernels take, a
    tensor-core backward route before the wide one, then wider out-channel
    chunks. Raises ``ValueError`` where no split fits: the float32 forward
    holds W [F, k^2 CI] of an out-channel chunk in shared memory, which at
    its narrowest chunk (4) bounds k^2 CI to 1192."""
    bf16 = dtype == torch.bfloat16  # other dtypes (the CPU's float64) follow the float32 kernel's rules
    kci = k * k * ci
    ci_pad, f_unit = (_up(kci, 16), 8) if bf16 else (kci, 4)
    f_pad = _up(f, f_unit)
    fwd = next((c for n in range(1, f_pad // f_unit + 1)
                for c in [_splits(f_pad, n, f_unit)] if all(_fwd_takes(bf16, ci_pad, b - a) for a, b in c)), None)
    if fwd is None:
        raise ValueError(f"indrnn: the {dtype} forward kernel does not take {kci} (k^2 x in-channels) -> any "
                         f"out-channel chunk: it holds W [F, {kci}] in {MAX_SMEM} bytes of shared memory "
                         "(float32: k^2 x in-channels <= 1192)")
    name = str(dtype).replace("torch.", "")
    bwd, bwd_dtype = _bwd_chunks(bf16, ci_pad, f_pad), name
    if bf16 and len({fc for fc, _, _ in bwd}) > 1:
        # out-channel chunks would sum dx from partials each rounded to bf16:
        # the backward runs on the float32 kernel, its operands upcast (exact),
        # and dx is rounded once
        bwd, bwd_dtype = _bwd_chunks(False, ci_pad, f_pad), "float32"
    return Plan(name, k, kci, f, ci_pad, f_pad, fwd, bwd, bwd_dtype)


def _bwd_chunks(bf16: bool, ci: int, f: int):
    """The backward's launches at these (padded) widths: the fewest, a
    tensor-core route before the wide one, then fewer out-channel chunks."""
    best = None
    f_unit, c_unit = (8, 16) if bf16 else (4, 4)
    for nf in range(1, f // f_unit + 1):
        fs = _splits(f, nf, f_unit)
        for nc in range(1, -(-ci // c_unit) + 1):
            cs = _splits(ci, nc, c_unit)
            routes = [_bwd_route(bf16, b - a, d - c) for c, d in fs for a, b in cs]
            if None in routes:
                continue
            key = (len(routes), BWD_ROUTES[1] in routes, nf)
            if best is None or key < best[0]:
                best = key, tuple((fc, cc, r) for (fc, cc), r in zip([(fc, cc) for fc in fs for cc in cs], routes))
            break  # more in-channel chunks only add launches
    return best[1]


def _forward_kernel(x, h, weight, bias, hh) -> torch.Tensor:
    """One forward launch at widths the kernel takes."""
    dev = x.device
    if x.ndim != 4 or h.ndim != 4:
        raise ValueError(f"indrnn: x and h must be [B, C, H, W], got {tuple(x.shape)} and {tuple(h.shape)}")
    b, ci, hgt, wid = x.shape
    f = h.shape[1]
    if weight.shape != (f, ci, 1, 1):
        raise ValueError(f"indrnn: the kernel takes a 1x1 weight [{f}, {ci}, 1, 1], got {tuple(weight.shape)}")
    dts = (x.dtype,) if x.dtype in SYMBOLS else tuple(SYMBOLS)
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


@torch.library.custom_op("mridc_tpu_torch::k3_indrnn", mutates_args=())
def indrnn_op(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              hh: torch.Tensor) -> torch.Tensor:
    """One forward launch as a custom op: the plain version (CPU), laid out
    channels_last as the kernel writes it."""
    return indrnn_plain(x, h, weight, bias, hh).contiguous(memory_format=torch.channels_last)


indrnn_op.register_kernel("cuda")(_forward_kernel)  # on the card: the launch


@indrnn_op.register_fake
def _(x, h, weight, bias, hh):
    return torch.empty_like(h, memory_format=torch.channels_last)


def _channels(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Channels [a, b) of a [B, C, H, W] activation, dense channels_last (a
    copy unless they are all of them)."""
    if (a, b) == (0, t.shape[1]):
        return t
    return t[:, a:b].contiguous(memory_format=torch.channels_last)


def _forward(x, h, weight, bias, hh) -> torch.Tensor:
    """The forward of a 1x1 cell at widths :func:`plan` leaves unpadded: one
    launch per out-channel chunk (the plain version per chunk on the CPU),
    the chunks' outputs written into one tensor."""
    outs = []
    for a, b in plan(x.dtype, x.shape[1], h.shape[1]).fwd:
        args = (x, _channels(h, a, b), weight[a:b], None if bias is None else bias[a:b], hh[:, a:b])
        if torch.compiler.is_exporting():
            outs.append(indrnn_op(*args))
        else:
            outs.append(indrnn_plain(*args) if x.device.type == "cpu" else _forward_kernel(*args))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1).contiguous(memory_format=torch.channels_last)


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


def _bwd_launch(g, x, h, out, weight, hh, need_dx: bool, need_dh: bool):
    """One backward launch at widths the kernel takes (the plain version on
    the CPU)."""
    dev = x.device
    if dev.type == "cpu":
        dx, dh, dw, db, du = indrnn_bwd_plain(g, x, h, out, weight, hh)
        return (dx if need_dx else None), (dh if need_dh else None), dw, db, du
    b, ci, hgt, wid = x.shape
    f = h.shape[1]
    if x.dtype not in BWD_SYMBOLS:
        raise TypeError(f"indrnn_bwd: expected dtype in {[str(d) for d in BWD_SYMBOLS]}, got {x.dtype}")
    p = b * hgt * wid
    # the persistent grid (one wave), for the rows of partials
    blocks = bwd_setup(x.dtype, p, ci, f, dev)["blocks"]
    if blocks == 0:
        raise ValueError(f"indrnn_bwd: the {x.dtype} kernel does not take {ci} -> {f} channels (plan() splits "
                         "a call into launches it takes)")
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


def indrnn_bwd(g, x, h, out, weight, hh, need_dx: bool = True, need_dh: bool = True):
    """The backward kernel's wrapper for a 1x1 cell: ``(dx, dh, dW [F, CI],
    db [F], du [F])``, dx/dh in the activations' dtype (None where not
    needed), the sums in float32; split into the launches of :func:`plan`
    (the plain version per launch on the CPU). The widths must need no
    padding (:func:`indrnn` pads them)."""
    device_of("indrnn_bwd", g, x, h, out, weight, hh)
    f, ci = weight.shape[0], weight.shape[1]
    p = plan(x.dtype, ci, f)
    if (p.ci_pad, p.f_pad) != (ci, f):
        raise ValueError(f"indrnn_bwd: {ci} -> {f} channels need padding to {p.ci_pad} -> {p.f_pad} "
                         "(indrnn pads them)")
    if p.bwd_dtype != p.dtype:
        up = [t.float().contiguous(memory_format=torch.channels_last) for t in (g, x, h, out)]
        dx, dh, dw, db, du = _bwd_chunked(p, *up, weight.float(), hh.float(), need_dx, need_dh)
        return (None if dx is None else dx.to(x.dtype)), (None if dh is None else dh.to(x.dtype)), dw, db, du
    return _bwd_chunked(p, g.to(x.dtype), x, h, out, weight, hh, need_dx, need_dh)


def _bwd_chunked(p: Plan, g, x, h, out, weight, hh, need_dx: bool, need_dh: bool):
    """The backward launches of plan ``p`` (dx summed over out-channel
    chunks in float32, in chunk order)."""
    if len(p.bwd) == 1:
        return _bwd_launch(g, x, h, out, weight, hh, need_dx, need_dh)
    dev, f, ci = x.device, p.f_pad, p.ci_pad
    acc = torch.promote_types(x.dtype, torch.float32)
    cl = torch.channels_last
    dx = torch.zeros(x.shape, dtype=acc, device=dev).contiguous(memory_format=cl) if need_dx else None
    dh = torch.empty_like(h, memory_format=cl) if need_dh else None
    dw = torch.empty((f, ci), dtype=acc, device=dev)
    db, du = torch.empty(f, dtype=acc, device=dev), torch.empty(f, dtype=acc, device=dev)
    for (f0, f1), (c0, c1), _ in p.bwd:  # out-channel chunks outer: dx sums in chunk order
        first = c0 == 0
        r = _bwd_launch(_channels(g, f0, f1), _channels(x, c0, c1), _channels(h, f0, f1), _channels(out, f0, f1),
                        weight[f0:f1, c0:c1], hh[:, f0:f1], need_dx, need_dh and first)
        if need_dx:
            dx[:, c0:c1] += r[0]
        if need_dh and first:
            dh[:, f0:f1] = r[1]
        dw[f0:f1, c0:c1] = r[2]
        if first:
            db[f0:f1], du[f0:f1] = r[3], r[4]
    return (None if dx is None else dx.to(x.dtype)), dh, dw, db, du


class _IndRNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, weight, bias, hh):
        out = _forward(x, h, weight, bias, hh)
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


def _patches(x: torch.Tensor, weight: torch.Tensor, dilation: int, ci_pad: int):
    """``x`` gathered into its k^2 CI patch channels of the ``"SAME"``-padded
    conv with ``dilation``, zero channels appended up to ``ci_pad``, as a
    channels_last [B, ci_pad, H, W]; ``weight`` [F, CI, k, k] as [F, ci_pad,
    1, 1] in the same order (kernel row, kernel column, channel)."""
    b, ci, hgt, wid = x.shape
    f, k = weight.shape[0], weight.shape[-1]
    xn = x.permute(0, 2, 3, 1)  # NHWC: a view of a channels_last x
    pieces = [xn]
    if k > 1:
        lo, hi = _same_pads(k, dilation)
        xp = F.pad(xn, (0, 0, lo, hi, lo, hi))
        d = dilation
        pieces = [xp[:, i * d : i * d + hgt, j * d : j * d + wid] for i in range(k) for j in range(k)]
    kci = k * k * ci
    if ci_pad > kci:
        pieces.append(xn.new_zeros(b, hgt, wid, ci_pad - kci))
    w = F.pad(weight.permute(0, 2, 3, 1).reshape(f, kci), (0, ci_pad - kci))
    return torch.cat(pieces, -1).permute(0, 3, 1, 2), w.reshape(f, ci_pad, 1, 1)


def _pad_channels(t: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zero channels appended to a [B, C, H, W] activation, channels_last."""
    return F.pad(t.permute(0, 2, 3, 1), (0, n)).permute(0, 3, 1, 2)


def indrnn(x, h, weight, bias: Optional[torch.Tensor], hh, dilation: int = 1) -> torch.Tensor:
    """``x`` [B, CI, H, W], ``h`` [B, F, H, W] (channels_last on the card),
    ``weight`` [F, CI, k, k], ``bias`` [F] or None, ``hh`` [1, F, 1, 1]; all
    already in the compute dtype (float32 or bfloat16 on the card); a
    ``"SAME"``-padded input conv with ``dilation``. Returns h' [B, F, H, W] in
    that dtype; differentiable in every input. Runs the launches of
    :func:`plan`."""
    device_of("indrnn", x, h, weight, bias, hh)
    f, ci, k = weight.shape[0], weight.shape[1], weight.shape[-1]
    if weight.shape[-2] != k:
        raise ValueError(f"indrnn: the input kernel must be square, got {tuple(weight.shape)}")
    p = plan(x.dtype, ci, f, k)
    if k > 1 or p.ci_pad != ci:
        x, weight = _patches(x, weight, dilation, p.ci_pad)
    pad = p.f_pad - f
    if pad:
        h, hh = _pad_channels(h, pad), F.pad(hh, (0, 0, 0, 0, 0, pad))
        weight = F.pad(weight, (0, 0, 0, 0, 0, 0, 0, pad))
        bias = None if bias is None else F.pad(bias, (0, pad))
    out = _IndRNN.apply(x, h, weight, bias, hh)
    return out[:, :f] if pad else out
