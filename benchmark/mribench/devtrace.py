"""Reading a ``torch.profiler`` trace of warm calls (CUPTI's device events and
the host's op events) into device time by layer, busy and idle time, kernel
rooflines and the breakdown of a ``--trace 1`` result.

The trace context ``ctx`` that the per-layer metric readers take is a dict:
``device`` [(name, start_us, end_us)], ``host`` [(name, start_us, end_us)]
(the host's op and span events), ``window`` (start_us, end_us) of the
harness's span around the profiled calls, ``slices`` profiled, ``bounds``
{entry: bound ms a launch} at the cell's shapes, and ``mfu`` inputs:
``flops_per_slice``, ``peak_flops`` and ``slices_per_s`` (the rate of the
run's unprofiled window).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["layer_of", "entry_of", "union", "collect", "per_slice_ms", "roofline", "idle_share", "busy_s",
           "breakdown", "mfu"]

SHORT_GAP_US = 10.0  # shorter idle gaps are summed under one name, not named one by one
DC_LAYERS = ("K1 psf1d_dc", "K1 psf1d_dc backward", "K1 maps gradient", "K2 stages", "K2 backward stages",
             "K2 maps gradient", "cuFFT")


def entry_of(name: str) -> Optional[str]:
    """The hand-kernel entry a device kernel belongs to, by its name (None:
    not a kernel of the package's ``csrc``)."""
    n = name.lower()
    if "sens_grad_kernel" in n:
        return "k2_sens_grad"
    if "sens_kernel<" in n or "sens_bf16_kernel" in n or "sens_f32_kernel" in n:
        return "k1_sens"
    if "psf1d_dc" in n:
        return "k1_bwd" if "<true" in n else "k1_fwd"
    if "edge_pad_bwd_kernel" in n:
        return "k4_pad_bwd"
    if "edge_pad_kernel" in n:
        return "k4_pad"
    if "bias_act_bwd_kernel" in n or "bias_grad_sum_kernel" in n:
        return "k4_bias_act_bwd"
    if "bias_act_kernel" in n:
        return "k4_bias_act"
    if "indrnn_bwd" in n or "reduce_partials" in n:
        return "k3_bwd"
    if "indrnn" in n:
        return "k3_fwd"
    if "anonymous namespace" in n and "at::" not in n:
        for stage in ("reduce_acc", "expand", "residual", "load", "reduce", "mask"):
            if f"{stage}_kernel" in n:
                return f"k2_{stage}"
    return None


def layer_of(name: str) -> str:
    """The layer a device event belongs to, by its name."""
    n = name.lower()
    if n.startswith("memcpy"):
        return "memcpy " + ("HtoD" if "htod" in n else "DtoH" if "dtoh" in n else "other")
    if n.startswith("memset"):
        return "memset"
    e = entry_of(name)
    if e is not None:
        return {"k1_fwd": "K1 psf1d_dc", "k1_bwd": "K1 psf1d_dc backward", "k1_sens": "K1 maps gradient",
                "k2_sens_grad": "K2 maps gradient", "k3_fwd": "K3 indrnn", "k3_bwd": "K3 indrnn backward",
                "k4_pad": "K4 edge pad", "k4_pad_bwd": "K4 edge pad backward", "k4_bias_act": "K4 bias and activation",
                "k4_bias_act_bwd": "K4 bias and activation backward",
                "k2_reduce_acc": "K2 backward stages", "k2_mask": "K2 backward stages"}.get(e, "K2 stages")
    if "batch_norm" in n:
        return "BatchNorm"
    if "welford" in n:
        return "InstanceNorm statistics"
    if "avg_pool" in n or "reflection_pad" in n:
        return "pooling and reflect pad"
    if any(k in n for k in ("dse::", "fft2d_", "pointwise_mult_and_sum_complex")):  # cuDNN's FFT convolutions
        return "conv and GEMM (cuDNN, cuBLAS)"
    if "fft" in n:
        return "cuFFT"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "sm90", "cutlass", "nhwc", "nchw", "wgrad",
                            "dgrad")):
        return "conv and GEMM (cuDNN, cuBLAS)"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer (Adam)"
    if "dot_kernel" in n or "reduce_1block" in n:
        return "dot products (cuBLAS)"
    if "reduce_kernel" in n:
        return "reductions (ATen)"
    return "elementwise (ATen)"


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint intervals that ``spans`` cover, in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def collect(prof, window_span: str, call_spans: Iterable[str] = ()) -> dict:
    """The device and host events of a finished ``torch.profiler.profile``
    and the window of its ``window_span`` range. The harness's ranges
    (``window_span``, ``call_spans``) are left out of the device events: a
    range's own event on the device timeline spans its kernels."""
    import torch

    ours = {window_span, *call_spans}
    cuda, device, host = torch.autograd.DeviceType.CUDA, [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if e.name not in ours:
                device.append(span)
        else:
            host.append(span)
    win = [(a, b) for n, a, b in host if n == window_span]
    return {"device": device, "host": host, "window": (min(a for a, _ in win), max(b for _, b in win)),
            "window_span": window_span, "call_spans": tuple(call_spans)}


def _in_window(ctx) -> List[Tuple[str, float, float]]:
    lo, hi = ctx["window"]
    return [(n, max(a, lo), min(b, hi)) for n, a, b in ctx["device"] if b > lo and a < hi]


def per_slice_ms(ctx, layers: Iterable[str]) -> Optional[float]:
    """Device ms a profiled slice in the given layers (None: none ran)."""
    layers = set(layers)
    hit = [b - a for n, a, b in _in_window(ctx) if layer_of(n) in layers]
    return sum(hit) / 1e3 / ctx["slices"] if hit else None


def roofline(ctx, entries: Iterable[str]) -> Optional[float]:
    """Percent: the summed bound of the launches of ``entries`` in the
    window over their summed device time (None: none ran). An entry of two
    kernels (a backward and its partial sums) is bounded once a launch of its
    first kernel."""
    entries = set(entries)
    measured, bound = 0.0, 0.0
    for n, a, b in _in_window(ctx):
        e = entry_of(n)
        if e in entries and e in ctx["bounds"]:
            measured += (b - a) / 1e3
            if "bias_grad_sum" not in n.lower() and "reduce_partials" not in n.lower():
                bound += ctx["bounds"][e]
    return 100.0 * bound / measured if measured > 0 else None


def busy_s(ctx) -> float:
    return sum(b - a for a, b in union((a, b) for _, a, b in _in_window(ctx))) / 1e6


def idle_share(ctx) -> float:
    lo, hi = ctx["window"]
    return 100.0 * (1.0 - busy_s(ctx) * 1e6 / (hi - lo))


def mfu(ctx) -> Optional[float]:
    if not ctx.get("slices_per_s"):
        return None
    return 100.0 * ctx["flops_per_slice"] * ctx["slices_per_s"] / ctx["peak_flops"]


def _host_namer(ctx):
    """A function of a time t: what the host was doing then, the harness
    span and the innermost op that hold it."""
    import numpy as np

    spans = [s for s in ctx["host"] if s[0] != ctx.get("window_span")]
    names = [n for n, _, _ in spans]
    a = np.array([x for _, x, _ in spans] or [0.0])
    b = np.array([x for _, _, x in spans] or [0.0])
    calls = set(ctx.get("call_spans", ()))

    def name(t: float) -> str:
        idx = np.nonzero((a <= t) & (b >= t))[0] if spans else []
        if len(idx) == 0:
            return "outside the calls"
        ordered = [names[i] for i in idx[np.argsort(-(b[idx] - a[idx]), kind="stable")]]
        call = next((n for n in ordered if n in calls), ordered[0])
        return call if ordered[-1] == call else f"{call} > {ordered[-1]}"

    return name


def breakdown(ctx, top: int = 10) -> dict:
    """The device ops that took most time and the idle gaps by what the host
    was doing, each [[name, seconds]], at most ``top`` of each."""
    ops: Dict[str, float] = {}
    events = _in_window(ctx)
    for n, a, b in events:
        ops[n[:160]] = ops.get(n[:160], 0.0) + (b - a) / 1e6
    lo, hi = ctx["window"]
    busy = union((a, b) for _, a, b in events)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    name = _host_namer(ctx)
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            key = name((a + b) / 2) if b - a >= SHORT_GAP_US else f"gaps under {SHORT_GAP_US:g} us"
            gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6
    best = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
