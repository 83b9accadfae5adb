#!/usr/bin/env python3
"""Time one float32 conv layer of the flagship, forward and backward, through
PyTorch's own autograd convolution and through the port's ``nn/layers.py``
convolution (which holds full float32 itself), on the card.

Shapes: CIRIM's three convs at B=8, 320 x 320 (4 -> 64 5x5, 64 -> 64 3x3
dilation 2, 64 -> 2 3x3), VALID after an edge pad, channels_last. Each way
runs forward then backward with an upstream gradient; CUDA-event ms per call
and the top kernels of one call (torch.profiler) are printed per way.

    python3 tools/torch_conv_ab.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mridc_tpu_torch.nn.layers import conv2d  # noqa: E402


def time_ms(fn, iters=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def top_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name[:90]] = out.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:5]


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for cin, cout, k, d in ((4, 64, 5, 1), (64, 64, 3, 2), (64, 2, 3, 1)):
        pad = d * (k - 1)
        x = torch.randn(8, cin, 320 + pad, 320 + pad, generator=g).to(dev).contiguous(memory_format=torch.channels_last)
        w = (torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5).to(dev)
        b = torch.zeros(cout, device=dev)
        gy = torch.randn(8, cout, 320, 320, generator=g).to(dev).contiguous(memory_format=torch.channels_last)
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))

        def library():
            F.conv2d(xr, wr, br, dilation=d).backward(gy)

        def library_ieee():
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
                F.conv2d(xr, wr, br, dilation=d).backward(gy)

        def port():
            conv2d(xr, wr, br, (1, 1), (0, 0), (d, d)).backward(gy)

        for name, fn in (("library_tf32_flag_on", library), ("library_flag_off_fwd_and_bwd", library_ieee),
                         ("port", port)):
            print(json.dumps({"conv": f"{cin}->{cout} {k}x{k} d{d}", "way": name, "ms_fwd_bwd": time_ms(fn),
                              "top_kernels_ms": top_kernels(fn), "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
