#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's K3-f32 kernel on one NVIDIA GPU.

Each variant is ``mridc_tpu_torch/csrc/indrnn.cu`` with a few text
substitutions (defined below), built with nvcc into its own library (all
builds started together) and timed at the main path's K3 operands: B=8,
320x320 pixels, 64 -> 64 channels, float32, channels_last. Beside them: one
PyTorch elementwise pass that moves the same bytes (``torch.add(x, h)``), the
yardstick for a memory-bound kernel. Variants marked ``timing only`` leave out
part of the work and give a wrong result; the others are checked against the
plain version (cuDNN in full float32) at rtol 1e-4 / atol 1e-4 x max.

    python3 tools/torch_k3_f32_variants.py [--rounds N]

Prints one JSON line per variant and round, then the card's name and power
limit. Builds go to ``mridc_tpu_torch/_build/k3_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "mridc_tpu_torch" / "csrc"
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k3_variants"
B, H, W, C = 8, 320, 320, 64

_THREE_PASSES = """#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma_tf32(acc[n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[n].y, b[n].w);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma_tf32(acc[n], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[n].x, b[n].z);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma_tf32(acc[n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[n].x, b[n].z);"""
_PER_TILE_MMA3 = """#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma3(acc[n], a, Split{b[n].x, b[n].y}, Split{b[n].z, b[n].w});"""
_THREADS = ("constexpr int THREADS = 128;  // 4 warps", "constexpr int THREADS = 256;  // 8 warps")
_STAGES = ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")


def _tile(tp: int, stages: int) -> list:
    """TP-pixel tiles in a ring of ``stages`` stages"""
    return [("  int tp = 64;\n", f"  int tp = {tp};\n"), ("constexpr int STAGES = 2;", f"constexpr int STAGES = {stages};")]


# name -> (substitutions, result is right)
VARIANTS = {
    "shipped: 64-pixel tiles, 2 stages, 4 warps (2 blocks per SM)": ([], True),
    "32-pixel tiles, 3 stages, 4 warps (2 blocks per SM)": (_tile(32, 3), True),
    "32-pixel tiles, 4 stages, 4 warps (2 blocks per SM)": (_tile(32, 4), True),
    "16-pixel tiles, 6 stages, 4 warps (2 blocks per SM)": (_tile(16, 6), True),
    "3 stages, 4 warps (1 block per SM)": ([_STAGES], True),
    "3 stages, 8 warps (1 block per SM)": ([_STAGES, _THREADS], True),
    "3 stages, 8 warps, mma3 per n tile (dependent MMAs back to back)": (
        [_STAGES, _THREADS, (_THREE_PASSES, _PER_TILE_MMA3)], True),
    "timing only: no MMA (the copy pipeline alone)": (
        [("for (int kk = 0; kk < L.cip; kk += 8) {", "for (int kk = 0; kk < 0; kk += 8) {")], False),
    "timing only: no copies in (MMA, epilogue and stores alone)": (
        [("    if (t < tiles) {\n      const int p0 = t * TP, rows", "    if (false) {\n      const int p0 = t * TP, rows")],
        False),
}


def build(nvcc: str) -> dict:
    src = (CSRC / "indrnn.cu").read_text()
    procs = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:60]!r}")
            s = s.replace(old, new)
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "indrnn.cu").write_text(s)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-o", str(d / "lib.so"), str(d / "indrnn.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch.kernels.binding import _nvcc
    from mridc_tpu_torch.kernels.k3_indrnn import indrnn_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build(_nvcc())
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cl = lambda t: t.to(dev).contiguous(memory_format=torch.channels_last)  # noqa: E731
    x, h = cl(torch.randn(B, C, H, W, generator=gen)), cl(torch.rand(B, C, H, W, generator=gen))
    w = (torch.randn(C, C, generator=gen) / C**0.5).to(dev)
    bias, u = (0.1 * torch.randn(C, generator=gen)).to(dev), torch.rand(C, generator=gen).to(dev)
    out = torch.empty_like(h)
    want = indrnn_plain(x, h, w.view(C, C, 1, 1), bias, u.view(1, C, 1, 1))
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn, iters=30):
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

    nbytes = 4 * (3 * B * H * W * C + C * C + 2 * C)
    for rnd in range(args.rounds):
        ms = time_ms(lambda: torch.add(x, h, out=out))
        print(json.dumps({"round": rnd, "variant": "torch.add(x, h): the same bytes, no product", "ms": ms,
                          "bound_ms": nbytes / 3.35e12 * 1e3}), flush=True)
        for name, lib_path in libs.items():
            fn = ctypes.CDLL(str(lib_path)).k3_indrnn_f32
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                err = fn(x.data_ptr(), h.data_ptr(), w.data_ptr(), bias.data_ptr(), u.data_ptr(), out.data_ptr(),
                         B * H * W, C, C, dev.index or 0, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            rec = {"round": rnd, "variant": name, "ms": time_ms(call), "bound_ms": nbytes / 3.35e12 * 1e3}
            if VARIANTS[name][1]:
                err = float((out - want).abs().max())
                ok = torch.allclose(out, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
                rec.update(max_abs_err=err, ok=bool(ok))
                if not ok:
                    raise AssertionError(f"{name}: disagrees with the plain version: {rec}")
            print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
