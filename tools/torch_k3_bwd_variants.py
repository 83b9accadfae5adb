#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's K3-bwd-bf16 kernel on one NVIDIA GPU.

Each variant is ``mridc_tpu_torch/csrc/indrnn_bwd.cu`` with a few text
substitutions (defined below), built with nvcc into its own library (all
builds started together) and timed at the flagship training step's K3-bwd
operands: B=24, 320x320 pixels, 64 -> 64 channels, bfloat16, channels_last,
drawn from a seed (x normal, h >= 0, h' = relu of a normal draw: about half
its entries 0, g normal). Beside them: two PyTorch elementwise passes that
move the same bytes (``torch.add(x, h)`` and ``torch.add(h', g)``: four
tensors in, two out), the yardstick for a memory-bound kernel, and, for
reference only, the same function composed from library calls (the relu mask,
two ``torch.matmul`` and the elementwise sums), and the package's own wrapper
(``kernels/k3_indrnn.py:indrnn_bwd``, as the training step calls it), each
also with the host's time to enqueue one call. Variants marked ``timing only``
leave out part of the work and give a wrong result; the others are checked
against the plain version at chip_smoke.py's phase-9 limits (dx, dh: rtol 1e-2,
atol 1e-3 x max against float32 rounded once; dW, db, du: rtol 1e-3, atol 1e-4
x max against float64).

    python3 tools/torch_k3_bwd_variants.py [--rounds N]

Prints one JSON line per variant and round, then the card's name and power
limit. Builds go to ``mridc_tpu_torch/_build/k3_bwd_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "mridc_tpu_torch" / "csrc"
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k3_bwd_variants"
B, H, W, C = 24, 320, 320, 64

_LAYOUT_BYTES = "return 2 * ((size_t)fp * lx + (size_t)TP * lx + (size_t)STAGES * stage);"

# name -> (substitutions, result is right)
VARIANTS = {
    "shipped: 64-pixel tiles, 2 stages, 4 warps (2 blocks per SM)": ([], True),
    "1 block per SM (shared memory padded by 64 KB)": (
        [(_LAYOUT_BYTES, _LAYOUT_BYTES.replace(");", ") + 65536;"))], True),
    "timing only: no MMA (copies, staging epilogue, dh and dx stores)": (
        [("for (int kk = 0; kk < TP; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {"),
         ("for (int kk = 0; kk < L.fp; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {")], False),
    "timing only: no copies in (epilogue, MMAs and stores alone)": (
        [("    if (t < tiles) {\n      const size_t p0", "    if (false) {\n      const size_t p0")], False),
}


def build(nvcc: str) -> dict:
    src = (CSRC / "indrnn_bwd.cu").read_text()
    procs = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:60]!r}")
            s = s.replace(old, new)
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "indrnn_bwd.cu").write_text(s)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-o", str(d / "lib.so"), str(d / "indrnn_bwd.cu")]
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
        print("torch_k3_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch.kernels.binding import _nvcc
    from mridc_tpu_torch.kernels.binding import build as build_package
    from mridc_tpu_torch.kernels.k3_indrnn import indrnn_bwd, indrnn_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(1) as pool:  # the package's own build beside the variants'
        package = pool.submit(build_package, ["indrnn_bwd"])
        libs = build(_nvcc())
        package.result()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    shape = (B, C, H, W)

    def cl(t):
        return t.to(dev, bf).contiguous(memory_format=torch.channels_last)

    x, h = cl(torch.randn(shape, generator=gen)), cl(torch.rand(shape, generator=gen))
    hn, g = cl(torch.relu(torch.randn(shape, generator=gen))), cl(torch.randn(shape, generator=gen))
    w = (torch.randn(C, C, generator=gen) / C**0.5).to(dev, bf)
    u = torch.rand(C, generator=gen).to(dev, bf)
    ops = (g, x, h, hn, w.view(C, C, 1, 1), u.view(1, C, 1, 1))
    plain32 = indrnn_bwd_plain(*(a.float() for a in ops))
    want = [plain32[0].to(bf), plain32[1].to(bf)]
    del plain32
    plain64 = indrnn_bwd_plain(*(a.double() for a in ops))
    want += [plain64[2].float(), plain64[3].float(), plain64[4].float()]
    del plain64
    limits = [(1e-2, 1e-3)] * 2 + [(1e-3, 1e-4)] * 3
    p = B * H * W
    dx, dh = torch.empty_like(x), torch.empty_like(h)
    sums = torch.empty(C * C + 2 * C, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn, iters=20):
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

    # the same function from library calls, on [P, C] views of the channels_last tensors
    x2, h2, hn2, g2 = (t.permute(0, 2, 3, 1).reshape(p, C) for t in (x, h, hn, g))

    def composed():
        gp = torch.where(hn2 > 0, g2, torch.zeros((), dtype=bf, device=dev))
        return gp @ w, u * gp, gp.t() @ x2, gp.float().sum(0), (h2.float() * gp.float()).sum(0)

    o1, o2 = torch.empty_like(x), torch.empty_like(h)

    def adds():
        torch.add(x, h, out=o1)
        torch.add(hn, g, out=o2)

    def wrapper():
        return indrnn_bwd(*ops)

    def host_us(fn, iters=20):
        """host time to enqueue one call, from a full queue (no synchronise
        inside the window)"""
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        return us

    nbytes = 2 * (2 * p * C + 4 * p * C + C * C) + 4 * (C * C + 3 * C)
    bound_ms = nbytes / 3.35e12 * 1e3
    for rnd in range(args.rounds):
        for name, fn in (("torch.add x2: the same bytes, no product", adds),
                         ("library calls (reference only): where, 2 matmul, mul, 2 sums", composed),
                         ("the package's wrapper (kernels/k3_indrnn.py:indrnn_bwd, shipped source)", wrapper)):
            print(json.dumps({"round": rnd, "variant": name, "ms": time_ms(fn), "host_us_per_call": host_us(fn),
                              "bound_ms": bound_ms}), flush=True)
        for name, lib_path in libs.items():
            lib = ctypes.CDLL(str(lib_path))
            lib.k3_indrnn_bwd_blocks.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            lib.k3_indrnn_bwd_blocks.restype = ctypes.c_int
            fn = lib.k3_indrnn_bwd_bf16
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            blocks = ctypes.c_int(0)
            err = lib.k3_indrnn_bwd_blocks(1, p, C, C, dev.index or 0, ctypes.byref(blocks))
            if err or blocks.value == 0:
                raise RuntimeError(f"{name}: no grid (CUDA error {err}, {blocks.value} blocks)")
            part = torch.empty((blocks.value, C * C + 2 * C), device=dev)

            def call():
                err = fn(x.data_ptr(), h.data_ptr(), hn.data_ptr(), g.data_ptr(), w.data_ptr(), u.data_ptr(),
                         dx.data_ptr(), dh.data_ptr(), part.data_ptr(), sums.data_ptr(), p, C, C, blocks.value,
                         dev.index or 0, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            rec = {"round": rnd, "variant": name, "blocks": blocks.value, "ms": time_ms(call), "bound_ms": bound_ms}
            if VARIANTS[name][1]:
                got = (dx, dh, sums[: C * C].view(C, C), sums[C * C : C * C + C], sums[C * C + C :])
                errs, ok = {}, True
                for part_name, a, b, (rtol, atol) in zip(("dx", "dh", "dW", "db", "du"), got, want, limits):
                    a, b = a.float(), b.float()
                    errs[part_name] = float((a - b).abs().max())
                    ok &= bool(torch.allclose(a, b, rtol=rtol, atol=atol * float(b.abs().max())))
                rec.update(max_abs_err=errs, ok=ok)
                if not ok:
                    raise AssertionError(f"{name}: disagrees with the plain version: {rec}")
            print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
