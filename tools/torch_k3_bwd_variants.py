#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's K3-bwd kernels on one NVIDIA GPU.

Each variant is ``mridc_tpu_torch/csrc/indrnn_bwd.cu`` with a few text
substitutions (defined below), built with nvcc into its own library (all
builds started together) and timed at the flagship training step's K3-bwd
operands: 320x320 pixels, 64 -> 64 channels, channels_last, at B=24 in
bfloat16 (``train_bf16_psf1d``) or at B=8 in float32 (``train_f32_psf1d`` and
``train_f32_full``), drawn from a seed (x normal, h >= 0, h' = relu of a normal
draw: about half its entries 0, g normal). Beside them: two PyTorch
elementwise passes that move the same bytes (``torch.add(x, h)`` and
``torch.add(h', g)``: four tensors in, two out), the yardstick for a
memory-bound kernel, and, for reference only, the same function composed from
library calls (the relu mask, two ``torch.matmul`` with TF32 off and the
elementwise sums), and the package's own wrapper
(``kernels/k3_indrnn.py:indrnn_bwd``, as the training step calls it), each
also with the host's time to enqueue one call. Variants marked ``timing
only`` leave out part of the work and give a wrong result; the others are
checked against the plain version at chip_smoke.py's phase-9 limits (bf16:
dx, dh rtol 1e-2, atol 1e-3 x max against float32 rounded once; dW, db, du
rtol 1e-3, atol 1e-4 x max against float64; float32: rtol 1e-4, atol 1e-4 x
max for all five, dx and dh against float32).

    python3 tools/torch_k3_bwd_variants.py [--dtype bfloat16|float32] [--rounds N] [--baseline FILE]

``--baseline`` adds another version of ``indrnn_bwd.cu`` (for instance the
parent commit's, from ``git show HEAD:mridc_tpu_torch/csrc/indrnn_bwd.cu``),
built and timed as it is, so that two versions are compared within one run;
the rounds alternate the variants' order, so that the baseline and the
shipped kernel take turns.

Prints one JSON line per build (registers and spills from ``-Xptxas -v``) and
per variant and round (ms, and the launch setup where the build has
``k3_indrnn_bwd_setup``), each with the card's name and power limit
(``nvidia-smi``). Builds go to ``mridc_tpu_torch/_build/k3_bwd_variants/``.
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
H, W, C = 320, 320, 64
BATCH = {"bfloat16": 24, "float32": 8}

# bfloat16 (tc::indrnn_bwd_bf16_kernel)
_LAYOUT_BYTES = "return 2 * ((size_t)fp * lx + (size_t)TP * lx + (size_t)STAGES * stage);"
BF16_VARIANTS = {
    "shipped: 64-pixel tiles, 2 stages, 4 warps (2 blocks per SM)": ([], True),
    "1 block per SM (shared memory padded by 64 KB)": (
        [(_LAYOUT_BYTES, _LAYOUT_BYTES.replace(");", ") + 65536;"))], True),
    "timing only: no MMA (copies, staging epilogue, dh and dx stores)": (
        [("for (int kk = 0; kk < TP; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {"),
         ("for (int kk = 0; kk < L.fp; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {")], False),
    "timing only: no copies in (epilogue, MMAs and stores alone)": (
        [("    if (t < tiles) {\n      const size_t p0", "    if (false) {\n      const size_t p0")], False),
}

# float32 (tf32::indrnn_bwd_f32_kernel). The MMAs are volatile asm, so the
# compiler keeps them, and the loads and splits that feed them, whatever else
# a timing-only build leaves out
_F32_STAGES = "constexpr int STAGES = 3;"


def _f32_stages(n):
    return (_F32_STAGES, _F32_STAGES.replace("3;", f"{n};"))


_F32_NO_DW_MMA = ("for (int kk = 0; kk < TP; kk += 8) {", "for (int kk = 0; kk < 0; kk += 8) {")
_F32_NO_DX_MMA = ("for (int ks = 0; ks < FP / 8; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")
_F32_NO_COPIES = ("    if (t < tiles) {\n      const int p0 = t * TP, rows",
                  "    if (false) {\n      const int p0 = t * TP, rows")
_F32_NO_FETCH = ("const bool ok = active && t < tiles", "const bool ok = false && t < tiles")
_F32_NO_EPILOGUE = ("      if (!active || r >= TP) continue;", "      continue;")
_F32_NO_DX_STORES = ("          if (p < P)\n", "          if (p < 0)\n")
# h and h' loaded where the epilogue uses them, not a tile ahead
_F32_LATE_FETCH = [("  fetch(blockIdx.x);\n", ""),
                   ("    fetch(t + gridDim.x);\n", ""),
                   ("    // g' = g [h' > 0] in place;", "    fetch(t);\n    // g' = g [h' > 0] in place;")]
# dW summed over all of a block's tiles in the MMAs' accumulators
_F32_LONG_SUMS = [("mma_tf32(tw[mi][ni]", "mma_tf32(acc_w[mi][ni]"),
                  ("acc_w[mi][ni][j] += tw[mi][ni][j];", "(void)tw[mi][ni][j];")]
# dh = u g' stored in the staging epilogue (the first build) instead of after
# the tile's dW products
_F32_DH_LATE = """    if (dh != nullptr) {
#pragma unroll
      for (int j = 0; j < S::RQ; ++j) {
        const int r = r0 + j * rstep;
        if (!active || r >= TP || p0 + r >= P) continue;
        const float4 gp = *reinterpret_cast<const float4*>(gs + r * FP + ((4 * q) ^ swz(r)));
        *reinterpret_cast<float4*>(dh + (size_t)(p0 + r) * F + 4 * q) =
            make_float4(uq.x * gp.x, uq.y * gp.y, uq.z * gp.z, uq.w * gp.w);
      }
    }
"""
_F32_NO_DH_STORES = (_F32_DH_LATE, "")
_F32_DH_IN_EPILOGUE = [_F32_NO_DH_STORES, ("      *pg = gp;\n", """      *pg = gp;
      if (dh != nullptr && p0 + r < P)
        *reinterpret_cast<float4*>(dh + (size_t)(p0 + r) * F + 4 * q) =
            make_float4(uq.x * gp.x, uq.y * gp.y, uq.z * gp.z, uq.w * gp.w);
""")]
F32_VARIANTS = {
    "shipped: 3xTF32 mma.sync, truncating splits, 64-pixel tiles, 3 stages (1 block per SM), h and h' a tile "
    "ahead in registers, dW summed per tile, dh stored after the dW products": ([], True),
    "dW summed over all of a block's tiles in the MMA accumulators": (_F32_LONG_SUMS, True),
    "dh stored in the staging epilogue": (_F32_DH_IN_EPILOGUE, True),
    "2 stages (2 blocks per SM)": ([_f32_stages(2)], True),
    "2 stages (2 blocks per SM), no prefetch": ([_f32_stages(2), *_F32_LATE_FETCH], True),
    "splits by cvt.rna": ([("split_trunc(", "split(")], True),
    "timing only: no dx stores": ([_F32_NO_DX_STORES], False),
    "timing only: no dh stores": ([_F32_NO_DH_STORES], False),
    "timing only: no h/h' loads": ([_F32_NO_FETCH], False),
    "timing only: no MMA (copies, h/h' loads, epilogue, dh and dx stores)": ([_F32_NO_DW_MMA, _F32_NO_DX_MMA], False),
    "timing only: no copies in, no h/h' loads (epilogue, MMAs and stores alone)": (
        [_F32_NO_COPIES, _F32_NO_FETCH], False),
    "timing only: MMAs and their loads and splits alone (no copies, h/h' loads, epilogue or stores)": (
        [_F32_NO_COPIES, _F32_NO_FETCH, _F32_NO_EPILOGUE, _F32_NO_DX_STORES, _F32_NO_DH_STORES], False),
}


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def build(nvcc: str, variants: dict, baseline, card: str) -> dict:
    src = (CSRC / "indrnn_bwd.cu").read_text()
    procs = {}
    for i, (name, (subs, _)) in enumerate(variants.items()):
        s = Path(baseline).read_text() if name == "baseline" else src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:60]!r}")
            s = s.replace(old, new)
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "indrnn_bwd.cu").write_text(s)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "indrnn_bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        kernels, cur = {}, None
        for ln in out.splitlines():
            if "Compiling entry function" in ln:
                cur = ln.split("'")[1]
            elif cur and ("Used" in ln or "spill" in ln):
                kernels[cur] = (kernels.get(cur, "") + " " + ln.replace("ptxas info    :", "").strip()).strip()
        print(json.dumps({"variant": name, "build": str(d),
                          "ptxas": {k: v for k, v in kernels.items() if "bwd" in k}, "card": card}), flush=True)
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(BATCH), default="bfloat16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", default=None, help="another indrnn_bwd.cu to build and time as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch.kernels.binding import _nvcc
    from mridc_tpu_torch.kernels.binding import build as build_package
    from mridc_tpu_torch.kernels.k3_indrnn import BWD_SETUP_KEYS, indrnn_bwd, indrnn_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    f32 = args.dtype == "float32"
    variants = dict(F32_VARIANTS if f32 else BF16_VARIANTS)
    if args.baseline:
        variants["baseline"] = ([], True)
    with ThreadPoolExecutor(1) as pool:  # the package's own build beside the variants'
        package = pool.submit(build_package, ["indrnn_bwd"])
        libs = build(_nvcc(), variants, args.baseline, card)
        package.result()
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    B = BATCH[args.dtype]
    gen = torch.Generator().manual_seed(0)
    shape = (B, C, H, W)

    def cl(t):
        return t.to(dev, dt).contiguous(memory_format=torch.channels_last)

    x, h = cl(torch.randn(shape, generator=gen)), cl(torch.rand(shape, generator=gen))
    hn, g = cl(torch.relu(torch.randn(shape, generator=gen))), cl(torch.randn(shape, generator=gen))
    w = (torch.randn(C, C, generator=gen) / C**0.5).to(dev, dt)
    u = torch.rand(C, generator=gen).to(dev, dt)
    ops = (g, x, h, hn, w.view(C, C, 1, 1), u.view(1, C, 1, 1))
    plain32 = indrnn_bwd_plain(*(a.float() for a in ops))
    want = [plain32[0].to(dt), plain32[1].to(dt)]
    del plain32
    plain64 = indrnn_bwd_plain(*(a.double() for a in ops))
    want += [plain64[2].float(), plain64[3].float(), plain64[4].float()]
    del plain64
    limits = [(1e-4, 1e-4)] * 5 if f32 else [(1e-2, 1e-3)] * 2 + [(1e-3, 1e-4)] * 3
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
        gp = torch.where(hn2 > 0, g2, torch.zeros((), dtype=dt, device=dev))
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

    es = x.element_size()
    nbytes = es * (2 * p * C + 4 * p * C + C * C) + 4 * (C * C + 3 * C)
    bound_ms = nbytes / 3.35e12 * 1e3
    loaded = {}
    for name, lib_path in libs.items():
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, f"k3_indrnn_bwd_{'f32' if f32 else 'bf16'}")
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        setup = (ctypes.c_int * len(BWD_SETUP_KEYS))()
        if hasattr(lib, "k3_indrnn_bwd_setup"):
            lib.k3_indrnn_bwd_setup.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            err = lib.k3_indrnn_bwd_setup(int(not f32), p, C, C, dev.index or 0, setup)
            info = dict(zip(BWD_SETUP_KEYS, list(setup)))
        else:  # an older source: the grid alone
            lib.k3_indrnn_bwd_blocks.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            err = lib.k3_indrnn_bwd_blocks(int(not f32), p, C, C, dev.index or 0, setup)
            info = {"blocks": setup[0]}
        if err or info["blocks"] == 0:
            raise RuntimeError(f"{name}: no grid (CUDA error {err}, {info})")
        part = torch.empty((info["blocks"], C * C + 2 * C), device=dev)
        loaded[name] = (fn, info, part)

    for rnd in range(args.rounds):
        for name, fn in (("torch.add x2: the same bytes, no product", adds),
                         ("library calls (reference only): where, 2 matmul, mul, 2 sums", composed),
                         ("the package's wrapper (kernels/k3_indrnn.py:indrnn_bwd, shipped source)", wrapper)):
            print(json.dumps({"round": rnd, "dtype": args.dtype, "batch": B, "variant": name, "ms": time_ms(fn),
                              "host_us_per_call": host_us(fn), "bound_ms": bound_ms, "card": card}), flush=True)
        order = list(loaded.items()) if rnd % 2 == 0 else list(loaded.items())[::-1]
        for name, (fn, info, part) in order:

            def call(fn=fn, info=info, part=part):
                err = fn(x.data_ptr(), h.data_ptr(), hn.data_ptr(), g.data_ptr(), w.data_ptr(), u.data_ptr(),
                         dx.data_ptr(), dh.data_ptr(), part.data_ptr(), sums.data_ptr(), p, C, C, info["blocks"],
                         dev.index or 0, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            for t in (dx, dh, sums):
                t.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            rec = {"round": rnd, "dtype": args.dtype, "batch": B, "variant": name, "setup": info,
                   "ms": time_ms(call), "bound_ms": bound_ms, "card": card}
            if variants[name][1]:
                got = (dx, dh, sums[: C * C].view(C, C), sums[C * C : C * C + C], sums[C * C + C :])
                errs, ok = {}, True
                for part_name, a, b, (rtol, atol) in zip(("dx", "dh", "dW", "db", "du"), got, want, limits):
                    a, b = a.float(), b.float()
                    errs[part_name] = float((a - b).abs().max())
                    ok &= bool(torch.isfinite(a).all()) and bool(
                        torch.allclose(a, b, rtol=rtol, atol=atol * float(b.abs().max())))
                rec.update(max_abs_err=errs, ok=ok)
                if not ok:
                    raise AssertionError(f"{name}: disagrees with the plain version: {rec}")
            print(json.dumps(rec), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
