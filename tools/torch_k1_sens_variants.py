#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's maps-gradient kernels
(``k1_psf1d_sens_bf16`` and ``k1_psf1d_sens_f32``, K1's gradient in the
sensitivity maps) on one NVIDIA GPU.

Each variant is ``mridc_tpu_torch/csrc/psf1d_sens.cu`` with a few text
substitutions (defined below): for bf16 the row groups of a tile, the stages
of each group's s_c ring and the MMAs' order; for float32 the tile's width,
the stages of each warp's s_c ring and the MMAs' order; for both, timing-only
builds that leave part of the work out. All variants are built with nvcc into
their own libraries, started together, and timed at the operands of phase J1
of chip_smoke.py: B=8, 15 coils, 320x320, drawn from a seed (eta and an
upstream g normal; unit-RSS sensitivities; bench.py's 1D mask through
psf1d_gauss_mats, centered ortho), sigma 0.7. Each variant whose result is
right is checked there and at a width no on-chip tile holds (B=1, 4 coils,
24x640: the wide route) against the plain version at chip_smoke.py's limit,
d_eta and d_sens each: bf16 rtol 1e-2, atol 1e-2 x max against the plain version in
float32 on the same bf16 operands, rounded once; float32 rtol 1e-4, atol 1e-4
x max. Beside them, yardsticks that the port never calls:
  - ``bmm``: one ``torch.bmm`` of the real-embedded product
    [B, 2*15*320, 640] x [B, 640, 640] in the kernel's dtype, the tensor-core
    work of the two complex products a coil row takes (four real products
    each); in float32 twice, with TF32 off (``bmm_fp32``) and on
    (``bmm_tf32``);
  - ``plain``: the plain version (``psf1d_dc_sens_bwd_plain``), the port's
    twin of the kernel.

    python3 tools/torch_k1_sens_variants.py [--dtype bfloat16|float32] [--rounds N] [--only NAME ...]
                                            [--baseline FILE]

``--baseline`` adds another version of ``psf1d_sens.cu`` (for instance the
parent commit's, from ``git show``), built and timed as it is, so that two
versions are compared within one run.

Prints one JSON line per variant with its ptxas report (registers and spills
of each kernel), then one per variant, operand set and round (ms, max abs err,
and the launch setup where the version has the query: blocks, shared memory,
blocks per SM, threads, tile rows and columns, route), then the card's name
and power limit. Builds go to ``mridc_tpu_torch/_build/k1_sens_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "mridc_tpu_torch" / "csrc"
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k1_sens_variants"
SIGMA = 0.7
CASES = {"j1_b8": (8, 15, 320, 320), "wide_w640": (1, 4, 24, 640)}
SETUP_KEYS = ("blocks", "smem_bytes", "blocks_per_sm", "threads", "tile_h", "tile_u", "route")

_NO_MMA = ("for (int kk = 0; kk < TK; kk += 16) {\n          uint32_t a[4][4]",
           "for (int kk = 0; kk < 0; kk += 16) {\n          uint32_t a[4][4]")
_NO_COPY = ("      if (i < iters) {\n        const bf16* s_c", "      if (false) {\n        const bf16* s_c")
_PAIRED = ("""#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[0][n], a[0], bq[0][2 * n], bq[0][2 * n + 1]);
            mma_bf16(acc[1][n], a[0], bq[1][2 * n], bq[1][2 * n + 1]);
            mma_bf16(acc[2][n], a[2], bq[0][2 * n], bq[0][2 * n + 1]);
            mma_bf16(acc[3][n], a[2], bq[1][2 * n], bq[1][2 * n + 1]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[0][n], a[1], bq[1][2 * n] ^ SIGN2, bq[1][2 * n + 1] ^ SIGN2);
            mma_bf16(acc[1][n], a[1], bq[0][2 * n], bq[0][2 * n + 1]);
            mma_bf16(acc[2][n], a[3], bq[1][2 * n] ^ SIGN2, bq[1][2 * n + 1] ^ SIGN2);
            mma_bf16(acc[3][n], a[3], bq[0][2 * n], bq[0][2 * n + 1]);
          }""", """#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint32_t r0 = bq[0][2 * n], r1 = bq[0][2 * n + 1], i0 = bq[1][2 * n], i1 = bq[1][2 * n + 1];
            mma_bf16(acc[0][n], a[0], r0, r1);
            mma_bf16(acc[0][n], a[1], i0 ^ SIGN2, i1 ^ SIGN2);
            mma_bf16(acc[1][n], a[0], i0, i1);
            mma_bf16(acc[1][n], a[1], r0, r1);
            mma_bf16(acc[2][n], a[2], r0, r1);
            mma_bf16(acc[2][n], a[3], i0 ^ SIGN2, i1 ^ SIGN2);
            mma_bf16(acc[3][n], a[2], i0, i1);
            mma_bf16(acc[3][n], a[3], r0, r1);
          }""")
_NO_CONVERT = ("      if (i + 1 < iters) convert(i + 1);", "      if (false) convert(i + 1);")

# name -> (substitutions, result is right)
BF16_VARIANTS = {
    "shipped: 32 x 64 tiles, 3 stages": ([], True),
    "16 x 64 tiles (one row group)": ([("constexpr int GROUPS = 2,", "constexpr int GROUPS = 1,")], True),
    "2 stages": ([("constexpr int STAGES = 3;   // raw s_c", "constexpr int STAGES = 2;   // raw s_c")], True),
    "4 stages": ([("constexpr int STAGES = 3;   // raw s_c", "constexpr int STAGES = 4;   // raw s_c")], True),
    "MMAs in pairs on one accumulator (K1-bf16 forward's order)": ([_PAIRED], True),
    "timing only: no MMA": ([_NO_MMA], False),
    "timing only: no s_c copies in": ([_NO_COPY], False),
    "timing only: no conversion": ([_NO_CONVERT], False),
    # the coil epilogue stays: it keeps the products' accumulators live
    "timing only: MMAs and coil epilogues alone": ([_NO_COPY, _NO_CONVERT], False),
}

_F32_MMAS = """#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q][p][n], a[q][p][0].hi, a[q][p][1].hi, a[q][p][2].hi, a[q][p][3].hi, bs[p][0].lo,
                       bs[p][1].lo);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q][p][n], a[q][p][0].lo, a[q][p][1].lo, a[q][p][2].lo, a[q][p][3].lo, bs[p][0].hi,
                       bs[p][1].hi);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q][p][n], a[q][p][0].hi, a[q][p][1].hi, a[q][p][2].hi, a[q][p][3].hi, bs[p][0].hi,
                       bs[p][1].hi);"""
_F32_CHAINED = (_F32_MMAS, """#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q) mma3(acc[q][p][n], a[q][p], bs[p][0], bs[p][1]);""")
_F32_NO_MMA = (_F32_MMAS, "")
_F32_NO_COPY = ("      if (ik < mine) {\n        const float* s_c", "      if (false) {\n        const float* s_c")
# x and y's operands from registers, not shared memory: the products, their splits and the B loads stay
_F32_NO_A_LOADS = ("""            const float4 s = *reinterpret_cast<const float4*>(sl + r * 2 * KW + 4 * t4);
            const float4 e = *reinterpret_cast<const float4*>(eta_s + o);
            const float4 q = *reinterpret_cast<const float4*>(g_s + o);""",
                   """            const float4 s = make_float4(v0 + r, o, 0.5f, 0.25f), e = make_float4(o, v0, 1.f, 0.75f);
            const float4 q = make_float4(r, o, v0, 0.125f);""")

# the 8-deep step at v = 0 every time: x and y's fragments (from registers, as above) hoist out of the loop
_F32_ONE_STEP = ("        const int v0 = jc * KW;\n        Split a[2][3][4];", "        const int v0 = 0;\n        Split a[2][3][4];")
# the operator's fragments from registers too: the MMAs alone are left in the loop
_F32_NO_B_LOADS = ("            const float2 bv = *reinterpret_cast<const float2*>(bp + p * plane);",
                   "            const float2 bv = make_float2(r + 0.5f, p + 0.25f);")

F32_VARIANTS = {
    "shipped: 16 x 32 tiles, 3 stages": ([], True),
    "16 x 16 tiles": ([("constexpr int TN = 32;     // columns u a tile", "constexpr int TN = 16;     // columns u a tile")],
                      True),
    "2 stages": ([("constexpr int STAGES = 3;  // raw s_c chunks a warp", "constexpr int STAGES = 2;  // raw s_c chunks a warp")],
                 True),
    "MMAs chained per accumulator (mma3, K1-f32 forward's order)": ([_F32_CHAINED], True),
    "timing only: no MMA (nor the splits and loads that feed them)": ([_F32_NO_MMA], False),
    "timing only: no s_c copies in": ([_F32_NO_COPY], False),
    "timing only: MMAs, their splits, B loads and coil epilogues alone": ([_F32_NO_COPY, _F32_NO_A_LOADS], False),
    "timing only: MMAs with B loads and splits alone": ([_F32_NO_COPY, _F32_NO_A_LOADS, _F32_ONE_STEP], False),
    "timing only: MMAs alone": ([_F32_NO_COPY, _F32_NO_A_LOADS, _F32_ONE_STEP, _F32_NO_B_LOADS], False),
}


def build(nvcc: str, variants: dict, names, baseline=None) -> dict:
    src = (CSRC / "psf1d_sens.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        s = src if name != "baseline" else Path(baseline).read_text()
        for old, new in variants[name][0]:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:60]!r}")
            s = s.replace(old, new)
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "psf1d_sens.cu").write_text(s)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "psf1d_sens.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        report = [ln.split("ptxas info    : ")[-1] for ln in out.splitlines()
                  if ("Used" in ln and "registers" in ln) or "spill" in ln or "Compiling entry" in ln]
        print(json.dumps({"variant": name, "build": str(d), "ptxas": report}), flush=True)
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None, help="variant names (default: all)")
    ap.add_argument("--baseline", default=None, help="another psf1d_sens.cu to build and time as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_sens_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch.kernels.binding import _nvcc
    from mridc_tpu_torch.kernels.k1_psf1d_dc import psf1d_dc_sens_bwd_plain
    from mridc_tpu_torch.nn.dc import psf1d_gauss_mats

    f32 = args.dtype == "float32"
    variants = dict(F32_VARIANTS if f32 else BF16_VARIANTS)
    names = list(variants) if args.only is None else args.only
    if args.baseline:
        variants["baseline"] = ([], True)
        names.append("baseline")
    libs = build(_nvcc(), variants, names, args.baseline)
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    tol = 1e-4 if f32 else 1e-2
    symbol = "k1_psf1d_sens_f32" if f32 else "k1_psf1d_sens_bf16"
    rng = np.random.default_rng(0)

    def operands(b, c, h, w):
        sens = rng.standard_normal((b, c, h, w, 2)).astype(np.float32)
        sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
        mask = np.zeros((b, w), np.float32)
        mask[:, ::4] = 1.0
        mask[:, w // 2 - 16 : w // 2 + 16] = 1.0
        mats = psf1d_gauss_mats(torch.from_numpy(mask).to(dev), True, "ortho")
        eta = rng.standard_normal((b, h, w, 2)).astype(np.float32)
        g = rng.standard_normal((b, h, w, 4)).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev, dt)  # noqa: E731
        return t(g), t(eta), t(sens), mats.to(dt)

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

    def close(got, want):
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        return err, bool(torch.isfinite(got).all()) and bool(
            torch.allclose(got, want, rtol=tol, atol=tol * float(want.abs().max())))

    def bmm(x, m, y, tf32=False):
        def call():
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                torch.bmm(x, m, out=y)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return call

    cases = {}
    for key, (b, c, h, w) in CASES.items():
        g, eta, sens, mats = operands(b, c, h, w)
        want = [t.to(dt) for t in psf1d_dc_sens_bwd_plain(g.float(), eta.float(), sens.float(), mats.float(), SIGMA)]
        d_eta = torch.empty((b, h, w, 2), dtype=dt, device=dev)
        ds = torch.empty((b, c, h, w, 2), dtype=dt, device=dev)
        x = torch.randn(b, 2 * c * h, 2 * w, device=dev, dtype=dt)
        m = torch.randn(b, 2 * w, 2 * w, device=dev, dtype=dt)
        y = torch.empty(b, 2 * c * h, 2 * w, device=dev, dtype=dt)
        yards = {"bmm_fp32": bmm(x, m, y), "bmm_tf32": bmm(x, m, y, tf32=True)} if f32 else {"bmm": bmm(x, m, y)}
        cases[key] = dict(shape=(b, c, h, w), ptrs=(g.data_ptr(), eta.data_ptr(), sens.data_ptr(), mats.data_ptr(),
                                                    ds.data_ptr(), d_eta.data_ptr()),
                          out=(d_eta, ds), want=want, keep=(g, eta, sens, mats),
                          yards={**yards, "plain": lambda a=(g, eta, sens, mats): psf1d_dc_sens_bwd_plain(*a, SIGMA)})

    stream = torch.cuda.current_stream().cuda_stream
    for rnd in range(args.rounds):
        for key, cs in cases.items():
            for yard, fn in cs["yards"].items():
                print(json.dumps({"round": rnd, "dtype": args.dtype, "case": key, "yardstick": yard,
                                  "ms": time_ms(fn)}), flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            setup = getattr(lib, f"{symbol}_setup", None)  # a baseline may not have it
            if setup is not None:
                setup.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
            for key, cs in cases.items():
                b, c, h, w = cs["shape"]
                info = (ctypes.c_int * len(SETUP_KEYS))()
                if setup is not None and setup(b, h, w, dev.index or 0, info):
                    raise RuntimeError(f"{name}: setup query failed")

                def call(cs=cs, b=b, c=c, h=h, w=w):
                    err = fn(*cs["ptrs"], b, c, h, w, 1.0 / SIGMA**2, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                for t in cs["out"]:
                    t.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                rec = {"round": rnd, "dtype": args.dtype, "variant": name, "case": key, "ms": time_ms(call),
                       "setup": dict(zip(SETUP_KEYS, list(info))) if setup is not None else None}
                if variants[name][1]:
                    for part, got, want in zip(("d_eta", "d_sens"), cs["out"], cs["want"]):
                        rec[f"{part}_max_abs_err"], ok = close(got, want)
                        if not ok:
                            raise AssertionError(f"{name}: {part} disagrees with the plain version: {rec}")
                print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
