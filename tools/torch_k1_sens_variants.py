#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's bf16 maps-gradient kernel
(``k1_psf1d_sens_bf16``, K1's gradient in the sensitivity maps) on one NVIDIA
GPU.

Each variant is ``mridc_tpu_torch/csrc/psf1d_sens.cu`` with a few text
substitutions (defined below): the row groups of a tile, the stages of each
group's s_c ring, and timing-only builds that leave part of the work out.
All variants are built with nvcc into their own libraries, started together,
and timed at the operands of phase J1 of chip_smoke.py: B=8, 15 coils,
320x320, bfloat16, drawn from a seed (eta and an upstream g normal;
unit-RSS sensitivities; bench.py's 1D mask through psf1d_gauss_mats, centered
ortho), sigma 0.7. Each variant whose result is right is checked there, and
at a width no on-chip tile holds (B=1, 4 coils, 24x640: the wide route),
against the plain version at chip_smoke.py's limit (rtol 1e-2, atol 1e-2 x
max against the plain version in float32 on the same bf16 operands, rounded
once), d_eta and d_sens each. Beside them, two yardsticks that the port
never calls:
  - ``bmm``: one bf16 ``torch.bmm`` of the real-embedded product
    [B, 2*15*320, 640] x [B, 640, 640], the tensor-core work of the two
    complex products a coil row takes (four real products each);
  - ``plain``: the plain version (``psf1d_dc_sens_bwd_plain``) on the bf16
    operands, the port's twin of the kernel.

    python3 tools/torch_k1_sens_variants.py [--rounds N] [--only NAME ...] [--baseline FILE]

``--baseline`` adds another version of ``psf1d_sens.cu`` (for instance the
parent commit's, from ``git show``), built and timed as it is, so that two
versions are compared within one run.

Prints one JSON line per variant, operand set and round (ms, max abs err, and
the launch setup where the version has the query: blocks, shared memory,
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
VARIANTS = {
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


def build(nvcc: str, names, baseline=None) -> dict:
    src = (CSRC / "psf1d_sens.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        s = src if name != "baseline" else Path(baseline).read_text()
        for old, new in VARIANTS[name][0]:
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

    names = list(VARIANTS) if args.only is None else args.only
    if args.baseline:
        VARIANTS["baseline"] = ([], True)
        names.append("baseline")
    libs = build(_nvcc(), names, args.baseline)
    dev = torch.device("cuda")
    bf = torch.bfloat16
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
        t = lambda a: torch.from_numpy(a).to(dev, bf)  # noqa: E731
        return t(g), t(eta), t(sens), mats.to(bf)

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
            torch.allclose(got, want, rtol=1e-2, atol=1e-2 * float(want.abs().max())))

    cases = {}
    for key, (b, c, h, w) in CASES.items():
        g, eta, sens, mats = operands(b, c, h, w)
        want = [t.to(bf) for t in psf1d_dc_sens_bwd_plain(g.float(), eta.float(), sens.float(), mats.float(), SIGMA)]
        d_eta = torch.empty((b, h, w, 2), dtype=bf, device=dev)
        ds = torch.empty((b, c, h, w, 2), dtype=bf, device=dev)
        x = torch.randn(b, 2 * c * h, 2 * w, device=dev, dtype=bf)
        m = torch.randn(b, 2 * w, 2 * w, device=dev, dtype=bf)
        y = torch.empty(b, 2 * c * h, 2 * w, device=dev, dtype=bf)
        cases[key] = dict(shape=(b, c, h, w), ptrs=(g.data_ptr(), eta.data_ptr(), sens.data_ptr(), mats.data_ptr(),
                                                    ds.data_ptr(), d_eta.data_ptr()),
                          out=(d_eta, ds), want=want, keep=(g, eta, sens, mats),
                          bmm=lambda x=x, m=m, y=y: torch.bmm(x, m, out=y),
                          plain=lambda a=(g, eta, sens, mats): psf1d_dc_sens_bwd_plain(*a, SIGMA))

    stream = torch.cuda.current_stream().cuda_stream
    for rnd in range(args.rounds):
        for key, cs in cases.items():
            for yard in ("bmm", "plain"):
                print(json.dumps({"round": rnd, "case": key, "yardstick": yard, "ms": time_ms(cs[yard])}), flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            setup = getattr(lib, "k1_psf1d_sens_bf16_setup", None)  # a baseline may not have it
            if setup is not None:
                setup.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            fn = lib.k1_psf1d_sens_bf16
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
                rec = {"round": rnd, "variant": name, "case": key, "ms": time_ms(call),
                       "setup": dict(zip(SETUP_KEYS, list(info))) if setup is not None else None}
                if VARIANTS[name][1]:
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
