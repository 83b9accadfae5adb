#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's K1-f32 kernel (the psf1d DC of
the float32 flagship, forward and backward) on one NVIDIA GPU.

Each variant is ``mridc_tpu_torch/csrc/psf1d_dc.cu`` with a few text
substitutions (defined below): timing-only builds that leave part of the work
out, and other shapes of the design. All variants are built with nvcc into
their own libraries, started together, and timed at the flagship operands:
15 coils, 320x320, float32, the forward at B=8 (inference, phase 6 of
chip_smoke.py) and the backward at B=8 (the ``train_f32_psf1d`` step's batch),
drawn from a seed (eta, z0, g normal; unit-RSS sensitivities; bench.py's 1D
mask through psf1d_gauss_mats). The variants whose result is right are
checked against the plain version at chip_smoke.py's float32 limits (rtol
1e-4, atol 1e-4 x max; TF32 off for the oracle). Beside them, two yardsticks
that the port never calls:
  - ``bmm``: one float32 ``torch.bmm`` of the real-embedded product
    [B, 15*320, 640] x [B, 640, 640] with TF32 off, the tensor work alone (not
    the function: no coil expand, no coil sum);
  - ``bytes``: ``torch.add`` of two float32 tensors into a third, together as
    many bytes as the kernel's unique traffic (inputs read once, output
    written once).

    python3 tools/torch_k1_f32_variants.py [--rounds N] [--only NAME ...] [--baseline FILE]

``--baseline`` adds another version of ``psf1d_dc.cu`` (for instance the
parent commit's, from ``git show HEAD:mridc_tpu_torch/csrc/psf1d_dc.cu``),
built and timed as it is, so that two versions are compared within one run;
the rounds alternate the variants' order, so that the baseline and the
shipped kernel take turns.

Prints one JSON line per variant, case and round (ms, and the launch setup
where the build has ``k1_psf1d_dc_f32_setup``), then the card's name and
power limit. Builds go to ``mridc_tpu_torch/_build/k1_f32_variants/``.
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
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k1_f32_variants"
C, H, W, SIGMA, B = 15, 320, 320, 0.7, 8
SETUP_KEYS = ("blocks", "smem_bytes", "blocks_per_sm", "threads", "tile_h", "tile_u", "route")

# the first version's design, the wide route of the shipped source: every W
# on it, and timing-only builds of it
_WIDE = ("  for (const Setup& s : tiles)\n    if (s.fits()) return s;\n", "  (void)tiles;\n")
_W1_PRODUCTS_ALONE = ("    store(st);\n    __syncthreads();\n    if (it + 1 < iters) load(st, it + 1);",
                      "    __syncthreads();")
_W1_NO_MMA = ("for (int kk = 0; kk < TK; kk += 8) {  // wide", "for (int kk = 0; kk < 0; kk += 8) {")
_W1_NO_OP = ("      st.cr[k] = load4(cr_g + oc, m, vec);\n      st.cs[k] = load4(cs_g + oc, m, vec);\n",
             "")
_W1_NO_OP_STORE = ("      *reinterpret_cast<float4*>(&cr_s[q >> 2][4 * (q & 3)]) = r;\n"
                   "      *reinterpret_cast<float4*>(&ci_s[q >> 2][4 * (q & 3)]) =\n"
                   "          make_float4(cs.x - r.x, cs.y - r.y, cs.z - r.z, cs.w - r.w);  // Ci = (Cr+Ci) - Cr\n",
                   "")

# the on-chip design: other tiles and stage counts, other splits, and
# timing-only builds ("no MMA" keeps every load and
# split, folded into one accumulator; "no A loads" forms x from constants
# instead of the staged s_c and eta; "B constant" takes the operator fragments
# from constants, whose splits the compiler may hoist)
_TILES = "make<BWD, 2, 3>(W), make<BWD, 1, 3>(W), make<BWD, 1, 2>(W)"
_TWO_STAGES = (_TILES, "make<BWD, 2, 2>(W), make<BWD, 1, 3>(W), make<BWD, 1, 2>(W)")
_ROWS16 = (_TILES, "make<BWD, 1, 3>(W), make<BWD, 1, 2>(W)")  # 16 x 32 tiles at every W
_CVT_SPLITS = ("split_trunc(", "split(")  # cvt.rna.tf32.f32 for hi and lo
_SPLIT_ANCHOR = "// word of v in operator row r:"
_RNA_INT = [("split_trunc(", "split_rna("), (_SPLIT_ANCHOR,
            "__device__ __forceinline__ uint32_t rna(float x) {\n"
            "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n}\n"
            "__device__ __forceinline__ Split split_rna(float x) {\n  const uint32_t hi = rna(x);\n"
            "  return {hi, rna(x - __uint_as_float(hi))};\n}\n" + _SPLIT_ANCHOR)]
_NO_MMA = ("            mma3(acc[p][n], a[p], split_trunc(bv.x), split_trunc(bv.y));",
           "            acc[p][n][0] += __uint_as_float(a[p][0].hi ^ a[p][1].lo ^ a[p][2].hi ^ a[p][3].lo ^\n"
           "                                            split_trunc(bv.x).lo ^ split_trunc(bv.y).lo);")
_NO_COPY = ("      if (ic < C) {  // s_c copies", "      if (false) {  // s_c copies")
_NO_A_LOADS = [
    ("            const float4 s = *reinterpret_cast<const float4*>(slot + (g + 8 * hf) * 2 * KW + 4 * t4);",
     "            const float4 s = make_float4(1.f, 0.5f, 0.25f, 2.f);"),
    ("            const float4 e = *reinterpret_cast<const float4*>(eta_s + (size_t)r * 2 * kp + "
     "eta_sw(r, v0 + 2 * t4));",
     "            const float4 e = make_float4(r, 0.5f, v0, t4);"),
]
_B_CONST = ("            const float2 bv = *reinterpret_cast<const float2*>(b + p * plane);",
            "            const float2 bv = make_float2(r + 0.5f, p + 0.25f);")

# name -> (substitutions, result is right)
VARIANTS = {
    "shipped: Gauss form, 32 x 32 tiles, 8 warps in 4 K phases, 3 stages, truncating splits": ([], True),
    "2 stages at 32 x 32": ([_TWO_STAGES], True),
    "16 x 32 tiles (8 K phases) at W = 320": ([_ROWS16], True),
    "splits rounded to nearest by integer operations": (_RNA_INT, True),
    "splits by cvt.rna": ([_CVT_SPLITS], True),
    "timing only: no MMA": ([_NO_MMA], False),
    "timing only: no s_c copies in": ([_NO_COPY], False),
    "timing only: products alone (no s_c copies, no A loads)": ([_NO_COPY, *_NO_A_LOADS], False),
    "timing only: MMAs and A splits alone (no copies, no loads, B constant)": ([_NO_COPY, *_NO_A_LOADS, _B_CONST],
                                                                              False),
    "the first design (the wide route)": ([_WIDE], True),
    "wide route, timing only: products alone (no staging)": ([_WIDE, _W1_PRODUCTS_ALONE], False),
    "wide route, timing only: no MMA": ([_WIDE, _W1_NO_MMA], False),
    "wide route, timing only: no operator staging": ([_WIDE, _W1_NO_OP, _W1_NO_OP_STORE], False),
}


def build(nvcc: str, names, baseline=None) -> dict:
    src = (CSRC / "psf1d_dc.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        s = src if name != "baseline" else Path(baseline).read_text()
        for old, new in VARIANTS[name][0]:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:60]!r}")
            s = s.replace(old, new)
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "psf1d_dc.cu").write_text(s)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "psf1d_dc.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        regs = [ln.split("Used ")[1].strip() for ln in out.splitlines() if "Used" in ln and "registers" in ln]
        print(json.dumps({"variant": name, "build": str(d), "registers_per_kernel": regs}), flush=True)
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None, help="variant names (default: all)")
    ap.add_argument("--baseline", default=None, help="another psf1d_dc.cu to build and time as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch.kernels.binding import _nvcc
    from mridc_tpu_torch.kernels.k1_psf1d_dc import psf1d_dc_bwd_plain, psf1d_dc_plain
    from mridc_tpu_torch.nn.dc import psf1d_gauss_mats

    names = list(VARIANTS) if args.only is None else args.only
    if args.baseline:
        VARIANTS["baseline"] = ([], True)
        names.append("baseline")
    libs = build(_nvcc(), names, args.baseline)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

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
        err = float((got - want).abs().max())
        return err, bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max())))

    sens = rng.standard_normal((B, C, H, W, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    mask = np.zeros((B, W), np.float32)
    mask[:, ::4] = 1.0
    mask[:, W // 2 - 16 : W // 2 + 16] = 1.0
    mats = psf1d_gauss_mats(torch.from_numpy(mask).to(dev), True, "ortho").contiguous()
    eta, z0 = (torch.from_numpy(rng.standard_normal((B, H, W, 2)).astype(np.float32)).to(dev) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((B, H, W, 4)).astype(np.float32)).to(dev)
    sens = torch.from_numpy(sens).to(dev)
    # yardsticks: the real-embedded product (TF32 off), and the unique bytes
    x = torch.randn(B, C * H, 2 * W, device=dev)
    m = torch.randn(B, 2 * W, 2 * W, device=dev)
    y = torch.empty(B, C * H, 2 * W, device=dev)
    cases = {}
    for bwd in (False, True):
        if bwd:
            want = psf1d_dc_bwd_plain(g, sens, mats, SIGMA)
            out = torch.empty((B, H, W, 2), device=dev)
            ptrs = (g.data_ptr(), sens.data_ptr(), mats.data_ptr(), out.data_ptr())
        else:
            want = psf1d_dc_plain(eta, sens, mats, z0, SIGMA)
            out = torch.empty((B, H, W, 4), device=dev)
            ptrs = (eta.data_ptr(), sens.data_ptr(), mats.data_ptr(), z0.data_ptr(), out.data_ptr())
        # eta and z0 (forward) or g (backward) in, sens and the 3 planes in, the output out
        nbytes = 4 * (B * H * W * 4 + B * C * H * W * 2 + B * 3 * W * W + B * H * W * (2 if bwd else 4))
        n = nbytes // 12
        p, q, r = (torch.empty(n, device=dev).normal_() for _ in range(3))
        cases[f"{'bwd' if bwd else 'fwd'}_b{B}"] = dict(
            bwd=bwd, ptrs=ptrs, out=out, want=want, nbytes=nbytes,
            bytes=lambda p=p, q=q, r=r: torch.add(p, q, out=r))

    stream = torch.cuda.current_stream().cuda_stream
    loaded = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
    for rnd in range(args.rounds):
        print(json.dumps({"round": rnd, "yardstick": "bmm", "ms": time_ms(lambda: torch.bmm(x, m, out=y)),
                          "shape": [B, C * H, 2 * W, 2 * W]}), flush=True)
        for key, cs in cases.items():
            print(json.dumps({"round": rnd, "case": key, "yardstick": "bytes", "ms": time_ms(cs["bytes"]),
                              "bytes": cs["nbytes"]}), flush=True)
        order = list(loaded.items()) if rnd % 2 == 0 else list(loaded.items())[::-1]
        for name, lib in order:
            setup = getattr(lib, "k1_psf1d_dc_f32_setup", None)  # a baseline may not have it
            if setup is not None:
                setup.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            for key, cs in cases.items():
                bwd = cs["bwd"]
                fn = lib.k1_psf1d_dc_bwd_f32 if bwd else lib.k1_psf1d_dc_f32
                fn.argtypes = [ctypes.c_void_p] * len(cs["ptrs"]) + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                                          ctypes.c_void_p]
                info = (ctypes.c_int * len(SETUP_KEYS))()
                if setup is not None:
                    setup(int(bwd), B, H, W, dev.index or 0, info)

                def call(fn=fn, cs=cs):
                    err = fn(*cs["ptrs"], B, C, H, W, 1.0 / SIGMA**2, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                cs["out"].fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                rec = {"round": rnd, "variant": name, "case": key, "ms": time_ms(call)}
                if setup is not None:
                    rec["setup"] = dict(zip(SETUP_KEYS, list(info)))
                if VARIANTS[name][1]:
                    rec["max_abs_err"], rec["ok"] = close(cs["out"], cs["want"])
                    if not rec["ok"]:
                        raise AssertionError(f"{name}: disagrees with the plain version: {rec}")
                print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
