#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's K1-bf16 kernel (the psf1d DC,
forward and backward) on one NVIDIA GPU.

Each variant is ``mridc_tpu_torch/csrc/psf1d_dc.cu`` with a few text
substitutions (defined below): the tile width, the stages of each warp
pair's s_c ring, and timing-only builds that leave part of the work out. All
variants are built
with nvcc into their own libraries, started together, and timed at the
flagship operands: 15 coils, 320x320, the forward at B=8 (inference, phase 6
of chip_smoke.py) and B=24 (training), the backward at B=24, bfloat16, drawn
from a seed (eta, z0, g normal; unit-RSS sensitivities; bench.py's 1D mask
through psf1d_gauss_mats). The variants whose result is right are checked
against the plain version at chip_smoke.py's limits (rtol 1e-2, atol 1e-2 x
max against the plain version in float32 on the same bf16 operands, rounded
once). Beside them, two yardsticks that the port never calls:
  - ``bmm``: one bf16 ``torch.bmm`` of the real-embedded product
    [B, 15*320, 640] x [B, 640, 640], the same tensor-core work as the four
    real products a coil row takes;
  - ``bytes``: ``torch.add`` of two bf16 tensors into a third, together as
    many bytes as the kernel's unique traffic (inputs read once, output
    written once).

    python3 tools/torch_k1_bf16_variants.py [--rounds N] [--only NAME ...] [--baseline FILE]

``--baseline`` adds another version of ``psf1d_dc.cu`` (for instance the
parent commit's, from ``git show``), built and timed as it is, so that two
versions are compared within one run.

Prints one JSON line per variant, operand set and round (ms, and the launch
setup: blocks, shared memory, blocks per SM), then the card's name and power
limit. Builds go to ``mridc_tpu_torch/_build/k1_bf16_variants/``.
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
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k1_bf16_variants"
C, H, W, SIGMA = 15, 320, 320, 0.7

_NARROW = ("Setup s = make<BWD, 4>(W);", "Setup s = make<BWD, 2>(W);")
_NO_MMA = ("for (int kk = 0; kk < TK; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {")
_NO_COPY = ("      if (i < iters) {\n        const bf16* s_c", "      if (false) {\n        const bf16* s_c")
_NO_CONVERT = ("      if (i + 1 < iters) convert(i + 1);", "      if (false) convert(i + 1);")

# name -> (substitutions, result is right)
VARIANTS = {
    "shipped: four products, 64 x 64 tiles, 2 stages": ([], True),
    "four products, 64 x 32 tiles": ([_NARROW], True),
    "3 stages": ([("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")], True),
    "timing only: no MMA": ([_NO_MMA], False),
    "timing only: no s_c copies in": ([_NO_COPY], False),
    "timing only: no conversion": ([_NO_CONVERT], False),
    "timing only: MMAs alone": ([_NO_COPY, _NO_CONVERT], False),
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
        regs = [ln.split("Used ")[1].split(",")[0] for ln in out.splitlines() if "Used" in ln and "registers" in ln]
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
        print("torch_k1_bf16_variants: no CUDA device", file=sys.stderr)
        return 2
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
    bf = torch.bfloat16
    rng = np.random.default_rng(0)

    def operands(b):
        sens = rng.standard_normal((b, C, H, W, 2)).astype(np.float32)
        sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
        mask = np.zeros((b, W), np.float32)
        mask[:, ::4] = 1.0
        mask[:, W // 2 - 16 : W // 2 + 16] = 1.0
        mats = psf1d_gauss_mats(torch.from_numpy(mask).to(dev), True, "ortho")
        eta, z0 = (rng.standard_normal((b, H, W, 2)).astype(np.float32) for _ in range(2))
        g = rng.standard_normal((b, H, W, 4)).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev, bf)  # noqa: E731
        return t(eta), t(sens), mats.to(bf), t(z0), t(g)

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
        return err, bool(torch.allclose(got, want, rtol=1e-2, atol=1e-2 * float(want.abs().max())))

    cases = {}
    for b, bwd in ((8, False), (24, False), (24, True)):
        eta, sens, mats, z0, g = operands(b)
        if bwd:
            want = psf1d_dc_bwd_plain(g.float(), sens.float(), mats.float(), SIGMA).to(bf)
            out = torch.empty((b, H, W, 2), dtype=bf, device=dev)
            ptrs = (g.data_ptr(), sens.data_ptr(), mats.data_ptr(), out.data_ptr())
        else:
            want = psf1d_dc_plain(eta.float(), sens.float(), mats.float(), z0.float(), SIGMA).to(bf)
            out = torch.empty((b, H, W, 4), dtype=bf, device=dev)
            ptrs = (eta.data_ptr(), sens.data_ptr(), mats.data_ptr(), z0.data_ptr(), out.data_ptr())
        # yardsticks: the real-embedded product on cuBLAS, and the unique bytes
        x = torch.randn(b, C * H, 2 * W, device=dev, dtype=bf)
        m = torch.randn(b, 2 * W, 2 * W, device=dev, dtype=bf)
        y = torch.empty(b, C * H, 2 * W, device=dev, dtype=bf)
        # eta and z0 (forward) or g (backward) in, sens and the 3 planes in, the output out
        nbytes = 2 * (b * H * W * 4 + b * C * H * W * 2 + b * 3 * W * W + b * H * W * (2 if bwd else 4))
        n = nbytes // 6
        p, q, r = (torch.empty(n, device=dev, dtype=bf).normal_() for _ in range(3))
        cases[f"{'bwd' if bwd else 'fwd'}_b{b}"] = dict(
            b=b, bwd=bwd, ptrs=ptrs, out=out, want=want, nbytes=nbytes, keep=(eta, sens, mats, z0, g),
            bmm=lambda x=x, m=m, y=y: torch.bmm(x, m, out=y), bytes=lambda p=p, q=q, r=r: torch.add(p, q, out=r))

    stream = torch.cuda.current_stream().cuda_stream
    for rnd in range(args.rounds):
        for key, cs in cases.items():
            for yard in ("bmm", "bytes"):
                print(json.dumps({"round": rnd, "case": key, "yardstick": yard, "ms": time_ms(cs[yard]),
                                  "bytes": cs["nbytes"]}), flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            setup = getattr(lib, "k1_psf1d_dc_bf16_setup", None)  # a baseline may not have it
            if setup is not None:
                setup.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            for key, cs in cases.items():
                b, bwd = cs["b"], cs["bwd"]
                fn = lib.k1_psf1d_dc_bwd_bf16 if bwd else lib.k1_psf1d_dc_bf16
                fn.argtypes = [ctypes.c_void_p] * len(cs["ptrs"]) + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                                          ctypes.c_void_p]
                info = (ctypes.c_int * 6)()
                if setup is not None:
                    setup(int(bwd), b, H, W, dev.index or 0, info)

                def call(fn=fn, cs=cs, b=b):
                    err = fn(*cs["ptrs"], b, C, H, W, 1.0 / SIGMA**2, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                rec = {"round": rnd, "variant": name, "case": key, "ms": time_ms(call),
                       "setup": dict(zip(("blocks", "smem_bytes", "blocks_per_sm", "threads", "tile_h", "tile_u"),
                                         list(info)))}
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
