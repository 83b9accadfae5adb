#!/usr/bin/env python3
"""Compare two versions of mridc_tpu_torch's K3-bf16 kernel (the IndRNN cell of
the flagship bf16 forward) on one NVIDIA GPU, within one run.

Builds ``mridc_tpu_torch/csrc/indrnn.cu`` as it stands and the other version
in ``--baseline DIR`` (a directory holding that version's ``indrnn.cu`` and
``common.cuh``, e.g. written with ``git show <rev>:mridc_tpu_torch/csrc/...``),
both with nvcc, started together. Each ``k3_indrnn_bf16`` is called through
ctypes at the operands of chip_smoke.py's phase 6 (B=8, 320x320 pixels,
64 -> 64 channels, bfloat16, channels_last; W, bias and u in float32 as the
kernel reads them), checked against the plain version in float32 on the same
bf16 operands, rounded once, at chip_smoke.py's K3_BF16 limit (rtol 1e-2,
atol 1e-3 x max), and timed with CUDA events in the order baseline, current,
current, baseline in every round. Beside them, timed the same way: the port's
wrapper ``kernels.indrnn`` (the call phase 6 times: it also casts W, bias and
u to float32 and allocates the output), and ``torch.add`` over the kernel's
bytes.

    python3 tools/torch_k3_bf16_ab.py --baseline DIR [--rounds N]

Prints one JSON line per timing, then the card's name and power limit. Builds
go to ``mridc_tpu_torch/_build/k3_bf16_ab/``.
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
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k3_bf16_ab"
B, H, W, C = 8, 320, 320, 64


def build(nvcc: str, sources: dict) -> dict:
    procs = {}
    for name, src in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("indrnn.cu", "common.cuh"):
            (d / f).write_text((src / f).read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "indrnn.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{out}")
        lines = [ln.strip() for ln in out.splitlines() if "indrnn_bf16" in ln or ("Used" in ln and "registers" in ln)]
        print(json.dumps({"version": name, "build": str(d), "ptxas": lines}), flush=True)
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="directory with the other version's indrnn.cu and common.cuh")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_bf16_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.kernels.binding import _nvcc

    libs = build(_nvcc(), {"baseline": Path(args.baseline), "current": CSRC})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    cl = lambda t: t.to(dev, bf).contiguous(memory_format=torch.channels_last)  # noqa: E731
    x, h = cl(torch.randn(B, C, H, W, generator=gen)), cl(torch.rand(B, C, H, W, generator=gen))
    w = (torch.randn(C, C, 1, 1, generator=gen) / C**0.5).to(dev, bf)
    bias, u = (0.1 * torch.randn(C, generator=gen)).to(dev, bf), torch.rand(1, C, 1, 1, generator=gen).to(dev, bf)
    w32, b32, u32 = (t.reshape(-1).float().contiguous() for t in (w, bias, u))
    out = torch.empty_like(h, memory_format=torch.channels_last)
    want = kernels.indrnn_plain(x.float(), h.float(), w.float(), bias.float(), u.float()).to(bf).float()
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

    def close(got):
        got = got.float()
        err = float((got - want).abs().max())
        return err, bool(torch.allclose(got, want, rtol=1e-2, atol=1e-3 * float(want.abs().max())))

    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).k3_indrnn_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name):
            err = fn(x.data_ptr(), h.data_ptr(), w32.data_ptr(), b32.data_ptr(), u32.data_ptr(), out.data_ptr(),
                     B * H * W, C, C, dev.index or 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        out.zero_()
        call()
        torch.cuda.synchronize()
        err, ok = close(out)
        print(json.dumps({"version": name, "max_abs_err": err, "ok": ok}), flush=True)
        if not ok:
            raise AssertionError(f"{name}: disagrees with the plain version (max abs err {err})")
        calls[name] = call
    got = kernels.indrnn(x, h, w, bias, u)
    err, ok = close(got)
    if not ok:
        raise AssertionError(f"kernels.indrnn: disagrees with the plain version (max abs err {err})")

    nbytes = 2 * 3 * B * H * W * C + 4 * (C * C + 2 * C)
    a, c = (torch.empty(nbytes // 6, device=dev, dtype=bf).normal_() for _ in range(2))
    r = torch.empty_like(a)
    for rnd in range(args.rounds):
        for name in ("baseline", "current", "current", "baseline"):
            print(json.dumps({"round": rnd, "version": name, "ms": time_ms(calls[name])}), flush=True)
        print(json.dumps({"round": rnd, "version": "kernels.indrnn (wrapper, current)",
                          "ms": time_ms(lambda: kernels.indrnn(x, h, w, bias, u))}), flush=True)
        print(json.dumps({"round": rnd, "version": "torch.add over the same bytes", "bytes": nbytes,
                          "ms": time_ms(lambda: torch.add(a, c, out=r))}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
