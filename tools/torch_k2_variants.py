#!/usr/bin/env python3
"""Time design variants of mridc_tpu_torch's K2 expand, load and mask kernels
on one NVIDIA GPU, alone and in the chains that call them.

Each variant is ``mridc_tpu_torch/csrc/full_dc.cu`` with a few text
substitutions (defined below): coils a thread, loads in flight, cache hints,
block shape, and a grid-stride loop over one wave of blocks in place of the 3D
grid. All variants are built with nvcc into their own libraries, started
together, and timed at phase 6's operands of chip_smoke.py: B=8, 15 coils,
320x320, bench.py's k-space, maps and 1D mask (``chip_smoke.bench_data``) and a
seeded eta, float32. Cases: ``expand`` and ``load`` with the mask, centered
(the shifts of phase 6) and at sh = 0, ``load`` without a mask with the
fftshift (the k-space reorder), ``mask`` in place on an FFT output (centered
and at sh = 0), and expand, load and mask centered at B=1 (the configs' batch;
~5 us a call, L2-resident, so the device time of a profiler trace is read
beside the CUDA events, which there hold the host's launch time too; the mask
cases read it at B=8 too). Every variant is checked against the plain version
at chip_smoke.py's F32 limits (rtol 1e-4, atol 1e-4 x max), and mask exactly.
Beside them, the yardsticks that the port never calls: ``torch.mul`` of the
complex maps by eta (expand) and of the complex k-space by the mask (load,
mask), as phase 6 times them, the in-place ``mul_`` by the mask (mask), and
``clone`` of the coil tensor for the copy. Each round times every variant in
turns (the order, then the order reversed), so that drift shows as a
difference between the two readings.

Then the chains (``CHAIN_VARIANTS`` and the baseline): each of those builds is
put in place of the package's ``full_dc`` library and the package's own
``sens_expand`` (without and with the mask), ``sens_reduce``, ``normal_op``,
``full_dc`` and ``full_dc_bwd`` run centered at B=1 and B=8, in turns, with
CUDA events and with the summed device time of every kernel of a call in a
profiler trace: what a kernel's cache hints cost the FFTs and reduces that
read its output or its operands after it.

    python3 tools/torch_k2_variants.py [--rounds N] [--baseline FILE] [--cases PREFIX ...]

``--cases`` keeps the cases whose name starts with one of the prefixes (for
instance ``mask``), and the chains that run one of their stages.

``--baseline`` adds another version of ``full_dc.cu`` with the same C
interface (for instance the parent commit's, from ``git show``), built and
timed as it is. Last, the package's own wrappers (``kernels.k2_full_dc.expand``
/ ``load``) are timed with CUDA events over 20 calls, as phase 6 times them,
beside the kernels' device time in a torch.profiler trace of 20 calls, and the
host time of a wrapper call and of its parts.

Prints one JSON line per variant, case and reading, then the card's name and
power limit. Builds go to ``mridc_tpu_torch/_build/k2_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "mridc_tpu_torch" / "csrc"
OUT = ROOT / "mridc_tpu_torch" / "_build" / "k2_variants"
B, C, H, W = 8, 15, 320, 320
HBM = 3.35e12  # bytes/s, the H100 SXM's published rate

_COILS = "constexpr int COILS_PER_THREAD = 3;"
_UNROLL = "constexpr int UNROLL = 3;"


def _coils(n: int, unroll: int) -> list:
    return [(_COILS, f"constexpr int COILS_PER_THREAD = {n};"), (_UNROLL, f"constexpr int UNROLL = {unroll};")]


# the grid-stride form: a 1D grid of one wave of blocks (SMs x 2048 threads),
# each thread walking the units t, t + grid size, ... in row order
_UNIT_AT = """// grid: (ceil(W / TX), ceil(H / TY), B * groups)"""
_UNIT_AT_NEW = """__device__ __forceinline__ bool unit_at(long long t, int B, int H, int W, int groups, Unit* u) {
  if (t >= (long long)B * groups * H * W) return false;
  u->j = (int)(t % W);
  const long long r = t / W;
  u->i = (int)(r % H);
  const int z = (int)(r / H);
  u->b = z / groups;
  u->c0 = (z - u->b * groups) * COILS_PER_THREAD;
  return true;
}

""" + _UNIT_AT
_GRID_STRIDE = [
    (_UNIT_AT, _UNIT_AT_NEW),
    ("  if (unit_of(H, W, groups, &u))",
     "  for (long long t = (long long)blockIdx.x * TX * TY + threadIdx.y * TX + threadIdx.x;\n"
     "       unit_at(t, B, H, W, groups, &u); t += (long long)gridDim.x * TX * TY)"),
    ("int groups) {", "int groups, int B) {"),
    ("groups);\n", "groups, B);\n"),
    ("  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)gz);",
     "  int dev = 0, sms = 0;\n  cudaGetDevice(&dev);\n"
     "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
     "  const long long wave = (long long)sms * (2048 / (TX * TY)), all = gx * gy * gz;\n"
     "  *grid = dim3((unsigned)(all < wave ? all : wave));"),
]

# streaming loads and stores of the coil tensors (ld/st.global.cs: evict first)
_HINTS = [
    ("v[u] = in[(size_t)(c + u) * HW];", "v[u] = __ldcs(in + (size_t)(c + u) * HW);"),
    ("out[(size_t)(c + u) * HW] = op(v[u]);", "__stcs(out + (size_t)(c + u) * HW, op(v[u]));"),
]
# the same on the mask stage's in-place run alone
_HINTS_IN_PLACE = [
    ("v[u] = io[(size_t)(c + u) * HW];", "v[u] = __ldcs(io + (size_t)(c + u) * HW);"),
    ("io[(size_t)(c + u) * HW] = op(v[u]);", "__stcs(io + (size_t)(c + u) * HW, op(v[u]));"),
]

SHIPPED = "shipped: 1 pixel, 3 coils a thread (5 groups), 3 loads ahead, 32x8 blocks"
# name -> substitutions
VARIANTS = {
    SHIPPED: [],
    "streaming cache hints on the coil tensors": _HINTS + _HINTS_IN_PLACE,
    "streaming cache hints on the mask stage alone": _HINTS_IN_PLACE,
    "15 coils a thread (1 group), 5 loads ahead": _coils(15, 5),
    "5 coils a thread (3 groups), 5 loads ahead": _coils(5, 5),
    "1 coil a thread (15 groups: the first version's grid shape)": _coils(1, 1),
    "1 load ahead (3 coils a thread)": [(_UNROLL, "constexpr int UNROLL = 1;")],
    "64x4 blocks": [("constexpr int TX = 32, TY = 8;", "constexpr int TX = 64, TY = 4;")],
    "grid-stride over one wave, 3 coils a unit": _GRID_STRIDE,
    "grid-stride over one wave, 15 coils a unit": _GRID_STRIDE + _coils(15, 5),
}
# the builds also timed in the package's chains (with the baseline)
CHAIN_VARIANTS = (SHIPPED, "streaming cache hints on the coil tensors", "streaming cache hints on the mask stage alone")


def variant_source(src: str, name: str) -> str:
    """``src`` with variant ``name``'s substitutions; raises where the source
    no longer holds one."""
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(nvcc: str, names, argtypes: dict, baseline=None) -> dict:
    """{name: loaded library} of the variants that built, every entry point's
    argtypes set from ``argtypes`` ({symbol: ctypes argument types})."""
    src = (CSRC / "full_dc.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        s = Path(baseline).read_text() if name == "baseline" else variant_source(src, name)
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "full_dc.cu").write_text(s)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "full_dc.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            if name in ("baseline", SHIPPED):
                raise RuntimeError(f"variant {name!r} did not build:\n{out}")
            print(json.dumps({"variant": name, "build_failed": out[-2000:]}), flush=True)
            continue
        regs, kern = {}, None
        for ln in out.splitlines():
            m = re.search(r"(expand|load|mask)_kernel", ln)
            if "Compiling entry function" in ln:
                kern = m.group(1) if m else None
            elif "Used" in ln and "registers" in ln and kern:
                regs[kern] = ln.split("Used ")[1].split(",")[0]
        print(json.dumps({"variant": name, "build": str(d), "registers": regs}), flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for sym, types in argtypes.items():
            fn = getattr(lib, sym)
            fn.argtypes = [*types, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mridc_error_string.argtypes = [ctypes.c_int]
        lib.mridc_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", default=None, help="another full_dc.cu to build and time as it is")
    ap.add_argument("--cases", nargs="*", default=None, help="keep the cases whose name starts with one of these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bench_data
    from mridc_tpu_torch.kernels import binding
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.kernels.common import check_operand, device_of

    names = list(VARIANTS)
    if args.baseline:
        names.insert(0, "baseline")
    libs = build(binding._nvcc(), names, binding.SOURCES["full_dc"], args.baseline)
    names = [n for n in names if n in libs]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn, iters=50):
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

    def traced_ms(fn, calls=50):
        """Mean device time a call: every kernel of ``calls`` calls in a trace;
        None when the trace lost kernel events (the profiler at times drops
        some: their count is then no multiple of ``calls``)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return sum(us) / calls / 1e3 if us and len(us) % calls == 0 else None

    def operands(b):
        y, sens, mask = (torch.from_numpy(a).to(dev) for a in bench_data(b, C, H, W))
        rng = np.random.default_rng(5)
        eta = torch.from_numpy(rng.standard_normal((b, H, W, 2)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((b, H, W, 4)).astype(np.float32)).to(dev)
        # the mask stage's operand: an FFT output, and the buffer it works on in place
        kspace = torch.fft.fft2(k2.expand_plain(eta, sens, True), norm="ortho")
        return dict(b=b, y=y, sens=sens, mask=mask, eta=eta, g=g, k=kspace, kw=kspace.clone(),
                    out=torch.empty((b, C, H, W), dtype=torch.complex64, device=dev),
                    **{f"{k}_cx": torch.view_as_complex(v) for k, v in (("y", y), ("sens", sens), ("eta", eta))})

    ops = {8: operands(8), 1: operands(1)}
    # case -> (batch, kernel, centered, fftshift, masked, plain version, {yardstick: call}, bytes moved once);
    # B=1 is the configs' batch: each call is ~5 us, so the trace's device time is read beside the events'
    cases = {}
    for b, tag in ((8, ""), (1, "/B=1")):
        o = ops[b]
        coil = b * C * H * W * 8
        mul_eta = {"torch.mul": lambda o=o: torch.mul(o["eta_cx"].unsqueeze(1), o["sens_cx"])}
        mul_y = {"torch.mul": lambda o=o: torch.mul(o["y_cx"], o["mask"])}
        # the mask stage's: the out-of-place product (phase 6's library call) and the in-place one
        mul_k = {"torch.mul": lambda o=o: torch.mul(o["kw"], o["mask"]), "mul_": lambda o=o: o["kw"].mul_(o["mask"])}
        cases.update({
            f"expand/centered{tag}": (b, "k2_expand", True, False, False,
                                      lambda o=o: k2.expand_plain(o["eta"], o["sens"], True), mul_eta,
                                      2 * coil + b * H * W * 8),
            f"load/centered{tag}": (b, "k2_load", True, False, True, lambda o=o: k2.load_plain(o["y"], o["mask"], True),
                                    mul_y, 2 * coil + b * H * W * 4),
            f"mask/centered{tag}": (b, "k2_mask", True, False, True,
                                    lambda o=o: k2.apply_mask_plain(o["k"], o["mask"], True), mul_k,
                                    2 * coil + b * H * W * 4),
        })
        if b == 8:
            cases.update({
                "expand/sh=0": (b, "k2_expand", False, False, False,
                                lambda o=o: k2.expand_plain(o["eta"], o["sens"], False), mul_eta,
                                2 * coil + b * H * W * 8),
                "load/sh=0": (b, "k2_load", False, False, True, lambda o=o: k2.load_plain(o["y"], o["mask"], False),
                              mul_y, 2 * coil + b * H * W * 4),
                "load/no mask, fftshift": (b, "k2_load", True, True, False,
                                           lambda o=o: k2.load_plain(o["y"], None, True, True),
                                           {"clone": lambda o=o: o["y_cx"].clone()}, 2 * coil),
                "mask/sh=0": (b, "k2_mask", False, False, True,
                              lambda o=o: k2.apply_mask_plain(o["k"], o["mask"], False), mul_k,
                              2 * coil + b * H * W * 4),
            })
    if args.cases is not None:
        cases = {k: v for k, v in cases.items() if k.startswith(tuple(args.cases))}

    def caller(name, case):
        b, sym, centered, fftshift, masked, *_ = cases[case]
        o = ops[b]
        fn = getattr(libs[name], sym)
        sh = k2._shifts(H, W, centered, fftshift)
        if sym == "k2_expand":
            argv = (o["eta"].data_ptr(), o["sens"].data_ptr(), o["out"].data_ptr(), b, C, H, W, *sh, 1)
        elif sym == "k2_mask":  # in place on kw
            argv = (o["kw"].data_ptr(), o["mask"].data_ptr(), b, C, H, W, *sh)
        else:
            argv = (o["y"].data_ptr(), o["mask"].data_ptr() if masked else None, o["out"].data_ptr(), b, C, H, W,
                    *sh)

        def call():
            err = fn(*argv, stream)
            if err:
                raise RuntimeError(f"{name} {case}: CUDA error {err}")

        return call

    for case, (b, sym, *_, plain, yard, nbytes) in cases.items():
        o = ops[b]
        want = torch.view_as_real(plain())
        in_place = sym == "k2_mask"
        out = torch.view_as_real(o["kw"] if in_place else o["out"])
        # the mask stage is one product of its plain version: exact
        rtol, atol = (0.0, 0.0) if in_place else (1e-4, 1e-4 * float(want.abs().max()))
        for name in names:
            call = caller(name, case)
            if in_place:
                o["kw"].copy_(o["k"])
            else:
                out.zero_()
            call()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if not torch.allclose(out, want, rtol=rtol, atol=atol):
                raise AssertionError(f"{name} {case}: disagrees with the plain version (max abs err {err})")
            print(json.dumps({"check": case, "variant": name, "max_abs_err": err, "ok": True}), flush=True)

    for rnd in range(args.rounds):
        for case, (b, sym, *_, yard, nbytes) in cases.items():
            order = [*yard, *names]
            reading = {}
            for name in order + order[::-1]:
                fn = yard[name] if name in yard else caller(name, case)
                rec = reading.setdefault(name, {"ms": [], "traced_ms": []})
                rec["ms"].append(time_ms(fn))
                if b == 1 or sym == "k2_mask":
                    rec["traced_ms"].append(traced_ms(fn))
            bound = nbytes / HBM * 1e3
            for name, rec in reading.items():
                best = min([t for t in rec["traced_ms"] if t is not None] or rec["ms"])
                print(json.dumps({"round": rnd, "case": case, "variant": name, **{k: v for k, v in rec.items() if v},
                                  "bound_ms": bound, "share_of_bound": bound / best}), flush=True)

    # the chains: each build of CHAIN_VARIANTS (and the baseline) in place of
    # the package's library, the package's SENSE functions, normal operator
    # and full DC on top; checked once against their plain versions at F32
    chain_names = [n for n in ("baseline", *CHAIN_VARIANTS) if n in libs]
    shipped_lib = binding.library("full_dc")

    def install(lib):
        binding._LIBS["full_dc"] = lib
        binding._ENTRIES.clear()

    def chains(o):
        """{chain: (call, plain version)} of the chains that run a kept case's stage"""
        x, g, m, sens = o["eta"], o["g"], o["mask"], o["sens"]
        mu = torch.tensor([0.05], device=dev)
        every = {  # chain: (stages it runs, call, plain version)
            "sens_expand": (("expand", "load"), lambda: k2.sens_expand(x, sens, True, "ortho"),
                            lambda: k2.sens_expand_plain(x, sens, True, "ortho")),
            "sens_expand masked": (("expand", "mask", "load"), lambda: k2.sens_expand(x, sens, True, "ortho", mask=m),
                                   lambda: k2.sens_expand_plain(x, sens, True, "ortho", mask=m)),
            "sens_reduce": (("load",), lambda: k2.sens_reduce(o["y"], sens, m, True, "ortho"),
                            lambda: k2.sens_reduce_plain(o["y"], sens, m, True, "ortho")),
            "normal_op": (("expand", "mask"), lambda: k2.normal_op(x, sens, m, mu, True, "ortho"),
                          lambda: k2.normal_op_plain(x, sens, m, mu, True, "ortho")),
            "full_dc": (("expand",), lambda: k2.full_dc(x, o["y"], sens, m, 1.0, True, "ortho"),
                        lambda: k2.full_dc_plain(x, o["y"], sens, m, 1.0, True, "ortho")),
            "full_dc_bwd": (("expand", "mask"), lambda: k2.full_dc_bwd(g, sens, m, 1.0, True, "ortho"),
                            lambda: k2.full_dc_bwd_plain(g, sens, m, 1.0, True, "ortho")),
        }
        kept = {case.split("/")[0] for case in cases}
        return {name: (fn, plain) for name, (stages, fn, plain) in every.items() if kept.intersection(stages)}

    with torch.inference_mode():
        for b in (1, 8):
            for chain, (fn, plain) in chains(ops[b]).items():
                want = plain()
                scale = float(want.abs().max())
                for name in chain_names:
                    install(libs[name])
                    got = fn()
                    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
                        raise AssertionError(f"{name} {chain} B={b}: disagrees with the plain version")
                print(json.dumps({"check": f"chain {chain} B={b}", "variants": chain_names, "ok": True}), flush=True)
        for rnd in range(args.rounds):
            for b in (1, 8):
                for chain, (fn, _) in chains(ops[b]).items():
                    reading = {}
                    for name in chain_names + chain_names[::-1]:
                        install(libs[name])
                        rec = reading.setdefault(name, {"ms": [], "traced_ms": []})
                        rec["ms"].append(time_ms(fn))
                        rec["traced_ms"].append(traced_ms(fn))
                    for name, rec in reading.items():
                        print(json.dumps({"round": rnd, "chain": chain, "batch": b, "variant": name, **rec}),
                              flush=True)
    install(shipped_lib)

    # the package's wrappers as phase 6 calls them (the shipped build, through
    # kernels.binding): CUDA events over 20 and 200 calls of each step of the
    # launch path, in turns, beside the kernel's device time in a trace of 20
    # calls; then the host time of a call and of its parts
    o = ops[8]
    eta, sens, y, mask, out = o["eta"], o["sens"], o["y"], o["mask"], o["out"]
    sh = k2._shifts(H, W, True)
    lib = binding.library("full_dc")
    argv = (eta.data_ptr(), sens.data_ptr(), out.data_ptr(), 8, C, H, W, *sh, 1)

    def raw_new_out():
        x = torch.empty((8, C, H, W), dtype=torch.complex64, device=dev)
        lib.k2_expand(eta.data_ptr(), sens.data_ptr(), x.data_ptr(), 8, C, H, W, *sh, 1, stream)
        return x

    steps = {
        "ctypes call, one output buffer": lambda: lib.k2_expand(*argv, stream),
        "ctypes call, torch.empty output each call": raw_new_out,
        "binding.launch, one output buffer": lambda: binding.launch("full_dc", "k2_expand", dev, *argv),
        "k2_full_dc.expand (the wrapper)": lambda: k2.expand(eta, sens, True),
        "torch.mul yardstick": lambda: torch.mul(o["eta_cx"].unsqueeze(1), o["sens_cx"]),
    }
    for rnd in range(args.rounds):
        reading = {}
        for label in [*steps, *reversed(steps)]:
            reading.setdefault(label, []).append([time_ms(steps[label], iters=20), time_ms(steps[label], iters=200)])
        for label, rs in reading.items():
            print(json.dumps({"round": rnd, "launch_path": label, "event_ms_20_200": rs}), flush=True)
    for label, fn in (("expand centered", lambda: k2.expand(eta, sens, True)),
                      ("expand sh=0", lambda: k2.expand(eta, sens, False)),
                      ("load centered", lambda: k2.load(y, mask, True)),
                      ("load sh=0", lambda: k2.load(y, mask, False)),
                      ("mask centered", lambda: k2.apply_mask(o["kw"], mask, True)),
                      ("mask sh=0", lambda: k2.apply_mask(o["kw"], mask, False))):
        print(json.dumps({"wrapper": label, "event_ms": time_ms(fn, iters=20), "traced_device_ms": traced_ms(fn, 20)}),
              flush=True)

    def host_us(fn, n=50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    def checks():
        device_of("full_dc.expand", eta, sens)
        b, c, h, w = k2._coil_dims("full_dc.expand", sens)
        check_operand("full_dc.expand.sens", sens, (b, c, h, w, 2), (torch.float32,), align=8)
        k2._eta_stride(eta, b, h, w)
        k2._shifts(h, w, True)

    def ctx():
        with torch.cuda.device(dev):
            pass

    parts = {
        "expand wrapper, whole": lambda: k2.expand(eta, sens, True),
        "argument checks and shifts": checks,
        "torch.empty of the output": lambda: torch.empty((8, C, H, W), dtype=torch.complex64, device=dev),
        "sens.new_empty of the output": lambda: sens.new_empty((8, C, H, W), dtype=torch.complex64),
        "binding.launch": lambda: binding.launch("full_dc", "k2_expand", dev, *argv),
        "with torch.cuda.device (a device guard)": ctx,
        "torch.cuda.current_stream().cuda_stream (a Stream object)": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "the ctypes call alone": lambda: lib.k2_expand(*argv, ctypes.c_void_p(stream)),
        "torch.mul yardstick": lambda: torch.mul(o["eta_cx"].unsqueeze(1), o["sens_cx"]),
    }
    for label, fn in parts.items():
        print(json.dumps({"host_us_a_call": label, "us": [host_us(fn) for _ in range(3)]}), flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
