#!/usr/bin/env python3
"""Drive mridc_tpu_torch's main path on one NVIDIA H100 and hold every
hand-written kernel against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises; no phase catches its own):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build the kernels of ``mridc_tpu_torch/csrc`` (one nvcc per source, in parallel);
  3. each kernel against its plain version on the card, at the flagship shapes
     (B=2, 15 coils, 320x320, 64 filters) and at an odd size; K3-f32 also at
     64 -> 128 and 128 -> 128 channels, at in-channels that are not a multiple
     of 8, and over a pixel count that no tile divides;
  4. a small CIRIM (15 coils, 64x64, 2 cascades x 3 steps, 64 filters) on the
     card against the same weights on the CPU, in both dc_modes;
  5. the main path: flagship CIRIM inference (bench.py's flagship_cfg: 5 x 8,
     IndRNN, 64 filters, centered ortho FFT, psf1d, bf16 compute) serving
     requests of B=8 (2 warm-up, 5 timed), then the same weights in f32 psf1d
     and f32 full; launch counters are zeroed before and read after; the three
     predictions must agree, and one K3 call's operands are kept;
  6. each kernel against its plain version again on the main path's operands
     (B=8: the f32 prediction as eta, the captured K3 call), then its time
     beside its bound and its plain version's time.

Output: JSON lines per check, run and kernel; then the ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
COILS, H, W = 15, 320, 320
CASCADES, TIME_STEPS, FILTERS = 5, 8, 64
BATCH, WARMUP, ITERS = 8, 2, 5
DEVICE = "cuda"

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# flop/s by route: float32 on the CUDA cores; products at float32 accuracy on
# the tensor cores as 3xTF32 (three TF32 MMAs per product, 495/3 TFLOP/s: the
# card's fastest route at that accuracy); bfloat16 products on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float32_products": 495e12 / 3, "bfloat16_products": 989e12}
PRODUCTS = {"float32": "float32_products", "bfloat16": "bfloat16_products"}

# the main path's recurrent gain (see jax_layout_tree)
MAIN_GAIN = 0.3

# launches per flagship forward (5 cascades x 8 steps): K1 once and K3 twice
# per step; K2's reduce and load once for the SENSE init and once per cascade
# for the psf1d data term z0, or (full) expand/residual/reduce once per step
PER_FORWARD = {
    "bf16_psf1d": {"k1_psf1d_dc_bf16": 40, "k3_indrnn_bf16": 80, "k2_load": 6, "k2_reduce": 6},
    "f32_psf1d": {"k1_psf1d_dc_f32": 40, "k3_indrnn_f32": 80, "k2_load": 6, "k2_reduce": 6},
    "f32_full": {"k2_expand": 40, "k2_residual": 40, "k2_reduce": 41, "k2_load": 1, "k3_indrnn_f32": 80},
}

def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def flagship_cfg(**overrides):
    """bench.py's flagship_cfg (the JAX bench's main path), as a plain dict."""
    cfg = {
        "model_name": "CIRIM",
        "num_cascades": CASCADES,
        "time_steps": TIME_STEPS,
        "recurrent_layer": "IndRNN",
        "conv_filters": [FILTERS, FILTERS, 2],
        "conv_kernels": [5, 3, 3],
        "conv_dilations": [1, 2, 1],
        "recurrent_filters": [FILTERS, FILTERS, 0],
        "recurrent_kernels": [1, 1, 0],
        "recurrent_dilations": [1, 1, 0],
        "fft_centered": True,
        "fft_normalization": "ortho",
        "compute_dtype": "bfloat16",
        "dc_mode": "psf1d",
    }
    cfg.update(overrides)
    return cfg


def bench_data(batch, coils=COILS, h=H, w=W, seed=0):
    """bench.py's _data recipe: seed 0, unit-RSS sensitivities, a 1D mask with
    every 4th column plus 32 centre columns. Real views, float32."""
    rng = np.random.default_rng(seed)
    shape = (batch, coils, h, w)
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = np.zeros((batch, 1, h, w), np.float32)
    mask[..., ::4] = 1.0
    mask[..., w // 2 - 16 : w // 2 + 16] = 1.0
    rv = lambda z: np.stack([z.real, z.imag], axis=-1).astype(np.float32)  # noqa: E731
    return rv(y), rv(sens), mask


def jax_layout_tree(cfg, seed, gain=None):
    """Random CIRIM weights drawn with numpy in the flax tree layout of
    mridc_tpu (leading cascade axis). The default scales follow the flax
    initialisers (kaiming normal convs, IndRNN normal(1/(F(1+k^2)))), under
    which the network barely moves the SENSE init. A ``gain`` draws the
    recurrent weights larger, ih normal(gain/sqrt(F)) and hh uniform(0, gain/2),
    so that the hidden path moves the estimate well away from it: gain 1 for a
    few steps; gain 0.3 keeps 5 x 8 steps bounded, where larger gains let the
    estimate grow step after step."""
    rng = np.random.default_rng(seed)
    n = cfg["num_cascades"]

    def normal(shape, std):
        return (rng.standard_normal((n, *shape)) * std).astype(np.float32)

    step, cin = {}, 4
    for i, (cf, ck, rf) in enumerate(zip(cfg["conv_filters"], cfg["conv_kernels"], cfg["recurrent_filters"])):
        conv = {"kernel": normal((ck, ck, cin, cf), np.sqrt(2.0 / (ck * ck * cin)))}
        if rf:
            conv["bias"] = normal((cf,), 0.01)
            std = 1.0 / (rf * 2) if gain is None else gain * np.sqrt(1.0 / cf)
            hh = normal((1, 1, 1, rf), 1.0 / (rf * 2)) if gain is None else rng.uniform(0.0, gain / 2, (n, 1, 1, 1, rf))
            step[f"IndRNNCell_{i}"] = {
                "Conv_0": {"kernel": normal((1, 1, cf, rf), std), "bias": normal((rf,), 0.01)},
                "hh": np.asarray(hh, np.float32),
            }
            cin = rf
        step[f"ConvNonlinear_{i}"] = {"Conv_0": conv}
    return {"params": {"ScanCheckpoint_Cascade_0": {"RIMBlock_0": {"ScanCheckpoint_RIMStep_0": step}}}}


def check(name, got, want, rtol, atol_rel, note=""):
    """allclose(got, want, rtol, atol = atol_rel * max|want|) on finite values."""
    import torch

    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=rtol, atol=atol_rel * scale)
    rec = {"check": name, "max_abs_err": err, "max_abs_ref": scale, "rtol": rtol, "atol": atol_rel * scale,
           "ok": ok}
    if note:
        rec["note"] = note
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree: {rec}")
    return err


def rounded_once(plain, *args):
    """``plain`` computed in float32 on the given (already rounded) operands and
    rounded once, at the end, to their dtype: a bf16 kernel's oracle, and for
    float32 operands the plain version itself."""
    import torch

    real = [torch.is_tensor(a) and a.is_floating_point() for a in args]
    out = plain(*(a.float() if r else a for a, r in zip(args, real)))
    return out.to(args[real.index(True)].dtype) if out.is_floating_point() else out


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """Least time the card could take: the larger of bytes over the HBM rate
    and operations over the peak rate of their route (``flops`` is
    {route: operations}; the routes run side by side). Returns (ms, by)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(f / PEAK_FLOPS[route] for route, f in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_category(name: str) -> str:
    """Which layer a CUDA kernel of the forward belongs to, by its name."""
    n = name.lower()
    if "psf1d_dc" in n:
        return "K1 psf1d_dc"
    if "indrnn" in n:
        return "K3 indrnn"
    if "anonymous namespace" in n and any(k in n for k in ("expand_kernel", "residual_kernel", "load_kernel",
                                                            "reduce_kernel")):
        return "K2 stages"
    if "fft" in n:
        return "cuFFT"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "sm90", "cutlass", "nhwc", "nchw")):
        return "conv and GEMM (cuDNN, cuBLAS)"
    return "elementwise: pad, cast, add, copy"


def trace_forward(model, args, ms_per_forward):
    """Device time of one forward by kernel and by layer, from torch.profiler's
    CUDA kernel events (CUPTI), beside the unprofiled time of a forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(*args)
            torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    by_cat: dict = {}
    for name, ms in by_name.items():
        by_cat[kernel_category(name)] = by_cat.get(kernel_category(name), 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": busy, "ms_per_forward": ms_per_forward,
            "device_busy_share": busy / ms_per_forward if ms_per_forward else None,
            "by_layer_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[name[:120], ms] for name, ms in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.kernels import binding
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.kernels.k1_psf1d_dc import SYMBOLS as K1
    from mridc_tpu_torch.kernels.k3_indrnn import SYMBOLS as K3
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.nn.dc import psf1d_gauss_mats
    from mridc_tpu_torch.nn.rnn_cells import IndRNNCell
    from mridc_tpu_torch.utils.params import cirim_params_from_jax

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0].strip()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    # 2. build
    t0 = time.perf_counter()
    per_lib = kernels.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in binding.SOURCES:
        log = binding.BUILD_DIR / f"{name}.log"
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "per_library_s": per_lib, "ptxas": ptxas})

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape, dtype=torch.float32, positive=False):
        x = torch.rand(shape, generator=gen) if positive else torch.randn(shape, generator=gen)
        return x.to(dev, dtype)

    def cl(x):
        return x.contiguous(memory_format=torch.channels_last)

    errors = {}

    # 3. kernels against their plain versions on the card
    with torch.inference_mode():
        # float32: the kernel and cuBLAS/cuDNN in full float32 accumulate in
        # other orders; rtol 1e-4 with atol 1e-4 of the largest magnitude.
        # bfloat16: each kernel is held against its plain version computed in
        # float32 on the same bf16 operands and rounded once at the end
        # (rounded_once). K3 differs from that by the float32 summation order
        # and the final rounding only, at most one bf16 ulp (2^-7 relative):
        # rtol 1e-2, atol 1e-3 of the largest magnitude. K1 also rounds s_c*eta
        # and Ci to bf16 where it stages them (unit roundoff 2^-9 on each of
        # the C*W terms of an output's sum): rtol 1e-2, atol 1e-2 of the
        # largest magnitude. Readings on an H100 80GB HBM3 that these limits
        # were set from, max abs error at the largest magnitude: K1 0.031 at
        # 7.09 (flagship, B=2) and 0.016 at 7.44 (main path, B=8); K3 0.016 at
        # 6.72 and 0.0039 at 1.82 (one bf16 ulp at each).
        F32, K1_BF16, K3_BF16 = (1e-4, 1e-4), (1e-2, 1e-2), (1e-2, 1e-3)
        for label, (b, c, h, w) in {"flagship_b2": (2, COILS, H, W), "odd": (2, 3, 37, 45)}.items():
            y, sens, mask = (t(a) for a in bench_data(b, c, h, w, seed=3))
            if label == "odd":
                mask = (rand(b, 1, 1, w, positive=True) < 0.4).float().expand(b, 1, h, w).contiguous()
            eta = rand(b, h, w, 2)
            modes = [(True, "ortho")] if label != "odd" else [(True, "ortho"), (False, "backward"), (True, "forward")]
            for centered, norm in modes:
                tag = f"{label}/{'c' if centered else 'u'}-{norm}"
                x_plain = k2.expand_plain(eta, sens, centered)
                errors.setdefault("k2_expand", []).append(
                    check(f"k2_expand[{tag}]", torch.view_as_real(k2.expand(eta, sens, centered)),
                          torch.view_as_real(x_plain), *F32))
                kk = torch.fft.fft2(x_plain, norm=norm)
                errors.setdefault("k2_residual", []).append(
                    check(f"k2_residual[{tag}]", torch.view_as_real(k2.residual(kk.clone(), y, mask, centered)),
                          torch.view_as_real(k2.residual_plain(kk, y, mask, centered)), *F32))
                for m in (mask, None):
                    errors.setdefault("k2_load", []).append(
                        check(f"k2_load[{tag}{'' if m is None else '/mask'}]",
                              torch.view_as_real(k2.load(y, m, centered)),
                              torch.view_as_real(k2.load_plain(y, m, centered)), *F32))
                pp = torch.fft.ifft2(kk, norm=norm)
                for e in (eta, None):
                    errors.setdefault("k2_reduce", []).append(
                        check(f"k2_reduce[{tag}{'' if e is None else '/eta'}]", k2.reduce(pp, sens, e, centered, 0.7),
                              k2.reduce_plain(pp, sens, e, centered, 0.7), *F32))
                check(f"full_dc[{tag}]", k2.full_dc(eta, y, sens, mask, 0.7, centered, norm),
                      k2.full_dc_plain(eta, y, sens, mask, 0.7, centered, norm), *F32)
                check(f"sens_reduce[{tag}]", k2.sens_reduce(y, sens, mask, centered, norm),
                      k2.sens_reduce_plain(y, sens, mask, centered, norm), *F32)

            mats = psf1d_gauss_mats(mask[:, 0, 0, :], True, "ortho")
            z0 = k2.sens_reduce_plain(y, sens, mask, True, "ortho")
            for dt, tol in ((torch.float32, F32), (torch.bfloat16, K1_BF16)):
                args = [a.to(dt) for a in (eta, sens, mats, z0)]
                sym = K1[dt]
                errors.setdefault(sym, []).append(check(
                    f"{sym}[{label}]", kernels.psf1d_dc(*args, 0.7),
                    rounded_once(kernels.psf1d_dc_plain, *args, 0.7), *tol))

            ci, fo = (FILTERS, FILTERS) if label != "odd" else (32, 24)  # odd: 3 n-tiles, a ragged pixel tile
            x, hprev = cl(rand(b, ci, h, w)), cl(rand(b, fo, h, w, positive=True))
            wt, bias, hh = rand(fo, ci, 1, 1) / np.sqrt(ci), rand(fo) * 0.1, rand(1, fo, 1, 1, positive=True)
            for dt, tol in ((torch.float32, F32), (torch.bfloat16, K3_BF16)):
                sym = K3[dt]
                args = [a.to(dt) for a in (x, hprev, wt, bias, hh)]
                errors.setdefault(sym, []).append(
                    check(f"{sym}[{label}]", kernels.indrnn(*args), rounded_once(kernels.indrnn_plain, *args), *tol))

        # K3-f32 at the other widths projects/ uses (64 -> 128, 128 -> 128: the
        # latter takes a narrower pixel tile to fit shared memory), at
        # in-channels that are not a multiple of 8 (36: 16-byte copies and a
        # zero-padded k step; 6: 4-byte copies, and 12 out-channels, a
        # zero-padded n tile, without bias), over 2 x 33 x 35 pixels, a count
        # that no pixel tile divides
        sym = K3[torch.float32]
        for ci, fo, use_bias in ((64, 128, True), (128, 128, True), (36, 64, True), (6, 12, False)):
            x, hprev = cl(rand(2, ci, 33, 35)), cl(rand(2, fo, 33, 35, positive=True))
            wt, hh = rand(fo, ci, 1, 1) / np.sqrt(ci), rand(1, fo, 1, 1, positive=True)
            args = (x, hprev, wt, rand(fo) * 0.1 if use_bias else None, hh)
            errors[sym].append(check(f"{sym}[{ci}->{fo}/2x33x35{'' if use_bias else '/no_bias'}]",
                                     kernels.indrnn(*args), kernels.indrnn_plain(*args), *F32))
        torch.cuda.synchronize()

    # 4. small model: kernels on the card against the plain path on the CPU
    small = flagship_cfg(num_cascades=2, time_steps=3, compute_dtype=None)
    state_small = cirim_params_from_jax(jax_layout_tree(small, seed=11, gain=1.0))
    ys, ss, ms = bench_data(2, COILS, 64, 64, seed=5)
    for mode in ("psf1d", "full"):
        cfg = dict(small, dc_mode=mode)
        outs = {}
        for where in (DEVICE, "cpu"):
            model = build_model(cfg, device=where)
            model.load_state_dict(state_small)
            with torch.inference_mode():
                out = model(*(torch.from_numpy(a).to(where) for a in (ys, ss, ms)))
            outs[where] = (out.prediction.cpu(), out.intermediates.cpu())
        sense0 = k2.sens_reduce_plain(*(torch.from_numpy(a) for a in (ys, ss)), None, True, "ortho")
        moved = float((outs["cpu"][0] - sense0).norm() / sense0.norm())
        check(f"cirim_small[{mode}]", outs[DEVICE][0], outs["cpu"][0], 2e-3, 2e-4 / float(outs["cpu"][0].abs().max()),
              note=f"rel l2 of the prediction from the SENSE init: {moved:.3g}")
        check(f"cirim_small_intermediates[{mode}]", outs[DEVICE][1], outs["cpu"][1], 2e-3,
              2e-4 / float(outs["cpu"][1].abs().max()))

    # 5. the main path: flagship CIRIM inference at B=8, with recurrent weights
    # that move the prediction from the SENSE init (MAIN_GAIN), so that the
    # agreement limits below see what the DC kernels and the cells compute
    state = cirim_params_from_jax(jax_layout_tree(flagship_cfg(), seed=0, gain=MAIN_GAIN))
    y, sens, mask = (t(a) for a in bench_data(BATCH, COILS, H, W))
    runs = {
        "bf16_psf1d": flagship_cfg(stack_intermediates=False),
        "f32_psf1d": flagship_cfg(stack_intermediates=False, compute_dtype=None),
        "f32_full": flagship_cfg(stack_intermediates=False, compute_dtype=None, dc_mode="full"),
    }
    models, run_recs = {}, []
    for name, cfg in runs.items():
        models[name] = build_model(cfg, device=dev)
        models[name].load_state_dict(state)
    preds = {}
    kernels.reset_launch_counts()
    for name, model in models.items():
        before = kernels.launch_counts()
        with torch.inference_mode():
            for _ in range(WARMUP):
                model(y, sens, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                pred = model(y, sens, mask).prediction
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {k: v * (WARMUP + ITERS) for k, v in PER_FORWARD[name].items()}
        rec = {"run": name, "batch": BATCH, "forwards_timed": ITERS, "seconds": dt,
               "slices_per_s": ITERS * BATCH / dt, "ms_per_forward": dt / ITERS * 1e3,
               "launches_per_forward": {k: v / (WARMUP + ITERS) for k, v in delta.items()}, "card": card}
        run_recs.append(rec)
        emit(rec)
        if delta != want:
            raise AssertionError(f"{name}: launches {delta} != expected {want}")
        if not bool(torch.isfinite(pred).all()) or tuple(pred.shape) != (BATCH, H, W, 2):
            raise AssertionError(f"{name}: prediction not finite or of shape {tuple(pred.shape)}")
        preds[name] = pred.float()
    main_counts = kernels.launch_counts()
    missing = [k for k in binding.LAUNCHES if main_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    ref = preds["f32_psf1d"]
    # bf16: 8 significant bits through 40 steps, 4.7e-3 read on an H100;
    # full: the same function as psf1d in float32 (cuFFT against the 3xTF32
    # [W, W] product), 6.8e-7 read on an H100
    limits = {"bf16_psf1d": 1e-2, "f32_full": 1e-5}
    rel = {k: float((preds[k] - ref).norm() / ref.norm()) for k in limits}
    sense0 = kernels.sens_reduce(y, sens, None, True, "ortho")
    moved = float((ref - sense0).norm() / sense0.norm())
    rec = {"check": "flagship_agreement", "rel_l2_bf16_psf1d_vs_f32_psf1d": rel["bf16_psf1d"],
           "rel_l2_f32_full_vs_f32_psf1d": rel["f32_full"], "rel_l2_f32_psf1d_vs_sense_init": moved,
           "max_abs_f32_psf1d": float(ref.abs().max()), "gain": MAIN_GAIN, "limits": limits}
    emit(rec)
    if not all(rel[k] < limits[k] for k in limits):
        raise AssertionError(f"flagship predictions disagree: {rec}")

    # the operands of one K3 call of the main path (cascade 0, first cell, last
    # step), from one more forward of each psf1d run after the counters were read
    k3_args = {}
    for name in ("bf16_psf1d", "f32_psf1d"):
        cell = next(m for m in models[name].modules() if isinstance(m, IndRNNCell))
        hook = cell.register_forward_hook(lambda mod, inp, out: k3_args.__setitem__(out.dtype, mod.kernel_args(*inp)))
        with torch.inference_mode():
            models[name](y, sens, mask)
        hook.remove()

    # 5b. where a forward's device time goes (one traced forward per run,
    # after the counters were read)
    for run in run_recs:
        rec = trace_forward(models[run["run"]], (y, sens, mask), run["ms_per_forward"])
        emit({"trace": run["run"], **rec, "card": card})
    del models, preds

    # 6. each kernel against its plain version on the main path's operands
    # (B=8), then its time beside its bound
    b, c, hw = BATCH, COILS, H * W
    eta = ref.contiguous()
    mats = psf1d_gauss_mats(mask[:, 0, 0, :], True, "ortho")
    z0 = kernels.sens_reduce(y, sens, mask, True, "ortho")
    rows = []

    def row(sym, source, replaces, fn, plain, args, nbytes, flops, tol):
        # the oracle first: k2_residual overwrites its first operand
        want = rounded_once(plain, *args)
        errors.setdefault(sym, []).append(check(f"{sym}[main_b8]", fn(*args), want, *tol))
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(lambda: plain(*args))
        bound_ms, by = bound(nbytes, flops)
        rows.append({"name": sym, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": main_counts.get(sym, 0), "max_abs_err": max(errors[sym]), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
        emit({"kernel": sym, "shape": tuple(args[0].shape), "dtype": str(args[0].dtype), "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes, "flops": flops,
              "launches_per_forward": {r: PER_FORWARD[r].get(sym, 0) for r in PER_FORWARD}, "card": card})

    with torch.inference_mode():
        for dt, dname, es, tol in ((torch.float32, "float32", 4, F32), (torch.bfloat16, "bfloat16", 2, K1_BF16)):
            args = [a.to(dt) for a in (eta, sens, mats, z0)]
            # bytes: eta, sens, the 3 Gauss matrices, z0 in; [B, H, W, 4] out.
            # flops: the complex [W, W] product per coil row in the Gauss form of
            # psf1d_gauss_mats (three real products: 6 per complex MAC), on the
            # tensor cores; on the CUDA cores, per element and coil, the coil
            # expand (6), the Gauss pre-add (1) and recombination (2) and the
            # conj-multiply-accumulate (8), and per output element z0 and 1/sigma^2 (4)
            nbytes = es * (b * hw * 2 + b * c * hw * 2 + b * 3 * W * W + b * hw * 2 + b * hw * 4)
            flops = {PRODUCTS[dname]: 6 * b * c * H * W * W, "float32": 17 * b * c * hw + 4 * b * hw}
            row(K1[dt], "mridc_tpu_torch/csrc/psf1d_dc.cu", "mridc_tpu/nn/dc.py:162 (log_likelihood_gradient_psf1d)",
                kernels.psf1d_dc, kernels.psf1d_dc_plain, args, nbytes, flops, tol)

        x_c = k2.expand(eta, sens, True)
        k_c = torch.fft.fft2(x_c, norm="ortho")
        p_c = torch.fft.ifft2(k_c, norm="ortho")
        coil = b * c * hw * 8  # one complex64 / real-view float32 coil tensor
        src = "mridc_tpu_torch/csrc/full_dc.cu"
        rep = "mridc_tpu/nn/dc.py:81 (log_likelihood_gradient)"
        # bytes: what each stage must read and write once; a few flops per element
        row("k2_expand", src, rep, k2.expand, k2.expand_plain, (eta, sens, True),
            2 * coil + b * hw * 8, {"float32": 6 * b * c * hw}, F32)
        row("k2_residual", src, rep, k2.residual, k2.residual_plain, (k_c, y, mask, True),
            3 * coil + b * hw * 4, {"float32": 4 * b * c * hw}, F32)
        row("k2_reduce", src, rep, k2.reduce, k2.reduce_plain, (p_c, sens, eta, True),
            2 * coil + b * hw * 8 + b * hw * 16, {"float32": 8 * b * c * hw}, F32)
        row("k2_load", src, "mridc_tpu/nn/dc.py:59 (sens_reduce)", k2.load, k2.load_plain, (y, mask, True),
            2 * coil + b * hw * 4, {"float32": 2 * b * c * hw}, F32)
        del x_c, k_c, p_c

        for dt, dname, es, tol in ((torch.float32, "float32", 4, F32), (torch.bfloat16, "bfloat16", 2, K3_BF16)):
            args = k3_args[dt]
            p, fi = args[0].shape[0] * args[0].shape[2] * args[0].shape[3], args[0].shape[1]
            fo = args[1].shape[1]
            # bytes: x and h in, h' out, [P, F] each, and the weights;
            # flops: the [P, F] x [F, F] product and the epilogue (3 per output)
            nbytes = es * (p * fi + 2 * p * fo + fo * fi + 2 * fo)
            flops = {PRODUCTS[dname]: 2 * p * fi * fo, "float32": 3 * p * fo}
            row(K3[dt], "mridc_tpu_torch/csrc/indrnn.cu", "mridc_tpu/nn/rnn_cells.py:88 (IndRNNCell.__call__)",
                kernels.indrnn, kernels.indrnn_plain, args, nbytes, flops, tol)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
