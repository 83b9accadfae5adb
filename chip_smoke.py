#!/usr/bin/env python3
"""Drive mridc_tpu_torch's main path on one NVIDIA H100 and hold every
hand-written kernel against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises; no phase catches its own):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build the kernels of ``mridc_tpu_torch/csrc`` (one nvcc per source, in
     parallel) and print each kernel's registers and spills;
  3. each kernel against its plain version on the card, at the flagship shapes
     (B=2, 15 coils, 320x320, 64 filters) and at an odd size; K1 forward
     and backward (both dtypes) also at one coil, W=200, H=40, W=368 and W=396
     (the edges of their tiles), K1-f32 also at W=640 (its wide route); K3-f32
     also at 64 -> 128 and 128 -> 128 channels, at in-channels
     that are not a multiple of 8, and over a pixel count that no tile
     divides; K3-bwd (both dtypes) at 64 -> 64, 64 -> 128, 128 -> 128 and
     16 -> 8 channels over that count, float32 also at 128 -> 64, 136 -> 64,
     36 -> 64 and 34 -> 64 (both sides of its route boundary), each with its
     launch setup;
  4. a small CIRIM (15 coils, 64x64, 2 cascades x 3 steps, 64 filters) on the
     card against the same weights on the CPU, in both dc_modes;
  5. the main path: flagship CIRIM inference (bench.py's flagship_cfg: 5 x 8,
     IndRNN, 64 filters, centered ortho FFT, psf1d, bf16 compute) serving
     requests of B=8 (2 warm-up, 5 timed), then the same weights in f32 psf1d
     and f32 full; launch counters are zeroed before and read after; the three
     predictions must agree, and one K3 call's operands are kept;
  6. each kernel against its plain version again on the main path's operands
     (B=8: the f32 prediction as eta, the captured K3 call), then its time
     beside its bound and its plain version's time; K1's launch in each dtype
     (grid, shared memory, blocks per SM, tile; f32 also its route) and the
     L2-to-SM bytes its tiles imply beside the first version's;
  7. a small CIRIM training step (phase 4's model, f32, remat "step+cascade")
     on the card against the CPU path, in both dc_modes: loss, every
     parameter gradient, and the parameters after one Adam step under
     InverseSquareRootAnnealing;
  8. the training path: flagship CIRIM trained through ``Trainer`` (the
     flagship weights of phase 5, bench.py's data and training target) as
     ``train_bf16_psf1d`` at B=24 (the JAX bench's training batch),
     ``train_f32_psf1d`` and ``train_f32_full`` at B=8, 2 warm-up and 3 timed
     steps each, launch counters zeroed before and read after; the first-step
     gradients of the three agree on the same B=8 slices (the bf16 ones also
     with the loss's normalising maxima held); 8b. one traced step per run, by
     layer;
  9. each backward kernel against its plain version on the operands of one of
     its calls in a training step, then its time beside its bound and its
     plain version's time; K1-bf16's forward is also checked and timed at the
     B=24 operands (a line of its own, not a kernels row); K1's launches at
     the training operands; K3-bwd's launch setup in each dtype (route, tile,
     stages, blocks, blocks per SM, shared memory) beside its library's
     registers and spills.

Output: JSON lines per check, run and kernel; then the ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
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

# launches per training step of the flagship (N = 5 cascades x T = 8 steps,
# 2 cells) under remat_mode "step+cascade", the non-reentrant checkpoints of
# nn/rim.py and models/recon/cirim.py:
#   - the DC runs outside the step checkpoint and inside the cascade one: in
#     the forward and again in the cascade recompute, 2NT = 80;
#   - a cell runs in the forward, in the cascade recompute and in its step's
#     recompute, except that the cascade recompute stops once it has rebuilt
#     the last tensor its backward needs, the last step's DC output, and so
#     skips the last step's stack: 2N(3T - 1) = 230;
#   - backward: the DC of every step but the first (a cascade's first
#     estimate is the SENSE init or the previous cascade's detached estimate,
#     so no gradient flows into it), N(T - 1) = 35; every cell, 2NT = 80;
#   - sens_reduce (K2 load + reduce): the SENSE init once, and the psf1d data
#     term z0 per cascade in the forward and in its recompute, 1 + 2N = 11.
# train_f32_full's k2_expand counts the forward's 80 and the backward's 35.
PER_STEP = {
    "train_bf16_psf1d": {"k1_psf1d_dc_bf16": 80, "k1_psf1d_dc_bwd_bf16": 35, "k3_indrnn_bf16": 230,
                         "k3_indrnn_bwd_bf16": 80, "k2_load": 11, "k2_reduce": 11},
    "train_f32_psf1d": {"k1_psf1d_dc_f32": 80, "k1_psf1d_dc_bwd_f32": 35, "k3_indrnn_f32": 230,
                        "k3_indrnn_bwd_f32": 80, "k2_load": 11, "k2_reduce": 11},
    "train_f32_full": {"k2_expand": 115, "k2_residual": 80, "k2_mask": 35, "k2_reduce": 81, "k2_reduce_acc": 35,
                       "k2_load": 1, "k3_indrnn_f32": 230, "k3_indrnn_bwd_f32": 80},
}
TRAIN_BATCH, TRAIN_F32_BATCH, TRAIN_WARMUP, TRAIN_ITERS = 24, 8, 2, 3
# projects/reconstruction/conf/base_cirim_train.yaml's optim block
TRAIN_OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
               "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}
TRAIN_CFG = {"max_steps": 100, "gradient_clip_val": 0.0}

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


def train_target(batch, h, w):
    """bench.py's training target (make_flagship_train_step): complex normal
    [B, H, W] from seed 1, as a real view."""
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((batch, h, w)) + 1j * rng.standard_normal((batch, h, w))).astype(np.complex64)
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


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


@contextlib.contextmanager
def held_max_normalisation(losses, hold=True):
    """While active (if ``hold``), the training loss of ``losses`` (the module
    ``mridc_tpu_torch.train.losses``) divides each magnitude by its maximum
    detached: the gradient without the maximum's own term."""
    import torch

    orig = losses._norm_mag

    def norm_mag(x):
        mag = losses.cabs(x) if x.shape[-1] == 2 else x.abs()
        return mag / torch.clamp(mag.amax().detach(), min=1e-12)

    if hold:
        losses._norm_mag = norm_mag
    try:
        yield
    finally:
        losses._norm_mag = orig


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


def ptxas_by_kernel(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel (mangled name, shortened): its
    registers and spills}."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            name = name[name.find("kernel") - 24 :] if "kernel" in name else name
        elif name and ("spill" in ln or "Used" in ln):
            out[name] = (out.get(name, "") + " " + ln.replace("ptxas info    :", "").strip()).strip()
    return out


def k1_l2_bytes(setup: dict, b: int, c: int, h: int, w: int, bwd: bool, dtype: str = "bfloat16") -> dict:
    """Bytes that one call of a K1 kernel moves between L2 and the SMs at
    [b, c, h, w], from its launch setup, beside the first version's.
    bfloat16: per tile, its operator rows for every v (the two planes it
    reads, Cr and Cr+Ci), eta's rows (4 bytes a pixel; the backward's g
    channels 2:4 fetch whole 8-byte pixels), every coil's s_c rows, and its
    output with z0 (forward) or g (backward); the first version took one
    32 x 64 tile a block, re-staging 8 KB of operator and 8 KB of eta and s_c
    for every coil and 32 columns of v. float32, on-chip route: per tile, the
    three planes' operator rows for every v, eta's rows (8 bytes a pixel; the
    backward's g channels 2:4 fetch whole 16-byte pixels), every coil's s_c
    rows, and every coil's s_c at the tile's pixels (the epilogue's conj(s_c)),
    and its output with z0 or g; the first version (the wide route's kernel)
    re-stages 8 KB of operator and 8 KB of eta and s_c for every coil
    and 16 columns of v in each 32 x 64 tile."""
    tm, tn = setup["tile_h"], setup["tile_u"]
    tiles = b * -(-h // tm) * -(-w // tn)
    if dtype == "bfloat16":
        per_tile = 2 * tn * w * 2 + tm * w * (8 if bwd else 4) + c * tm * w * 4 + tm * tn * 12
        first = b * -(-h // 32) * -(-w // 64) * c * -(-w // 32) * 16384
    else:
        per_tile = 3 * tn * w * 4 + tm * w * (16 if bwd else 8) + c * tm * w * 8 + c * tm * tn * 8 + tm * tn * 24
        first = b * -(-h // 32) * -(-w // 64) * c * -(-w // 16) * 16384
    l2 = first if setup.get("route") == "wide" else tiles * per_tile
    return {"tiles": tiles, "l2_bytes": l2, "l2_bytes_first_version": first}


def kernel_category(name: str) -> str:
    """Which layer a CUDA kernel of a forward or training step belongs to, by
    its name."""
    n = name.lower()
    if "psf1d_dc" in n:
        return "K1 psf1d_dc backward" if "<true" in n else "K1 psf1d_dc"
    if "indrnn_bwd" in n or "reduce_partials" in n:
        return "K3 indrnn backward"
    if "indrnn" in n:
        return "K3 indrnn"
    if "anonymous namespace" in n and any(k in n for k in ("mask_kernel", "reduce_acc_kernel")):
        return "K2 backward stages"
    if "anonymous namespace" in n and any(k in n for k in ("expand_kernel", "residual_kernel", "load_kernel",
                                                            "reduce_kernel")):
        return "K2 stages"
    if "fft" in n:
        return "cuFFT"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "sm90", "cutlass", "nhwc", "nchw", "wgrad",
                            "dgrad")):
        return "conv and GEMM (cuDNN, cuBLAS)"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer (Adam)"
    return "elementwise: pad, cast, add, copy"


def trace_call(fn, ms_per_call):
    """Device time of one call of ``fn`` (a forward or a training step) by
    kernel and by layer, from torch.profiler's CUDA kernel events (CUPTI),
    beside the unprofiled wall time of a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    return {"device_ms": busy, "wall_ms": ms_per_call,
            "device_busy_share": busy / ms_per_call if ms_per_call else None,
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
    from mridc_tpu_torch.kernels import common as kcommon
    from mridc_tpu_torch.kernels import k1_psf1d_dc as k1mod
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.kernels import k3_indrnn as k3mod
    from mridc_tpu_torch.kernels.k1_psf1d_dc import BWD_SYMBOLS as K1_BWD
    from mridc_tpu_torch.kernels.k1_psf1d_dc import SYMBOLS as K1
    from mridc_tpu_torch.kernels.k3_indrnn import BWD_SYMBOLS as K3_BWD
    from mridc_tpu_torch.kernels.k3_indrnn import SYMBOLS as K3
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.nn.dc import psf1d_gauss_mats
    from mridc_tpu_torch.nn.rnn_cells import IndRNNCell
    from mridc_tpu_torch.train import losses as train_losses
    from mridc_tpu_torch.train.losses import process_reconstruction_loss
    from mridc_tpu_torch.train.trainer import Trainer
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
            ptxas[name] = ptxas_by_kernel(log.read_text())
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

        def check_k3_bwd(tag, args):
            """K3-bwd on ``args`` = (g, x, h, h', W, u) against its plain version:
            dx, dh against the plain version in float32 on the same operands,
            rounded once (F32, or K3_BF16 in bf16); the sums over all pixels
            against the plain version in float64 at rtol 1e-4 (float32) or 1e-3
            (bf16), atol 1e-4 x max."""
            dt = args[1].dtype
            sym = K3_BWD[dt]
            got = k3mod.indrnn_bwd(*args)
            plain32 = k3mod.indrnn_bwd_plain(*(a.float() for a in args))
            plain64 = k3mod.indrnn_bwd_plain(*(a.double() for a in args))
            tol = F32 if dt == torch.float32 else K3_BF16
            tol_sums = (1e-4, 1e-4) if dt == torch.float32 else (1e-3, 1e-4)
            for i, part in enumerate(("dx", "dh", "dW", "db", "du")):
                want = plain32[i].to(dt) if i < 2 else plain64[i].reshape(got[i].shape)
                errors.setdefault(sym, []).append(
                    check(f"{sym}[{part}/{tag}]", got[i], want, *(tol if i < 2 else tol_sums)))

        def check_k1_bwd(label, b, c, h, w, dt):
            """K1-bwd in ``dt`` on an upstream g drawn at [b, h, w, 4], against
            its plain version rounded once, at F32 or K1_BF16."""
            _, sens_b, mask_b = (t(a) for a in bench_data(b, c, h, w, seed=4))
            args = (rand(b, h, w, 4).to(dt), sens_b.to(dt), psf1d_gauss_mats(mask_b[:, 0, 0, :], True, "ortho").to(dt),
                    0.7)
            sym = K1_BWD[dt]
            errors.setdefault(sym, []).append(check(f"{sym}[{label}]", k1mod.psf1d_dc_bwd(*args),
                                                    rounded_once(k1mod.psf1d_dc_bwd_plain, *args),
                                                    *(F32 if dt == torch.float32 else K1_BF16)))

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
                check_k1_bwd(label, b, c, h, w, dt)

            ci, fo = (FILTERS, FILTERS) if label != "odd" else (32, 24)  # odd: 3 n-tiles, a ragged pixel tile
            x, hprev = cl(rand(b, ci, h, w)), cl(rand(b, fo, h, w, positive=True))
            wt, bias, hh = rand(fo, ci, 1, 1) / np.sqrt(ci), rand(fo) * 0.1, rand(1, fo, 1, 1, positive=True)
            for dt, tol in ((torch.float32, F32), (torch.bfloat16, K3_BF16)):
                sym = K3[dt]
                args = [a.to(dt) for a in (x, hprev, wt, bias, hh)]
                errors.setdefault(sym, []).append(
                    check(f"{sym}[{label}]", kernels.indrnn(*args), rounded_once(kernels.indrnn_plain, *args), *tol))

        # K1 forward and backward at the edges of its tiles. bf16: 64 rows by
        # 64 columns, 64 by 32 where W > 320; f32: 32 by 32 up to W = 320, 16
        # by 32 with rings of 3 chunks up to W = 384 and of 2 up to W = 416,
        # the first version's kernel (32 x 64 blocks) above. One coil; a width that no
        # column tile divides (200); a height that no row tile divides (40);
        # the fastMRI widths on the narrower tiles: 368 (16-byte copies) and
        # 396 (bf16: W % 8 != 0, 4-byte copies of s_c and eta, plain operator
        # loads; f32: 2 stages); f32 also at 640 (the wide route; the bf16
        # kernel refuses it); bench.py's 1D mask. The f32 launch setup is
        # printed for each
        for label, (b, c, h, w) in {"one_coil": (2, 1, 64, 64), "w200": (2, COILS, 64, 200),
                                    "h40": (2, COILS, 40, 64), "w368": (1, 4, 48, 368),
                                    "w396": (1, 4, 48, 396), "w640": (1, 2, 40, 640)}.items():
            y_e, sens_e, mask_e = (t(a) for a in bench_data(b, c, h, w, seed=6))
            operands = (rand(b, h, w, 2), sens_e, psf1d_gauss_mats(mask_e[:, 0, 0, :], True, "ortho"),
                        k2.sens_reduce_plain(y_e, sens_e, mask_e, True, "ortho"))
            for dt, tol in ((torch.float32, F32), (torch.bfloat16, K1_BF16)):
                if dt == torch.bfloat16 and w > 480:
                    continue
                args = [a.to(dt) for a in operands]
                sym = K1[dt]
                errors[sym].append(check(f"{sym}[{label}]", kernels.psf1d_dc(*args, 0.7),
                                         rounded_once(kernels.psf1d_dc_plain, *args, 0.7), *tol))
                check_k1_bwd(label, b, c, h, w, dt)
            emit({"k1_f32_launch": label, "shape": [b, c, h, w], **k1mod.f32_setup(b, h, w, dev), "card": card})

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

        # K3-bwd, both dtypes, at the widths projects/ uses (64 -> 64, 64 ->
        # 128, 128 -> 128) and at the narrowest the bf16 kernel takes (16 -> 8:
        # out-channels padded to the MMA's 16), and float32 on both sides of
        # its route boundary (the 3xTF32 kernel takes in- and out-channels % 4
        # == 0 up to 64 x 128 and 128 x 64: 36 -> 64 and 128 -> 64 run on it,
        # 34 -> 64, 136 -> 64 and 128 -> 128 on the wide route), over 2 x 33 x
        # 35 pixels, a count that no pixel tile divides; h' with about half its
        # entries at 0. The launch setup of each is printed
        both, f32_only = (torch.float32, torch.bfloat16), (torch.float32,)
        for (ci, fo), dts in (((64, 64), both), ((64, 128), both), ((128, 128), both), ((16, 8), both),
                              ((128, 64), f32_only), ((136, 64), f32_only), ((36, 64), f32_only),
                              ((34, 64), f32_only)):
            shape = (2, fo, 33, 35)
            x, hprev = cl(rand(2, ci, 33, 35)), cl(rand(*shape, positive=True))
            out, g = cl(torch.relu(rand(*shape))), cl(rand(*shape))
            wt, hh = rand(fo, ci, 1, 1) / np.sqrt(ci), rand(1, fo, 1, 1, positive=True)
            for dt in dts:
                check_k3_bwd(f"{ci}->{fo}/2x33x35", tuple(a.to(dt) for a in (g, x, hprev, out, wt, hh)))
                emit({"k3_bwd_launch": f"{ci}->{fo}/2x33x35", "dtype": str(dt),
                      **k3mod.bwd_setup(dt, 2 * 33 * 35, ci, fo, dev), "card": card})
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
    missing = [k for k in set().union(*PER_FORWARD.values()) if main_counts[k] == 0]
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
        model = models[run["run"]]
        with torch.inference_mode():
            rec = trace_call(lambda: model(y, sens, mask), run["ms_per_forward"])
        emit({"trace": run["run"], **rec, "card": card})
    del models, preds

    # 6. each kernel against its plain version on the main path's operands
    # (B=8), then its time beside its bound
    b, c, hw = BATCH, COILS, H * W
    eta = ref.contiguous()
    mats = psf1d_gauss_mats(mask[:, 0, 0, :], True, "ortho")
    z0 = kernels.sens_reduce(y, sens, mask, True, "ortho")
    rows = []

    def row(sym, source, replaces, fn, plain, args, nbytes, flops, tol, launches=None, per="forward"):
        # the oracle first: k2_residual overwrites its first operand; tol None:
        # the caller has checked the kernel
        if tol is not None:
            want = rounded_once(plain, *args)
            errors.setdefault(sym, []).append(check(f"{sym}[main_b{args[0].shape[0]}]", fn(*args), want, *tol))
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(lambda: plain(*args))
        bound_ms, by = bound(nbytes, flops)
        table = PER_FORWARD if per == "forward" else PER_STEP
        rows.append({"name": sym, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": (main_counts if launches is None else launches).get(sym, 0),
                     "max_abs_err": max(errors[sym]), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
        emit({"kernel": sym, "shape": tuple(args[0].shape), "dtype": str(args[0].dtype), "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes, "flops": flops,
              f"launches_per_{per}": {r: table[r].get(sym, 0) for r in table}, "card": card})

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
        setup = k1mod.bf16_setup(b, H, W, dev)
        emit({"k1_bf16_launch": "forward", "batch": b, **setup, **k1_l2_bytes(setup, b, c, H, W, False),
              "card": card})
        setup = k1mod.f32_setup(b, H, W, dev)
        emit({"k1_f32_launch": "forward", "batch": b, **setup,
              **k1_l2_bytes(setup, b, c, H, W, False, "float32"), "card": card})

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

    # 7. a small CIRIM training step: kernels on the card against the plain
    # path on the CPU, loss, every gradient, and the parameters after one Adam
    # step (f32, remat "step+cascade", phase 4's model and weights)
    ts = train_target(2, 64, 64)
    small_batch = {"masked_kspace": ys, "sensitivity_maps": ss, "mask": ms, "target": ts}
    for mode in ("psf1d", "full"):
        cfg = dict(small, dc_mode=mode, remat_mode="step+cascade")
        res = {}
        for where in (DEVICE, "cpu"):
            model = build_model(cfg, device=where)
            model.load_state_dict(state_small)
            trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=where)
            loss = trainer.training_batch(small_batch)["loss"]
            res[where] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()},
                          {k: p.detach().cpu() for k, p in model.named_parameters()})
        (l_dev, g_dev, p_dev), (l_cpu, g_cpu, p_cpu) = res[DEVICE], res["cpu"]
        check(f"train_small_loss[{mode}]", torch.tensor(l_dev), torch.tensor(l_cpu), 2e-3, 2e-4)
        # gradients: rtol 2e-3, atol 1e-3 x max. float32 itself is no closer on
        # this model: the CPU path's float32 gradients lie up to 3.0e-4 x max
        # from its float64 ones (rnn.ih.weight of cascade 0), since relu kinks
        # flip under another summation order. The parameters after one Adam
        # step (lr x g / (|g| + eps), a sign step) are held at rtol 2e-3 / atol
        # 2e-4 x max where |g| exceeds the gradient tolerance, so that float32
        # decides the sign of the step
        for k in g_cpu:
            atol_g = 1e-3 * float(g_cpu[k].abs().max())
            check(f"train_small_grad[{mode}/{k}]", g_dev[k], g_cpu[k], 2e-3, 1e-3)
            sure = g_cpu[k].abs() > atol_g
            if not bool(sure.any()):
                continue
            check(f"train_small_param_after_adam[{mode}/{k}]", p_dev[k][sure], p_cpu[k][sure], 2e-3,
                  2e-4 * float(p_cpu[k].abs().max()) / max(float(p_cpu[k][sure].abs().max()), 1e-30),
                  note=f"{int((~sure).sum())} of {sure.numel()} elements with |g| <= {atol_g:.3g} left out")

    # 8. the training path: flagship CIRIM trained through Trainer, first-step
    # gradients compared on the same B=8 slices, then 2 warm-up and 3 timed
    # steps per run with the launch counters zeroed before and read after
    train_runs = {
        "train_bf16_psf1d": (flagship_cfg(), TRAIN_BATCH),
        "train_f32_psf1d": (flagship_cfg(compute_dtype=None), TRAIN_F32_BATCH),
        "train_f32_full": (flagship_cfg(compute_dtype=None, dc_mode="full"), TRAIN_F32_BATCH),
    }
    target8 = t(train_target(BATCH, H, W))
    first, fixed, top = {}, {}, {}
    # the three runs' configurations, and the flagship with its DC in float32
    # (train_dc_dtype null): the pair the JAX package's 0.9996 compares
    grad_cfgs = {**{k: v[0] for k, v in train_runs.items()}, "bf16_f32dc": flagship_cfg(train_dc_dtype=None)}
    for name, cfg in grad_cfgs.items():
        model = build_model(cfg, device=dev)
        model.load_state_dict(state)
        for grads, hold_max in ((first, False), (fixed, True)):
            model.zero_grad(set_to_none=True)
            out = model(y, sens, mask, train=True)
            with held_max_normalisation(train_losses, hold_max):
                process_reconstruction_loss(out, target8, "l1").backward()
            grads[name] = torch.cat([p.grad.flatten().double() for _, p in sorted(model.named_parameters())])
            if not hold_max:  # the pixel of each step's normalising maximum
                top[name] = out.intermediates.detach().float().square().sum(-1).flatten(2).argmax(-1).cpu()
        del model, out

    def cosine(g, a, b):
        return float(g[a] @ g[b] / (g[a].norm() * g[b].norm()))

    ref_g = first["train_f32_psf1d"]
    readings = {
        "rel_l2_f32_full_vs_f32_psf1d": float((first["train_f32_full"] - ref_g).norm() / ref_g.norm()),
        "cosine_bf16_dc_vs_f32_dc": cosine(first, "train_bf16_psf1d", "bf16_f32dc"),
        "cosine_bf16_psf1d_vs_f32_psf1d": cosine(first, "train_bf16_psf1d", "train_f32_psf1d"),
        "held_max_cosine_bf16_dc_vs_f32_dc": cosine(fixed, "train_bf16_psf1d", "bf16_f32dc"),
        "held_max_cosine_bf16_psf1d_vs_f32_psf1d": cosine(fixed, "train_bf16_psf1d", "train_f32_psf1d"),
    }
    # full vs psf1d: the same function in float32. bf16 against float32: the
    # loss divides each step's magnitude by its maximum over the batch, and
    # where two pixels' magnitudes lie within bf16's rounding of each other
    # the two runs pick different pixels and the maximum's gradient goes to
    # different places: on these slices the float32 top two of cascade 3,
    # step 6 lie 0.04% apart, and the bf16 run takes the other one. That costs
    # the whole-gradient cosine (0.983 on an H100; 0.9994 on the CPU path
    # with the same inputs) but no kernel's accuracy: with each normalising
    # maximum held (detached) the H100 reads 0.99998, and the 0.999 limit
    # holds that; the whole-gradient limits catch a gross error only
    grad_limits = {"rel_l2_f32_full_vs_f32_psf1d": ("<", 1e-4), "cosine_bf16_dc_vs_f32_dc": (">=", 0.995),
                   "cosine_bf16_psf1d_vs_f32_psf1d": (">=", 0.97),
                   "held_max_cosine_bf16_dc_vs_f32_dc": (">=", 0.999),
                   "held_max_cosine_bf16_psf1d_vs_f32_psf1d": (">=", 0.999)}
    flips = {pair: (top[a] != top[b]).nonzero().tolist() for pair, (a, b) in
             {"bf16_vs_f32": ("train_bf16_psf1d", "train_f32_psf1d"),
              "bf16_dc_vs_f32_dc": ("train_bf16_psf1d", "bf16_f32dc")}.items()}
    rec = {"check": "train_first_step_gradients", "batch": BATCH, **readings,
           "limits": {k: f"{op} {v}" for k, (op, v) in grad_limits.items()},
           "max_pixel_differs_at_cascade_step": flips, "card": card}
    emit(rec)
    if not all(readings[k] < v if op == "<" else readings[k] >= v for k, (op, v) in grad_limits.items()):
        raise AssertionError(f"first-step gradients disagree: {rec}")
    del fixed
    del first, ref_g

    captured: dict = {}  # one backward call's operands per kernel (phase 9)

    def capturing(module, fname, key):
        orig = getattr(module, fname)

        def wrapped(*args, **kw):
            captured.setdefault(key(*args), tuple(a.detach() if torch.is_tensor(a) else a for a in args))
            return orig(*args, **kw)

        setattr(module, fname, wrapped)
        return lambda: setattr(module, fname, orig)

    train_counts, train_recs = {k: 0 for k in binding.LAUNCHES}, []
    for name, (cfg, b) in train_runs.items():
        yb, sb, mb = (y, sens, mask) if b == BATCH else (t(a) for a in bench_data(b, COILS, H, W))
        batch = {"masked_kspace": yb, "sensitivity_maps": sb, "mask": mb,
                 "target": target8 if b == BATCH else t(train_target(b, H, W))}
        model = build_model(cfg, device=dev)
        model.load_state_dict(state)
        trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=dev)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        kcommon.GRAD_COPIES.clear()
        for _ in range(TRAIN_WARMUP):
            trainer.training_batch(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            metrics = trainer.training_batch(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
        delta = {k: v for k, v in counts.items() if v}
        steps = TRAIN_WARMUP + TRAIN_ITERS
        want = {k: v * steps for k, v in PER_STEP[name].items()}
        moved = max(float((p.detach() - before[k]).abs().max()) for k, p in model.named_parameters())
        rec = {"run": name, "batch": b, "steps_timed": TRAIN_ITERS, "seconds": dt,
               "slices_per_s": TRAIN_ITERS * b / dt, "ms_per_step": dt / TRAIN_ITERS * 1e3,
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
               "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "max_param_change": moved, "launches_per_step": {k: v / steps for k, v in delta.items()},
               "grad_copies_per_step": {k: v / steps for k, v in kcommon.GRAD_COPIES.items()}, "card": card}
        train_recs.append(rec)
        emit(rec)
        if delta != want:
            raise AssertionError(f"{name}: launches {delta} != expected {want}")
        if not np.isfinite(rec["loss"]) or not moved > 0:
            raise AssertionError(f"{name}: loss {rec['loss']} not finite or parameters unchanged ({moved})")
        for k, v in delta.items():
            train_counts[k] += v

        # 8b. where a training step's device time goes (one traced step)
        emit({"trace": name, **trace_call(lambda: trainer.training_batch(batch), rec["ms_per_step"]), "card": card})
        # operands of one call of each backward kernel, from one more step
        restore = [capturing(k1mod, "psf1d_dc_bwd", lambda g, s_, *a: K1_BWD[s_.dtype]),
                   capturing(k3mod, "indrnn_bwd", lambda g, x, *a: K3_BWD[x.dtype]),
                   capturing(k2, "full_dc_bwd", lambda *a: "k2_bwd")]
        trainer.training_batch(batch)
        for undo in restore:
            undo()
        del trainer, model, batch, yb, sb, mb
        torch.cuda.empty_cache()

    # 9. each backward kernel against its plain version on the captured
    # operands, then its time beside its bound (launches: per training step)
    with torch.inference_mode():
        for dt, dname, es, tol in ((torch.float32, "float32", 4, F32), (torch.bfloat16, "bfloat16", 2, K1_BF16)):
            g, sk, mk, sigma = captured[K1_BWD[dt]]
            g = g.contiguous()
            b = g.shape[0]
            args = (g, sk, mk, sigma)
            # bytes: g [B, H, W, 4], sens and the 3 Gauss matrices in; d_eta out;
            # flops: those of the forward (the same operator)
            nbytes = es * (b * hw * 4 + b * c * hw * 2 + b * 3 * W * W + b * hw * 2)
            flops = {PRODUCTS[dname]: 6 * b * c * H * W * W, "float32": 17 * b * c * hw + 4 * b * hw}
            if dt == torch.bfloat16:
                # the forward at the training step's operands (g's channels 2:4 as
                # eta, 0:2 as z0), checked and timed here; not a kernels row
                fargs = [g[..., 2:].contiguous(), sk, mk, g[..., :2].contiguous(), sigma]
                check(f"{K1[dt]}[train_b{b}]", kernels.psf1d_dc(*fargs), rounded_once(kernels.psf1d_dc_plain, *fargs),
                      *tol)
                fwd_bytes = es * (b * hw * 2 + b * c * hw * 2 + b * 3 * W * W + b * hw * 2 + b * hw * 4)
                fwd_bound, fwd_by = bound(fwd_bytes, flops)
                emit({"kernel": K1[dt], "shape": tuple(fargs[0].shape), "dtype": str(dt),
                      "ms": time_ms(lambda: kernels.psf1d_dc(*fargs)),
                      "plain_ms": time_ms(lambda: kernels.psf1d_dc_plain(*fargs)), "bound_ms": fwd_bound,
                      "bound_by": fwd_by, "note": "forward at the training step's operands", "card": card})
            for bwd in (False, True):
                setup = (k1mod.bf16_setup if dt == torch.bfloat16 else k1mod.f32_setup)(b, H, W, dev, bwd)
                emit({f"k1_{'bf16' if dt == torch.bfloat16 else 'f32'}_launch": "backward" if bwd else "forward",
                      "batch": b, **setup, **k1_l2_bytes(setup, b, c, H, W, bwd, dname), "card": card})
            row(K1_BWD[dt], "mridc_tpu_torch/csrc/psf1d_dc.cu", "mridc_tpu/nn/dc.py:162 (log_likelihood_gradient_psf1d, "
                "backward)", k1mod.psf1d_dc_bwd, k1mod.psf1d_dc_bwd_plain, args, nbytes, flops, tol,
                train_counts, "step")

        g, sk, mk, sigma, centered, norm = captured["k2_bwd"]
        g = g.contiguous()
        b = g.shape[0]
        k_c = torch.fft.fft2(k2.expand(g[..., 2:], sk, centered), norm=norm)
        p_c = torch.fft.ifft2(k_c, norm=norm)
        coil = b * c * hw * 8
        src, rep = "mridc_tpu_torch/csrc/full_dc.cu", "mridc_tpu/nn/dc.py:81 (log_likelihood_gradient, backward)"
        row("k2_mask", src, rep, k2.apply_mask, k2.apply_mask_plain, (k_c, mk, centered),
            2 * coil + b * hw * 4, {"float32": 2 * b * c * hw}, F32, train_counts, "step")
        row("k2_reduce_acc", src, rep, k2.reduce_acc, k2.reduce_acc_plain, (p_c, sk, g, centered, sigma),
            2 * coil + b * hw * 16 + b * hw * 8, {"float32": 8 * b * c * hw + 2 * b * hw}, F32, train_counts, "step")
        del k_c, p_c

        for dt, dname, es in ((torch.float32, "float32", 4), (torch.bfloat16, "bfloat16", 2)):
            sym = K3_BWD[dt]
            g, x, hprev, out, wt, hh, need_dx, need_dh = captured[sym]
            g = g.contiguous(memory_format=torch.channels_last)
            args = (g, x, hprev, out, wt, hh)
            check_k3_bwd(f"main_b{x.shape[0]}", args)
            p, fi, fo = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1], hprev.shape[1]
            emit({"k3_bwd_launch": f"main_b{x.shape[0]}", "dtype": str(dt), **k3mod.bwd_setup(dt, p, fi, fo, dev),
                  "ptxas": ptxas.get("indrnn_bwd", {}), "card": card})
            # bytes: x, h, h' and g in, dx and dh out, W in (the activations'
            # dtype), u in and the sums out (float32); flops: the two [P, F] x
            # [F, CI] products, and per output channel and pixel the relu
            # mask, dh, db, du
            nbytes = es * (2 * p * fi + 4 * p * fo + fo * fi) + 4 * (fo * fi + 3 * fo)
            flops = {PRODUCTS[dname]: 4 * p * fi * fo, "float32": 5 * p * fo}
            row(sym, "mridc_tpu_torch/csrc/indrnn_bwd.cu", "mridc_tpu/nn/rnn_cells.py:88 (IndRNNCell.__call__, "
                "backward)", k3mod.indrnn_bwd, k3mod.indrnn_bwd_plain, args, nbytes, flops, None, train_counts, "step")
        for r in rows:
            r["train_launches"] = train_counts.get(r["name"], 0)
        missing = [k for k in set().union(*PER_STEP.values()) if train_counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the training path: {missing}")

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
