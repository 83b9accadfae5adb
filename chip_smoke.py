#!/usr/bin/env python3
"""Drive mridc_tpu_torch's main path on one NVIDIA H100 and hold every
hand-written kernel against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises; no phase catches its own):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build the kernels of ``mridc_tpu_torch/csrc`` (one nvcc per source, in
     parallel) and print each kernel's registers and spills; 2b. with cuDNN's
     TF32 flag at PyTorch's default (on; the script never sets it), the
     package's float32 conv forward and backward against float64;
  3. each kernel against its plain version on the card, at the flagship shapes
     (B=2, 15 coils, 320x320, 64 filters) and at an odd size; K1 forward
     and backward (both dtypes) also at one coil, W=200, H=40, W=368 and W=396
     (the edges of their tiles), and at W=640 (both dtypes' wide routes,
     each route printed); K3-f32
     also at 64 -> 128 and 128 -> 128 channels, at in-channels
     that are not a multiple of 8, and over a pixel count that no tile
     divides; K3-bwd (both dtypes) at 64 -> 64, 64 -> 128, 128 -> 128 and
     16 -> 8 channels over that count, float32 also at 128 -> 64, 136 -> 64,
     36 -> 64 and 34 -> 64 (both sides of its route boundary), each with its
     launch setup; K3 forward and backward at widths its kernels take only
     split (``kernels.k3_indrnn.plan``: bf16 48 -> 200, float32 64 -> 300,
     bf16 320 -> 64) and with a 3x3 input kernel at dilation 2 (64 -> 64,
     B=2, 320x320), in both dtypes, each plan printed and its launches
     counted;
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
     on the card against the CPU path, in both dc_modes and with the soft-DC
     tail (SENSE expand and reduce, forward and backward): loss, every
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
     registers and spills;
  V1. E2EVN/VarNet: a small VarNet (2 cascades, 8 channels, 2 pools, 4
     coils, 64x64 and 37x45) on the card against the CPU, both dc_modes, f32
     and bf16, centered ortho and uncentered backward FFTs: the forward, then
     one Trainer step (loss, gradients, parameters after Adam);
  V2. serving at full width (bench.py's e2evn_cfg: 8 cascades, NormUnet 18
     channels x 4 pools) at B=8 as ``vn_bf16_psf1d`` (as configured),
     ``vn_f32_psf1d`` and ``vn_f32_full``, 2 warm-up and 5 timed forwards
     each, launch counters zeroed before each and read after; the three
     predictions agree; the growth of a perturbation per cascade; V2b. one
     traced forward per run; ``vn_bf16_psf1d`` also timed at B=32;
  V3. training at full width through ``Trainer`` at B=8 as
     ``train_vn_bf16_psf1d`` and ``train_vn_f32_full`` (first-step gradients
     against ``vn_f32_psf1d``'s; 2 warm-up and 3 timed steps; launches per
     step; peak memory; one traced step each);
  V4. the SENSE expansion's and reduction's backward on a
     ``train_vn_f32_full`` step's operands, and the psf1d q-term on a K1 call
     of ``vn_bf16_psf1d``, against their plain versions;
  D1. training and evaluating from a dataset, small (4 coils, 64x64, 2
     volumes x 3 slices of an in-memory phantom source that feeds the port's
     ``BatchLoader`` through the port's transform, as an h5 dataset would):
     the loader of ``TRAIN_DS`` (projects/reconstruction/conf/
     base_cirim_train.yaml's train_ds as written: poisson2d) and of its
     equispaced1d variant, each five ways (plain; ``Prefetcher`` over 2
     worker threads; ``DevicePrefetcher``; ``DeviceDatasetCache`` over two
     epochs, the second gathered; ``transfer_dtype="bfloat16"`` through the
     ``DevicePrefetcher``), every leaf on the card bit-identical to the
     plain host loader's; then ``Trainer.fit`` of phase 4's small CIRIM for
     2 epochs on the card and on the CPU from the same weights: per-step
     losses and ``validate()``'s metrics at phase 7's limits;
  D2. training from data at full width (flagship widths, 15 coils, 320x320;
     48 training and 16 validation slices) as ``data_f32_full`` (the
     config's train_ds: poisson2d, acceleration 10, f32, full DC; B=8) and
     ``data_bf16_psf1d`` (equispaced1d, acceleration 4, bf16 psf1d; B=24):
     the host pipeline's ms per batch alone; ``Trainer.fit`` over 1 warm-up
     and 2 timed steps (``D2_WARMUP``, ``D2_ITERS``) fed by the plain loader, by ``Prefetcher`` (depth 2,
     4 workers), by that plus ``DevicePrefetcher``, and by
     ``DeviceDatasetCache`` in its gathered epoch: ms per step, device idle
     share (one more, traced step), launches per step asserted against
     phase 8's ``PER_STEP`` less the SENSE init (``data_per_step``: the
     batches carry the transform's initial prediction), peak memory, phase
     8's synthetic-input step beside them; the poisson2d masker's seconds per
     mask;
  D3. ``validate()`` and ``test()`` over the 16 validation slices with
     ``data_f32_full``'s trained weights: ms per slice, SSIM, PSNR and NMSE
     against the target, and the same metrics from the plain CPU path on the
     same predictions, which must be equal;
  L. the launch path: ``launch.run_from_config`` of
     projects/reconstruction/conf/base_cirim_train.yaml as written
     (``LAUNCH_CFG``) with its overrides printed (one epoch of ``L_STEPS``
     = 24 steps, the phantom roots, ``trainer.profile_dir``), mode
     ``train``, fed by D2's phantom
     volumes in place of the h5 read (``launch_phase``), at the config's
     batch size 1: L1 ``launch_f32_full`` (poisson2d, full DC) and L2
     ``launch_f32_psf1d`` (equispaced1d, acceleration 4: psf1d): ms per step,
     slices/s and peak memory beside D2's plain-loader step, launches per
     step against ``fed_per_step``, the profiler's trace, the run dir
     (config.yaml, hparams.yaml, top-k checkpoints, last, cirim.mridc); L1's
     archive restored on the card tests as the trained model; a resumed fit
     sent SIGTERM after its first step saves ``last`` there, and a third
     resumes from it;
  Z. the zoo at its projects/reconstruction/conf widths (``ZOO_CFGS``: ZF,
     ProximalGradient, UNet 64 x 4 pools, ResNet 10 unrolls x 15 blocks x 64
     channels, CG 10) on bench_data at B=8: the CG's normal operator against
     its plain version, each model's serving (ms, slices/s, launches per
     forward against ``ZOO_PER_FORWARD``) and its prediction against K2's
     plain twins on the card, traced ResNet forward and CG solve;
  Z8. a training step of each (ResNet at B=1 and B=2): loss and gradients
     against K2's plain twins, ms, slices/s, peak memory, launches per step
     against ``ZOO_PER_STEP``, a traced ResNet step; UNet's gradient
     accumulation (``zoo_phases``);
  Z2. CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet and DUNet at their
     projects/reconstruction/conf widths (``ZOO2_CFGS``) on bench_data: K2's
     masked expansion against its plain version; serving B=8 (ms, slices/s,
     launches per forward against ``ZOO2_PER_FORWARD``, the prediction
     against K2's plain twins); training at the configs' B=1 and CascadeNet
     at B=8 (first-step loss and gradients against the plain twins, ms,
     slices/s, peak memory, launches per step against ``ZOO2_PER_STEP``);
     traces by layer and ATen op; live BatchNorm card against CPU
     (``zoo2_phase``);
  S. ``python -m mridc_tpu_torch run -c`` (``cli.main``) of
     projects/unselfsupervised/conf's base_ssdu_train.yaml (ResNet) and
     base_n2r_train.yaml (UNet) as written, at batch 1 on phantom volumes:
     ms per step, slices/s, peak memory, launches per step against
     ``S_PER_STEP``, the run dir, the host pipeline alone and a traced step
     (``selfsup_phase``).

The poisson2d masks of D1 and D2 (pure-Python dart throwing: minutes a mask
at 320x320) are drawn at the start, in worker processes that run beside
phases 2-V4, and S's beside Z and Z8, each by the transform's own masker
with the seed its ``use_seed`` gives each volume, and the source hands them
to the transform as an h5
volume's ``mask`` dataset would: the masked k-space and masks are the ones
the transform draws itself (``tests/test_torch_port_data.py`` holds them
equal); only the batch's ``acceleration`` leaf reads the mask's sampled
share instead of its nominal factor.

Output: JSON lines per check, run and kernel; then the ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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

# E2EVN/VarNet (bench.py:e2evn_cfg, reference base_vn_train.yaml widths): 8
# cascades, NormUnet 18 channels x 4 pools, padding size 11. VN_GAIN scales
# each NormUnet's final 1x1 conv kernel (see vn_layout_tree)
VN_CASCADES, VN_CHANS, VN_POOLS = 8, 18, 4
VN_GAIN = 0.05
VN_BIG_BATCH = 32
# launches per VarNet forward: psf1d runs K1 once per cascade but the last
# (the q-term, which the last cascade's output does not read) and K2's load
# and reduce once (the SENSE init); full holds k-space in FFT order,
# so it loads once (y to that order; centered FFT) and runs per cascade a
# reduce (sens_reduce) and an expand (sens_expand), then one more reduce (the
# final SENSE combination)
VN_PER_FORWARD = {
    "vn_bf16_psf1d": {"k1_psf1d_dc_bf16": 7, "k2_load": 1, "k2_reduce": 1},
    "vn_f32_psf1d": {"k1_psf1d_dc_f32": 7, "k2_load": 1, "k2_reduce": 1},
    "vn_f32_full": {"k2_load": 1, "k2_reduce": 9, "k2_expand": 8},
}
# launches per VarNet training step (no rematerialisation): the forward's,
# and in the backward K1's backward once per q-term (psf1d); (full) a reduce
# per cascade for sens_expand's backward, and an expand for sens_reduce's
# backward in cascades 1-7 and the final combination (cascade 0 reduces y,
# which takes no gradient)
VN_PER_STEP = {
    "train_vn_bf16_psf1d": {"k1_psf1d_dc_bf16": 7, "k1_psf1d_dc_bwd_bf16": 7, "k2_load": 1, "k2_reduce": 1},
    "train_vn_f32_full": {"k2_load": 1, "k2_reduce": 17, "k2_expand": 16},
}

# D1-D3: projects/reconstruction/conf/base_cirim_train.yaml's train_ds, as
# written (tests/test_torch_port_data.py checks it against the YAML)
TRAIN_DS = {
    "data_path": "???", "sense_path": None, "mask_path": None, "challenge": "multicoil", "batch_size": 1,
    "sample_rate": 1, "volume_sample_rate": None, "consecutive_slices": 1, "data_saved_per_slice": False,
    "complex_data": True, "apply_prewhitening": False, "apply_gcc": False, "coil_combination_method": "SENSE",
    "dimensionality": 2,
    "mask_args": {"type": "poisson2d", "accelerations": [10], "center_fractions": [0.7], "scale": 0.02,
                  "shift_mask": True, "use_seed": True},
    "half_scan_percentage": 0.0, "remask": False, "crop_size": None, "kspace_crop": False,
    "crop_before_masking": True, "kspace_zero_filling_size": None, "normalize_inputs": True, "max_norm": True,
    "fft_centered": False, "fft_normalization": "backward", "spatial_dims": [-2, -1], "coil_dim": 1,
    "use_seed": True, "shuffle": True, "drop_last": False,
}
# the 1D-mask variant of D1 and of D2's bf16 psf1d run
EQUISPACED_DS = {**TRAIN_DS, "mask_args": {**TRAIN_DS["mask_args"], "type": "equispaced1d", "accelerations": [4],
                                           "center_fractions": [0.08]}}
D1_COILS, D1_HW, D1_VOLUMES, D1_SLICES, D1_BATCH = 4, 64, 2, 3, 2
# D2: training volumes x slices, validation slices (one volume), host worker
# threads of the prefetching modes, and the two runs: (dataset, model, batch,
# phase 8's run whose PER_STEP they share)
D2_TRAIN_VOLUMES, D2_SLICES, D2_VAL_SLICES, D2_WORKERS = 2, 24, 16, 4
# D2's steps per feeding mode: 1 warm-up and 2 timed, so that the script
# keeps within its time with phase L
D2_WARMUP, D2_ITERS = 1, 2
D2_RUNS = {
    "data_f32_full": (TRAIN_DS, dict(compute_dtype=None, dc_mode="full"), TRAIN_F32_BATCH, "train_f32_full"),
    "data_bf16_psf1d": (EQUISPACED_DS, {}, TRAIN_BATCH, "train_bf16_psf1d"),
}
D2_MODES = ("plain", "prefetch", "prefetch+device_prefetch", "device_cache_gathered")

# L: projects/reconstruction/conf/base_cirim_train.yaml as written, a literal
# so that the script needs no PyYAML (tests/test_torch_port_config.py holds it
# equal to the YAML)
LAUNCH_CFG = {
    "pretrained": False, "checkpoint": None, "mode": "train",
    "model": {
        "coil_combination_method": "SENSE", "use_sens_net": False, "sens_chans": 8, "sens_pools": 4,
        "sens_mask_type": "2D", "fft_centered": False, "fft_normalization": "backward", "spatial_dims": [-2, -1],
        "coil_dim": 1, "complex_data": True, "log_images": True, "train_loss_fn": "l1", "val_loss_fn": "l1",
        "optim": TRAIN_OPTIM, "train_ds": TRAIN_DS, "validation_ds": {**TRAIN_DS, "shuffle": False},
        "test_ds": {**TRAIN_DS, "shuffle": False},
        "model_name": "CIRIM", "recurrent_layer": "IndRNN", "conv_filters": [64, 64, 2], "conv_kernels": [5, 3, 3],
        "conv_dilations": [1, 2, 1], "conv_bias": [True, True, False], "recurrent_filters": [64, 64, 0],
        "recurrent_kernels": [1, 1, 0], "recurrent_dilations": [1, 1, 0], "recurrent_bias": [True, True, False],
        "depth": 2, "time_steps": 8, "conv_dim": 2, "num_cascades": 5, "dimensionality": 2, "no_dc": True,
        "keep_prediction": True, "accumulate_predictions": True,
    },
    "trainer": {"max_epochs": 20, "max_steps": -1, "accelerator": "tpu", "devices": -1, "precision": "highest",
                "gradient_clip_val": 0.0, "log_every_n_steps": 50},
    "exp_manager": {"exp_dir": "output", "name": "cirim", "create_tensorboard_logger": True,
                    "resume_if_exists": False,
                    "checkpoint_callback_params": {"monitor": "val_loss", "mode": "min", "save_top_k": 3},
                    "ema": {"enable": False, "decay": 0.999}},
}
# the launch runs: overrides on top of LAUNCH_CFG (JSON values, which the
# port's config reader parses without PyYAML), the phantom roots (with
# poisson2d masks drawn beforehand, or none: the transform draws its 1D masks)
# and phase 8's run whose launches per step (less the SENSE init) a step takes
_DS_KEYS = ("train_ds", "validation_ds", "test_ds")
L_RUNS = {
    "launch_f32_full": ([], "phantom/poisson2d", "train_f32_full"),
    "launch_f32_psf1d": ([f"model.{k}.mask_args.{a}={v}" for k in _DS_KEYS
                          for a, v in (("type", '"equispaced1d"'), ("accelerations", "[4]"),
                                       ("center_fractions", "[0.08]"))], "phantom/1d", "train_f32_psf1d"),
}
L_STEPS = 24  # training steps of a launch run (trainer.limit_train_batches): half of D2's 48 slices
L_VAL_LIMIT = 2  # validation batches of the resumed runs


# Z, Z8: the zoo's models as projects/reconstruction/conf's base_{zf,pg,unet,
# resnet}_train.yaml configure them (uncentered backward FFT, SENSE; the
# model keys, tests/test_torch_port_zoo.py holds them against the YAMLs), on
# bench_data at 15 coils, 320x320, with random weights from a seed
ZOO_COMMON = {"coil_combination_method": "SENSE", "use_sens_net": False, "fft_centered": False,
              "fft_normalization": "backward", "spatial_dims": [-2, -1], "coil_dim": 1}
ZOO_CFGS = {
    "zf": {"model_name": "ZF"},
    "pg": {"model_name": "ProximalGradient", "conjugate_gradient_iterations": 10, "penalization_weight": 0.05},
    "unet": {"model_name": "UNet", "channels": 64, "pooling_layers": 4, "padding_size": 11, "normalize": True,
             "dropout_probability": 0.0},
    "resnet": {"model_name": "ResNet", "unrolled_iterations": 10, "residual_blocks": 15, "channels": 64,
               "regularization_factor": 0.1, "conjugate_gradient_dc": True, "conjugate_gradient_iterations": 10,
               "penalization_weight": 0.05},
}
# launches per forward: the SENSE zero-filled image is sens_reduce (uncentered,
# no mask: the inverse FFT and one reduce); a CG iteration applies the normal
# operator once (expand, mask, reduce): PG 10 iterations, ResNet 10 unrolls x 10
ZOO_PER_FORWARD = {
    "zf": {"k2_reduce": 1},
    "unet": {"k2_reduce": 1},
    "pg": {"k2_reduce": 11, "k2_expand": 10, "k2_mask": 10},
    "resnet": {"k2_reduce": 101, "k2_expand": 100, "k2_mask": 100},
}
# launches per training step: the forward's, and the normal operator once more
# in the backward of every call whose input takes a gradient: all 100 of
# ResNet's; PG's but the first (its input, the zero-filled image, takes none;
# only mu does). y takes no gradient, so the zero-filled image has no backward
ZOO_PER_STEP = {
    "train_zf": {"k2_reduce": 1},
    "train_unet": {"k2_reduce": 1},
    "train_pg": {"k2_reduce": 20, "k2_expand": 19, "k2_mask": 19},
    "train_resnet": {"k2_reduce": 201, "k2_expand": 200, "k2_mask": 200},
}
ZOO_TRAIN_BATCH = {"zf": 8, "unet": 8, "pg": 8, "resnet": 1}  # base_resnet_train.yaml trains at batch 1
ZOO_SEED = 0  # the generator of the zoo's random weights

# Z2: CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet and DUNet as
# projects/reconstruction/conf's base_{name}_train.yaml configure them (the
# model keys; tests/test_torch_port_zoo2.py holds them against the YAMLs),
# with ZOO_COMMON, on bench_data at 15 coils, 320x320
ZOO2_CFGS = {
    "ccnn": {"model_name": "CascadeNet", "num_cascades": 10, "hidden_channels": 64, "n_convs": 5, "batchnorm": False,
             "no_dc": False},
    "crnn": {"model_name": "CRNNet", "num_iterations": 10, "hidden_channels": 64, "n_convs": 3, "batchnorm": False,
             "no_dc": False},
    "xpdnet": {"model_name": "XPDNet", "num_iter": 2, "num_primal": 5, "num_dual": 1, "use_primal_only": True,
               "image_model_architecture": "MWCNN", "mwcnn_hidden_channels": 16, "mwcnn_num_scales": 2},
    "kikinet": {"model_name": "KIKINet", "num_iter": 2, "no_dc": False, "kspace_model_architecture": "DIDN",
                "kspace_didn_hidden_channels": 64, "kspace_didn_num_dubs": 2, "kspace_didn_num_convs_recon": 3,
                "imspace_model_architecture": "MWCNN", "image_mwcnn_hidden_channels": 16,
                "image_mwcnn_num_scales": 2},
    "lpdnet": {"model_name": "LPDNet", "num_iter": 2, "num_primal": 5, "num_dual": 5,
               "primal_model_architecture": "UNET", "primal_unet_num_filters": 16, "primal_unet_num_pool_layers": 2,
               "dual_model_architecture": "UNET", "dual_unet_num_filters": 16, "dual_unet_num_pool_layers": 2},
    "vsnet": {"model_name": "VSNet", "num_cascades": 10, "imspace_model_architecture": "CONV",
              "imspace_conv_hidden_channels": 64, "imspace_conv_n_convs": 4},
    "dunet": {"model_name": "DUNet", "num_iter": 10, "reg_model_architecture": "DIDN", "didn_hidden_channels": 64,
              "didn_num_dubs": 2, "didn_num_convs_recon": 3, "data_consistency_term": "GD",
              "data_consistency_lambda_init": 0.1},
}
# launches per forward, uncentered and unmasked unless said: a SENSE
# reduction is the inverse FFT and one reduce (masked: load, inverse FFT,
# reduce), an expansion expand and the FFT (masked: and mask). CascadeNet a
# reduction and an expansion per cascade and the SENSE prediction; CRNNet
# per iteration one of each and its prediction's reduction; XPDNet the masked
# reduction of y, then per iteration one masked expansion (primal image 0's:
# the other four reach no output) and one masked reduction; KIKINet per
# iteration two reductions and an expansion, and an expansion between
# iterations; LPDNet the masked reduction of y, then per iteration one
# masked expansion and one masked reduction; VSNet per cascade two
# reductions (the JAX package's third repeats one) and two expansions, and
# the prediction; DUNet the SENSE image, then per iteration one full_dc
# chain (expand, residual, reduce) for the GD term
ZOO2_PER_FORWARD = {
    "ccnn": {"k2_reduce": 11, "k2_expand": 10},
    "crnn": {"k2_reduce": 20, "k2_expand": 10},
    "xpdnet": {"k2_load": 3, "k2_reduce": 3, "k2_expand": 2, "k2_mask": 2},
    "kikinet": {"k2_reduce": 4, "k2_expand": 3},
    "lpdnet": {"k2_load": 3, "k2_reduce": 3, "k2_expand": 2, "k2_mask": 2},
    "vsnet": {"k2_reduce": 21, "k2_expand": 20},
    "dunet": {"k2_reduce": 11, "k2_expand": 10, "k2_residual": 10},
}
# launches per training step: the forward's, and the adjoint of every call
# whose input takes a gradient (a reduction's backward is expand, FFT and,
# masked, mask; an expansion's the inverse FFT and reduce, masked with load
# first; full_dc's expand, mask, reduce_acc). Inputs that take none: y's
# reductions, CascadeNet's and VSNet's first cascade's reduction (of y),
# CRNNet's first iteration's, and XPDNet's first iteration whole (its
# buffers are y's); LPDNet's first iteration's expansion (of y's image)
ZOO2_PER_STEP = {
    "train_ccnn": {"k2_reduce": 21, "k2_expand": 20},
    "train_crnn": {"k2_reduce": 30, "k2_expand": 29},
    "train_xpdnet": {"k2_load": 4, "k2_reduce": 4, "k2_expand": 3, "k2_mask": 3},
    "train_kikinet": {"k2_reduce": 7, "k2_expand": 7},
    "train_lpdnet": {"k2_load": 4, "k2_reduce": 4, "k2_expand": 4, "k2_mask": 4},
    "train_vsnet": {"k2_reduce": 41, "k2_expand": 40},
    "train_dunet": {"k2_reduce": 11, "k2_expand": 20, "k2_residual": 10, "k2_mask": 10, "k2_reduce_acc": 10},
}
ZOO2_TRAIN_BATCH = 1  # every base_*_train.yaml of Z2 trains at batch 1
ZOO2_BIG_TRAIN = "ccnn"  # also trained at B=8
# the BatchNorm check: CascadeNet with live statistics, cut to 4 cascades, B=2
ZOO2_BN_CFG = {**ZOO2_CFGS["ccnn"], "num_cascades": 4, "batchnorm": True, "train_batch_stats": True}
ZOO2_BN_BATCH = 2

# S: projects/unselfsupervised/conf/base_ssdu_train.yaml and base_n2r_train.yaml
# as written (tests/test_torch_port_selfsup.py holds them equal to the YAMLs)
_S_DS = {
    "data_path": "???", "sense_path": None, "mask_path": None, "dataset_format": "stanford_knees",
    "challenge": "multicoil", "batch_size": 1, "sample_rate": 1, "volume_sample_rate": None, "consecutive_slices": 1,
    "data_saved_per_slice": False, "complex_data": True, "apply_prewhitening": False, "apply_gcc": False,
    "coil_combination_method": "SENSE", "dimensionality": 2,
    "mask_args": {"type": "poisson2d", "accelerations": [12], "center_fractions": [0.7], "scale": 0.02,
                  "shift_mask": False, "use_seed": True},
    "half_scan_percentage": 0.0, "remask": False, "ssdu": False, "crop_size": None, "kspace_crop": False,
    "crop_before_masking": True, "kspace_zero_filling_size": None, "normalize_inputs": True, "max_norm": True,
    "fft_centered": True, "fft_normalization": "ortho", "spatial_dims": [-2, -1], "coil_dim": 1, "use_seed": True,
    "shuffle": True, "drop_last": False,
}
_S_SSDU_DS = {**_S_DS, "ssdu": True, "ssdu_mask_type": "Uniform", "ssdu_rho": 0.4, "ssdu_acs_block_size": [4, 4],
              "ssdu_gaussian_std_scaling_factor": 4.0, "ssdu_outer_kspace_fraction": 0.0}
_S_N2R_DS = {**_S_DS, "n2r": True, "n2r_supervised_rate": 0.2, "n2r_probability": 0.2, "n2r_std_devs": [0.0, 0.0],
             "n2r_rhos": [0.4, 0.4], "n2r_use_mask": True}


def _val(ds, **kw):
    return {**ds, "mask_args": {**ds["mask_args"], "use_seed": False}, "use_seed": False, "shuffle": False, **kw}


def _s_cfg(name, model, train_ds, val_ds):
    return {
        "pretrained": False, "checkpoint": None, "mode": "train",
        "model": {**model, "train_ds": train_ds, "validation_ds": val_ds,
                  "optim": {"name": "adam", "lr": 0.001, "betas": [0.9, 0.999], "weight_decay": 0.0001,
                            "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}},
        "trainer": {"max_epochs": 20, "max_steps": -1, "accelerator": "tpu", "devices": -1, "precision": "highest",
                    "gradient_clip_val": 0.0, "log_every_n_steps": 50},
        "exp_manager": {"exp_dir": "output", "name": name, "create_tensorboard_logger": True,
                        "resume_if_exists": False,
                        "checkpoint_callback_params": {"monitor": "val_loss", "mode": "min", "save_top_k": 3},
                        "ema": {"enable": False, "decay": 0.999}},
    }


_S_MODEL = {"dimensionality": 2, "coil_combination_method": "SENSE", "fft_centered": True,
            "fft_normalization": "ortho", "spatial_dims": [-2, -1], "coil_dim": 1, "use_sens_net": False,
            "consecutive_slices": 1, "log_images": True, "train_loss_fn": "l1", "val_loss_fn": "l1"}
SSDU_CFG = _s_cfg("ssdu_resnet", {
    "model_name": "ResNet", "unrolled_iterations": 5, "residual_blocks": 5, "channels": 64,
    "regularization_factor": 1.0, "penalization_weight": 0.0, "conjugate_gradient_dc": True,
    "conjugate_gradient_iterations": 10, **_S_MODEL, "ssdu": True, "n2r": False, "kspace_reconstruction_loss": True,
    "reconstruction_loss_regularization_factor": 1.0}, _S_SSDU_DS, _val(_S_SSDU_DS))
N2R_CFG = _s_cfg("n2r_unet", {
    "model_name": "UNet", "channels": 32, "pooling_layers": 4, "in_channels": 2, "out_channels": 2,
    "padding_size": 11, "dropout": 0.0, "normalize": True, "norm_groups": 2, **_S_MODEL, "ssdu": False, "n2r": True,
    "kspace_reconstruction_loss": False, "reconstruction_loss_regularization_factor": 0.9,
    "n2r_loss_regularization_factor": 0.1}, _S_N2R_DS, _val(_S_N2R_DS, n2r_supervised_rate=0.0))
# S's phantom volumes (15 coils, 320x320; each with the poisson2d mask the
# train_ds masker draws for it, premade): 3 training volumes, so that the
# dataset's rule picks round(0.2 x 3) = 1 of them as n2r-supervised, and 1
# validation volume; a run takes S_STEPS training steps and S_VAL_LIMIT
# validation batches
S_TRAIN_VOLUMES, S_SLICES, S_VAL_SLICES, S_STEPS, S_VAL_LIMIT = 3, 2, 2, 6, 2
# launches per training step of the S runs (centered FFT: the zero-filled
# image loads k-space to FFT order; ResNet 5 unrolls x 10 CG iterations, each
# normal operator forward and backward); UNet's second forward (the
# consistency term) reduces once more
S_PER_STEP = {
    "ssdu_resnet": {"k2_load": 1, "k2_reduce": 101, "k2_expand": 100, "k2_mask": 100},
    "n2r_unet_supervised": {"k2_load": 1, "k2_reduce": 1},
    "n2r_unet_consistency": {"k2_load": 2, "k2_reduce": 2},
}


def fed_per_step(phase8_run: str) -> dict:
    """Launches per training step fed by the loader: those of phase 8's run
    but the SENSE init's (one ``k2_load`` and one ``k2_reduce``). The loader's
    batches carry the transform's zero-filled ``initial_prediction``, and a
    given initial prediction starts the first cascade in its place."""
    per = {k: v - (k in ("k2_load", "k2_reduce")) for k, v in PER_STEP[phase8_run].items()}
    return {k: v for k, v in per.items() if v}


def data_per_step(run: str) -> dict:
    """Launches per training step of a D2 run (:func:`fed_per_step`)."""
    return fed_per_step(D2_RUNS[run][3])

# kernel against plain version (rtol, atol as a share of the largest
# magnitude). float32: the kernel and cuBLAS/cuDNN in full float32 accumulate
# in other orders; rtol 1e-4 with atol 1e-4 of the largest magnitude.
# bfloat16: each kernel is held against its plain version computed in float32
# on the same bf16 operands and rounded once at the end (rounded_once). K3
# differs from that by the float32 summation order and the final rounding
# only, at most one bf16 ulp (2^-7 relative): rtol 1e-2, atol 1e-3 of the
# largest magnitude. K1 also rounds s_c*eta and Ci to bf16 where it stages
# them (unit roundoff 2^-9 on each of the C*W terms of an output's sum): rtol
# 1e-2, atol 1e-2 of the largest magnitude. Readings on an H100 80GB HBM3 that
# these limits were set from, max abs error at the largest magnitude: K1 0.031
# at 7.09 (flagship, B=2) and 0.016 at 7.44 (main path, B=8); K3 0.016 at 6.72
# and 0.0039 at 1.82 (one bf16 ulp at each).
F32, K1_BF16, K3_BF16 = (1e-4, 1e-4), (1e-2, 1e-2), (1e-2, 1e-3)
# K2's mask stage is one real-times-complex product, its plain version's: equal
EXACT = (0.0, 0.0)
# a bf16 model on the card against the same bf16 model on the CPU: the two
# round at other places (cuDNN's and the CPU's bf16 convolutions, K1-bf16's
# staging): rtol 3e-2 and atol 3e-2 of the largest magnitude
# (tests/test_torch_port_vn.py's bf16 limits), and relative l2 5e-2, the JAX
# package's own bf16 bound (tests/test_models_recon.py:238)
BF16_MODEL, BF16_REL_L2 = (3e-2, 3e-2), 5e-2


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


def vn_cfg(**overrides):
    """bench.py's e2evn_cfg (the JAX bench's E2EVN: bf16 compute, psf1d DC in
    bf16, centered ortho FFT), as a plain dict."""
    cfg = {
        "model_name": "VN",
        "num_cascades": VN_CASCADES,
        "channels": VN_CHANS,
        "pooling_layers": VN_POOLS,
        "fft_centered": True,
        "fft_normalization": "ortho",
        "compute_dtype": "bfloat16",
        "dc_mode": "psf1d",
        "dc_dtype": "bfloat16",
    }
    cfg.update(overrides)
    return cfg


def vn_layout_tree(cfg, seed, gain=1.0):
    """Random VarNet weights drawn with numpy in the flax tree layout of
    mridc_tpu (``_VarNetBlock_{i}/NormUnet_0/Unet_0``; both dc_modes share
    it): every kernel normal with variance 1 / fan-in (flax's lecun normal;
    fan-in kH * kW * in, for the transpose convs too), zero bias, dc_weight 1.
    ``gain`` scales each NormUnet's final 1x1 conv kernel: at 1 a random
    cascade amplifies a perturbation of its input several times over, so 8 of
    them compound float32 rounding into the output; a small gain keeps each
    cascade's regulariser a small correction to its DC step."""
    rng = np.random.default_rng(seed)
    chans, pools = cfg.get("channels", 18), cfg.get("pooling_layers", 4)

    def kernel(k, cin, cout, scale=1.0):
        return (rng.standard_normal((k, k, cin, cout)) * scale / np.sqrt(k * k * cin)).astype(np.float32)

    def block(cin, cout):
        return {"Conv_0": {"kernel": kernel(3, cin, cout)}, "Conv_1": {"kernel": kernel(3, cout, cout)}}

    tree = {}
    for i in range(cfg.get("num_cascades", 8)):
        unet, ch, k = {}, chans, 0
        unet["ConvBlock_0"] = block(2, ch)
        for k in range(1, pools):
            unet[f"ConvBlock_{k}"] = block(ch, ch * 2)
            ch *= 2
        unet[f"ConvBlock_{pools}"] = block(ch, ch * 2)
        for j in range(pools):
            unet[f"TransposeConvBlock_{j}"] = {"ConvTranspose_0": {"kernel": kernel(2, ch * 2, ch)}}
            unet[f"ConvBlock_{pools + 1 + j}"] = block(ch * 2, ch)
            ch = ch // 2 if j < pools - 1 else ch
        unet["Conv_0"] = {"kernel": kernel(1, ch, 2, gain), "bias": np.zeros(2, np.float32)}
        tree[f"_VarNetBlock_{i}"] = {"dc_weight": np.ones(1, np.float32), "NormUnet_0": {"Unet_0": unet}}
    return {"params": tree}


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


def off_by_one_pixel(x):
    """A contiguous copy of float32 ``x`` whose data starts one complex pixel
    (8 bytes) past a 16-byte boundary: a view no 16-byte access takes."""
    import torch

    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    return buf[2:].view(x.shape).copy_(x)


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
        mag = losses._mag(x) if x.shape[-1] == 2 else x.abs()
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


def check_tf32_rule(dev, card) -> None:
    import torch
    import torch.nn.functional as F

    from mridc_tpu_torch.nn.layers import Conv

    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN's TF32 flag is off: this check needs PyTorch's default (on)")
    g = torch.Generator().manual_seed(7)
    x64 = torch.randn(2, 18, 160, 160, generator=g, dtype=torch.float64)
    gy64 = torch.randn(2, 36, 160, 160, generator=g, dtype=torch.float64)
    conv = Conv(18, 36, 3, use_bias=False)
    conv.reset_parameters(g)
    w64 = conv.weight.detach().double().requires_grad_(True)
    xr = x64.clone().requires_grad_(True)
    F.conv2d(xr, w64, padding=1).backward(gy64)
    want = (F.conv2d(x64, w64.detach(), padding=1), xr.grad, w64.grad)

    def run(fn):
        x = x64.float().to(dev).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        out = fn(x)
        out.backward(gy64.float().to(dev).contiguous(memory_format=torch.channels_last))
        return out, x.grad

    conv = conv.to(dev, memory_format=torch.channels_last)
    port = run(conv) + (conv.weight.grad,)
    wl = conv.weight.detach().clone().requires_grad_(True)
    lib = run(lambda x: F.conv2d(x, wl, padding=1)) + (wl.grad,)
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the port's convolution left cuDNN's TF32 flag off")
    for part, got, lib_got, ref in zip(("out", "dx", "dw"), port, lib, want):
        lib_err = float((lib_got.detach().double().cpu() - ref).abs().max() / ref.abs().max())
        check(f"tf32_rule[{part}]", got.double().cpu(), ref, 1e-4, 1e-5,
              note=f"PyTorch's conv under the same flag: max abs err / max {lib_err:.3g}")


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
    if "anonymous namespace" in n and "reduce_acc_kernel" in n:
        return "K2 backward stages"
    if "anonymous namespace" in n and any(k in n for k in ("expand_kernel", "residual_kernel", "load_kernel",
                                                            "reduce_kernel", "mask_kernel")):
        return "K2 stages"
    if "batch_norm" in n:
        return "BatchNorm"
    if "welford" in n:
        return "InstanceNorm statistics"
    if "avg_pool" in n or "reflection_pad" in n:
        return "pooling and reflect pad"
    if any(k in n for k in ("dse::", "fft2d_", "pointwise_mult_and_sum_complex")):  # cuDNN's FFT convolutions
        return "conv and GEMM (cuDNN, cuBLAS)"
    if "fft" in n:
        return "cuFFT"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "sm90", "cutlass", "nhwc", "nchw", "wgrad",
                            "dgrad")):
        return "conv and GEMM (cuDNN, cuBLAS)"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer (Adam)"
    if "dot_kernel" in n or "reduce_1block" in n:
        return "dot products (cuBLAS)"
    if "reduce_kernel" in n:
        return "reductions (ATen)"
    return "elementwise: pad, cast, add, copy"


def trace_call(fn, ms_per_call):
    """Device time and kernel launches of one call of ``fn`` (a forward or a
    training step) by kernel, by layer and by ATen op, from torch.profiler's
    CUDA kernel events (CUPTI), beside the unprofiled wall time of a call;
    ``copy_launches``/``copy_ms``: ATen's copy kernels among them (``copy_``,
    ``contiguous``, ``to``: a mask densified at every K2 stage would show
    there, one a stage)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            calls[e.name] = calls.get(e.name, 0) + 1
    by_cat, launches = {}, {}
    for name, ms in by_name.items():
        by_cat[kernel_category(name)] = by_cat.get(kernel_category(name), 0.0) + ms
        launches[kernel_category(name)] = launches.get(kernel_category(name), 0) + calls[name]
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    copies = [n for n in by_name if "direct_copy_kernel" in n]
    return {"device_ms": busy, "wall_ms": ms_per_call,
            "copy_launches": sum(calls[n] for n in copies), "copy_ms": sum(by_name[n] for n in copies),
            "device_busy_share": busy / ms_per_call if ms_per_call else None,
            "by_layer_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "by_layer_launches": dict(sorted(launches.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[name[:120], ms] for name, ms in top], "by_op_ms": op_device_ms(prof)}


def traced_kernel_ms(fn, name_part=None, calls=20):
    """Device time of the one kernel a call of ``fn`` launches whose name
    holds ``name_part`` (every kernel when None), in a torch.profiler trace of
    ``calls`` back-to-back calls, as {"traced_device_ms", "traced_kernels"}:
    the mean over the kernel events the trace kept (the profiler at times
    drops some; ``traced_kernels`` below ``calls`` shows it). CUDA events
    around the same calls (:func:`time_ms`) also hold any gap the host leaves
    between kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and (name_part is None or name_part in e.name)]
    return {"traced_device_ms": sum(us) / len(us) / 1e3 if us else None, "traced_kernels": len(us)}


def check_all(name, got: dict, want: dict, rtol, atol_rel, note=""):
    """:func:`check` over matching entries of two dicts of tensors (atol
    ``atol_rel`` x each entry's own largest magnitude), emitted as one line
    with the worst entry; raises on any entry outside its limits."""
    import torch

    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: entries {sorted(got)} != {sorted(want)}")
    worst, bad = None, []
    for k in want:
        g, w = got[k].detach().float(), want[k].detach().float()
        if w.numel() == 0:
            continue
        atol = atol_rel * float(w.abs().max())
        err = float((g - w).abs().max())
        ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=rtol, atol=atol)
        lim = atol + rtol * w.abs()
        share = float(torch.where(lim > 0, (g - w).abs() / lim.clamp(min=1e-30),
                                  torch.where(g == w, 0.0, float("inf"))).max())
        if worst is None or share > worst[1]:
            worst = (k, share, err, atol)
        if not ok:
            bad.append(k)
    worst = worst or ("", 0.0, 0.0, 0.0)
    rec = {"check": name, "entries": len(want), "worst": worst[0], "worst_err_over_limit": worst[1],
           "worst_max_abs_err": worst[2], "worst_atol": worst[3], "rtol": rtol, "ok": not bad}
    if note:
        rec["note"] = note
    emit(rec)
    if bad:
        raise AssertionError(f"{name}: outside the limits: {bad}")


def cosine(a, b) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def varnet_phases(dev, card, rows) -> None:
    """Phases V1-V4, E2EVN/VarNet (bench.py:e2evn_cfg at full width); see the
    module docstring."""
    import torch

    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.kernels import binding
    from mridc_tpu_torch.kernels import k1_psf1d_dc as k1mod
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.train.losses import process_reconstruction_loss
    from mridc_tpu_torch.train.trainer import Trainer
    from mridc_tpu_torch.utils.params import varnet_params_from_jax

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731

    def flat_grads(model):
        return torch.cat([p.grad.flatten().double() for _, p in sorted(model.named_parameters())])

    # V1. a small VarNet (2 cascades, 8 channels, 2 pools, 4 coils, weights at
    # gain 1 as the CPU tests have them) on the card against the same weights
    # on the CPU: the forward, then one training step through Trainer (loss,
    # every gradient, the parameters after one Adam step). float32: the
    # forward and the loss at phase 4's limits; each parameter's gradient at
    # relative l2 2e-2; the parameters after Adam at phase 7's limits where
    # |g| > 2e-2 x max. The gradients cannot be held elementwise: a ~1e-6
    # change of y (the card's prediction lies ~1e-6 from the CPU's) flips a
    # LeakyReLU kink now and then, and one flip moved a parameter's gradient
    # on the CPU by up to 0.46% in relative l2 and 1.85% of its max in one
    # element (5 perturbations a configuration; with the slopes set to 1,
    # 7e-6). bf16 (compute, and the psf1d DC) against the CPU's
    # bf16: the forward at BF16_MODEL and BF16_REL_L2, the loss at rtol 3e-2,
    # and the whole gradient at cosine >= 0.9: bf16 gradients of random
    # NormUnets are noisy (the CPU's bf16 against its float32 read cosine
    # 0.964-0.982 on this model), and a wrong index or operand reads near 0
    small = vn_cfg(num_cascades=2, channels=8, pooling_layers=2)
    for b, h, w in ((2, 64, 64), (2, 37, 45)):
        ys, ss, ms = bench_data(b, 4, h, w, seed=12)
        batch = {"masked_kspace": ys, "sensitivity_maps": ss, "mask": ms, "target": train_target(b, h, w)}
        for centered, norm in ((True, "ortho"), (False, "backward")):
            for mode in ("psf1d", "full"):
                for dt in ("f32", "bf16"):
                    cfg = dict(small, dc_mode=mode, fft_centered=centered, fft_normalization=norm,
                               compute_dtype="bfloat16" if dt == "bf16" else None,
                               dc_dtype="bfloat16" if dt == "bf16" and mode == "psf1d" else None)
                    state = varnet_params_from_jax(vn_layout_tree(cfg, seed=13))
                    tag = f"{mode}/{dt}/{'c' if centered else 'u'}-{norm}/{h}x{w}"
                    res = {}
                    for where in ("card", "cpu"):
                        model = build_model(cfg, device=dev if where == "card" else "cpu")
                        model.load_state_dict(state)
                        with torch.inference_mode():
                            pred = model(*(torch.from_numpy(a).to(model.cascades[0].dc_weight.device)
                                           for a in (ys, ss, ms))).prediction.cpu()
                        trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG,
                                          device=dev if where == "card" else "cpu")
                        loss = float(trainer.training_batch(batch)["loss"])
                        params = dict(model.named_parameters())
                        res[where] = (pred, loss, {k: p.grad.cpu() for k, p in params.items()},
                                      {k: p.detach().cpu() for k, p in params.items()}, flat_grads(model).cpu())
                    (pd, ld, gd, qd, fd), (pc, lc, gc, qc, fc) = res["card"], res["cpu"]
                    if dt == "f32":
                        check(f"vn_small[{tag}]", pd, pc, 2e-3, 2e-4)
                        check(f"vn_small_train_loss[{tag}]", torch.tensor(ld), torch.tensor(lc), 2e-3, 2e-4)
                        rel = {k: float((gd[k] - gc[k]).norm() / gc[k].norm()) if float(gc[k].norm()) > 0
                               else float(gd[k].norm()) for k in gc}
                        worst = max(rel, key=rel.get)
                        emit({"check": f"vn_small_grads[{tag}]", "entries": len(rel), "worst": worst,
                              "max_rel_l2": rel[worst], "limit": 2e-2, "ok": rel[worst] <= 2e-2})
                        if rel[worst] > 2e-2:
                            raise AssertionError(f"vn_small_grads[{tag}]: {worst} at relative l2 {rel[worst]}")
                        sure = {k: gc[k].abs() > 2e-2 * float(gc[k].abs().max()) for k in gc}
                        check_all(f"vn_small_params_after_adam[{tag}]",
                                  {k: qd[k][sure[k]] for k in qc}, {k: qc[k][sure[k]] for k in qc}, 2e-3, 2e-4)
                        continue
                    rel = float((pd - pc).norm() / pc.norm())
                    check(f"vn_small[{tag}]", pd, pc, *BF16_MODEL, note=f"rel l2 {rel:.3g} (limit {BF16_REL_L2})")
                    check(f"vn_small_train_loss[{tag}]", torch.tensor(ld), torch.tensor(lc), 3e-2, 0.0)
                    cos = cosine(fd, fc)
                    emit({"check": f"vn_small_grad_cosine[{tag}]", "cosine": cos, "limit": 0.9,
                          "max_rel_l2_per_parameter": max(float((gd[k] - gc[k]).norm() / gc[k].norm())
                                                          for k in gc if float(gc[k].norm()) > 0)})
                    if not (rel <= BF16_REL_L2 and cos >= 0.9):
                        raise AssertionError(f"vn_small[{tag}]: bf16 card and CPU disagree: rel l2 {rel}, "
                                             f"gradient cosine {cos}")

    # V2. serving at full width: B=8, the flagship's data; the launch counters
    # are zeroed before each run and read after it
    state = varnet_params_from_jax(vn_layout_tree(vn_cfg(), seed=0, gain=VN_GAIN))
    y, sens, mask = (t(a) for a in bench_data(BATCH, COILS, H, W))
    runs = {"vn_bf16_psf1d": vn_cfg(), "vn_f32_psf1d": vn_cfg(compute_dtype=None, dc_dtype=None),
            "vn_f32_full": vn_cfg(compute_dtype=None, dc_dtype=None, dc_mode="full")}
    vn_counts = {k: 0 for k in binding.LAUNCHES}
    models, preds, recs = {}, {}, []

    def serve(name, model, yb, sb, mb):
        b = yb.shape[0]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            for _ in range(WARMUP):
                model(yb, sb, mb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                pred = model(yb, sb, mb).prediction
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        delta = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {k: v * (WARMUP + ITERS) for k, v in VN_PER_FORWARD[name].items()}
        rec = {"run": name, "batch": b, "forwards_timed": ITERS, "seconds": dt, "slices_per_s": ITERS * b / dt,
               "ms_per_forward": dt / ITERS * 1e3,
               "launches_per_forward": {k: v / (WARMUP + ITERS) for k, v in delta.items()}, "card": card}
        emit(rec)
        if delta != want:
            raise AssertionError(f"{name} at B={b}: launches {delta} != expected {want}")
        if not bool(torch.isfinite(pred).all()) or tuple(pred.shape) != (b, H, W, 2):
            raise AssertionError(f"{name}: prediction not finite or of shape {tuple(pred.shape)}")
        for k, v in delta.items():
            vn_counts[k] += v
        return rec, pred.float()

    for name, cfg in runs.items():
        models[name] = build_model(cfg, device=dev)
        models[name].load_state_dict(state)
        rec, preds[name] = serve(name, models[name], y, sens, mask)
        recs.append(rec)
    ref = preds["vn_f32_psf1d"]
    limits = {"vn_bf16_psf1d": 5e-2, "vn_f32_full": 1e-4}
    rel = {k: float((preds[k] - ref).norm() / ref.norm()) for k in limits}
    sense0 = kernels.sens_reduce(y, sens, None, True, "ortho")
    # the growth of a perturbation per cascade: y x (1 + 1e-4 noise) through
    # vn_f32_psf1d, the change of each cascade's NormUnet input and of the output
    inputs = []
    hooks = [blk.model.register_forward_pre_hook(lambda mod, a: inputs.append(a[0].clone()))
             for blk in models["vn_f32_psf1d"].cascades]
    noise = torch.randn(y.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    with torch.inference_mode():
        p0 = models["vn_f32_psf1d"](y, sens, mask).prediction
        p1 = models["vn_f32_psf1d"](y * (1 + 1e-4 * noise), sens, mask).prediction
    for hk in hooks:
        hk.remove()
    n = len(inputs) // 2
    d = [float((a - b).norm()) for a, b in zip(inputs[n:], inputs[:n])] + [float((p1 - p0).norm())]
    growth = [d[i + 1] / d[i] for i in range(n)]
    rec = {"check": "vn_agreement", "rel_l2_vn_bf16_psf1d_vs_vn_f32_psf1d": rel["vn_bf16_psf1d"],
           "rel_l2_vn_f32_full_vs_vn_f32_psf1d": rel["vn_f32_full"],
           "rel_l2_vn_f32_psf1d_vs_sense_init": float((ref - sense0).norm() / sense0.norm()),
           "perturbation_growth_per_cascade": growth, "gain": VN_GAIN, "limits": limits, "card": card}
    emit(rec)
    if not all(rel[k] <= limits[k] for k in limits):
        raise AssertionError(f"VarNet predictions disagree: {rec}")
    del p0, p1, noise, inputs, preds

    # the operands of one K1 call of vn_bf16_psf1d (V4)
    captured: dict = {}
    orig = k1mod.psf1d_dc

    def grab(*a):
        captured.setdefault("psf1d_normal", tuple(x.detach().clone() if torch.is_tensor(x) else x for x in a))
        return orig(*a)

    k1mod.psf1d_dc = grab
    try:
        with torch.inference_mode():
            models["vn_bf16_psf1d"](y, sens, mask)
    finally:
        k1mod.psf1d_dc = orig

    # V2b. where a forward's device time goes (one traced forward per run)
    for rec in recs:
        model = models[rec["run"]]
        with torch.inference_mode():
            emit({"trace": rec["run"], **trace_call(lambda: model(y, sens, mask), rec["ms_per_forward"]), "card": card})

    # bench.py's E2EVN configuration at B=32 (timing; its launches asserted)
    yb, sb, mb = (t(a) for a in bench_data(VN_BIG_BATCH, COILS, H, W))
    serve("vn_bf16_psf1d", models["vn_bf16_psf1d"], yb, sb, mb)
    del models, yb, sb, mb
    torch.cuda.empty_cache()

    # V3. training at full width through Trainer (Adam under
    # InverseSquareRootAnnealing, base_vn_train.yaml's optim block), B=8.
    # First the first-step gradients on the same slices (vn_f32_psf1d the
    # reference): float32 full against psf1d at relative l2 1e-3, beside how
    # far vn_f32_psf1d's own gradient moves when y moves by 1e-6 x noise (the
    # gradient of these random weights is far more sensitive than the
    # prediction: LeakyReLU kinks, V1); bf16 at
    # cosine >= 0.9, since the JAX package's own bf16 first-step gradient lies
    # at cosine 0.974 from its float32 one on these weights (CPU, 8 coils,
    # 128 x 128, gain 0.05; 0.963 at gain 0.1): bf16 backward passes through
    # 8 x 20 random NormUnet layers
    target8 = t(train_target(BATCH, H, W))
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target8}
    train_runs = {"train_vn_bf16_psf1d": runs["vn_bf16_psf1d"], "train_vn_f32_full": runs["vn_f32_full"]}
    first = {}
    noise = torch.randn(y.shape, generator=torch.Generator().manual_seed(4)).to(dev)
    grad_runs = [(name, cfg, y) for name, cfg in train_runs.items()]
    grad_runs += [("vn_f32_psf1d", runs["vn_f32_psf1d"], y), ("vn_f32_psf1d_y_moved", runs["vn_f32_psf1d"],
                                                              y * (1 + 1e-6 * noise))]
    for name, cfg, yn in grad_runs:
        model = build_model(cfg, device=dev)
        model.load_state_dict(state)
        process_reconstruction_loss(model(yn, sens, mask, train=True), target8, "l1").backward()
        first[name] = flat_grads(model)
        del model
    ref_g = first["vn_f32_psf1d"]
    moved = float((first["vn_f32_psf1d_y_moved"] - ref_g).norm() / ref_g.norm())
    readings = {"rel_l2_train_vn_f32_full_vs_vn_f32_psf1d": float((first["train_vn_f32_full"] - ref_g).norm()
                                                                  / ref_g.norm()),
                "cosine_train_vn_bf16_psf1d_vs_vn_f32_psf1d": cosine(first["train_vn_bf16_psf1d"], ref_g)}
    grad_limits = {"rel_l2_train_vn_f32_full_vs_vn_f32_psf1d": ("<=", 1e-3),
                   "cosine_train_vn_bf16_psf1d_vs_vn_f32_psf1d": (">=", 0.9)}
    rec = {"check": "vn_train_first_step_gradients", "batch": BATCH, **readings,
           "limits": {k: f"{op} {v}" for k, (op, v) in grad_limits.items()},
           "rel_l2_vn_f32_psf1d_y_moved_1e-6": moved,
           "gain": VN_GAIN, "card": card}
    emit(rec)
    if not all(readings[k] <= v if op == "<=" else readings[k] >= v for k, (op, v) in grad_limits.items()):
        raise AssertionError(f"VarNet first-step gradients disagree: {rec}")
    del first, ref_g, noise

    def capturing(fname):
        orig_fn = getattr(k2, fname)

        def wrapped(*args, **kw):
            captured.setdefault(fname, (tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args),
                                        {k: v.detach().clone() if torch.is_tensor(v) else v for k, v in kw.items()}))
            return orig_fn(*args, **kw)

        setattr(k2, fname, wrapped)
        return lambda: setattr(k2, fname, orig_fn)

    vn_train_counts = {k: 0 for k in binding.LAUNCHES}
    for name, cfg in train_runs.items():
        model = build_model(cfg, device=dev)
        model.load_state_dict(state)
        trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=dev)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        for _ in range(TRAIN_WARMUP):
            trainer.training_batch(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            metrics = trainer.training_batch(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        delta = {k: v for k, v in kernels.launch_counts().items() if v}
        steps = TRAIN_WARMUP + TRAIN_ITERS
        want = {k: v * steps for k, v in VN_PER_STEP[name].items()}
        moved = max(float((p.detach() - before[k]).abs().max()) for k, p in model.named_parameters())
        rec = {"run": name, "batch": BATCH, "steps_timed": TRAIN_ITERS, "seconds": dt,
               "slices_per_s": TRAIN_ITERS * BATCH / dt, "ms_per_step": dt / TRAIN_ITERS * 1e3,
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
               "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "max_param_change": moved, "launches_per_step": {k: v / steps for k, v in delta.items()}, "card": card}
        emit(rec)
        if delta != want:
            raise AssertionError(f"{name}: launches {delta} != expected {want}")
        if not np.isfinite(rec["loss"]) or not moved > 0:
            raise AssertionError(f"{name}: loss {rec['loss']} not finite or parameters unchanged ({moved})")
        for k, v in delta.items():
            vn_train_counts[k] += v
        emit({"trace": name, **trace_call(lambda: trainer.training_batch(batch), rec["ms_per_step"]), "card": card})
        if name == "train_vn_f32_full":
            restore = [capturing("sens_expand_bwd"), capturing("sens_reduce_bwd")]
            trainer.training_batch(batch)
            for undo in restore:
                undo()
        del trainer, model
        torch.cuda.empty_cache()

    # V4. the SENSE expansion's and reduction's backward against their plain
    # versions on one call's operands from a train_vn_f32_full step (F32), and
    # their times; the psf1d q-term on one K1 call of vn_bf16_psf1d against
    # its plain version in float32 on the same bf16 operands (K1_BF16)
    with torch.inference_mode():
        for fname in ("sens_expand_bwd", "sens_reduce_bwd"):
            args, kw = captured[fname]
            got, plain = getattr(k2, fname), getattr(k2, f"{fname}_plain")
            check(f"{fname}[train_vn_f32_full]", got(*args, **kw), plain(*args, **kw), *F32)
            emit({"function": fname, "shape": tuple(args[0].shape), "ms": time_ms(lambda: got(*args, **kw)),
                  "plain_ms": time_ms(lambda: plain(*args, **kw)),
                  "note": "K2 stages around cuFFT; launches counted under their kernels", "card": card})
        u, s_, m_, z_, _ = captured["psf1d_normal"]
        check("psf1d_normal[vn_bf16_psf1d]", k1mod.psf1d_normal(u, s_, m_, z_),
              rounded_once(k1mod.psf1d_dc_plain, u, s_, m_, z_, 1.0)[..., 2:], *K1_BF16)

    for r in rows:
        r["vn_launches"] = vn_counts.get(r["name"], 0)
        r["vn_train_launches"] = vn_train_counts.get(r["name"], 0)
    missing = [k for k in set().union(*VN_PER_FORWARD.values()) if vn_counts[k] == 0]
    missing += [k for k in set().union(*VN_PER_STEP.values()) if vn_train_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the VarNet paths: {missing}")


def phantom_volume(rng, slices, coils, h, w):
    """A fastMRI-like multicoil volume made with numpy: smooth blobs that move
    from slice to slice, smooth coil sensitivities with phase ramps (unit
    RSS), 1% complex noise. Returns (centered ortho k-space [S, C, H, W],
    maps [C, H, W], RSS target [S, H, W])."""
    from scipy import fft as sp_fft

    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = np.zeros((slices, h, w), np.complex64)
    for s in range(slices):
        cy, cx = h * (0.5 + 0.1 * np.sin(s / 3)), w * (0.5 + 0.1 * np.cos(s / 4))
        img[s] = (np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (0.06 * h * w))
                  + 0.5 * np.exp(-((yy - cy / 2) ** 2 + (xx - 1.3 * cx) ** 2) / (0.01 * h * w))
                  ) * np.exp(1j * np.pi * s / slices)
    mags = [np.exp(-((yy - h * (c + 1) / (coils + 1)) ** 2) / (h * w)) + 0.5 for c in range(coils)]
    sens = np.stack([m * np.exp(1j * 2 * np.pi * (c * xx / w + c * yy / (2 * h)) / coils)
                     for c, m in enumerate(mags)]).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(0, keepdims=True))
    coil_imgs = img[:, None] * sens[None]
    coil_imgs += (0.01 * (rng.standard_normal(coil_imgs.shape, np.float32)
                          + 1j * rng.standard_normal(coil_imgs.shape, np.float32))).astype(np.complex64)
    kspace = sp_fft.fftshift(sp_fft.fft2(sp_fft.ifftshift(coil_imgs, axes=(-2, -1)), norm="ortho", workers=-1),
                             axes=(-2, -1)).astype(np.complex64)
    rss = np.sqrt((np.abs(coil_imgs) ** 2).sum(1)).astype(np.float32)
    return kspace, sens, rss


class PhantomSource:
    """An indexable source of slices over in-memory phantom volumes
    ({file name: (k-space, maps, target, mask or None)}), with h5-like
    attributes. ``__getitem__`` does what
    ``ReconstructionMRIDataset.__getitem__`` does after its h5 read: it
    calls the transform with the slice's k-space, the maps, the volume's
    mask (None without one), no initial prediction, the target, the
    attributes (``n2r_supervised`` for the files in ``supervised``), the file
    name and the slice index."""

    def __init__(self, volumes, transform, supervised=()):
        self.volumes, self.transform, self.supervised = volumes, transform, set(supervised)
        self.examples = [(fname, s) for fname in sorted(volumes) for s in range(volumes[fname][0].shape[0])]

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        fname, s = self.examples[i]
        kspace, sens, target, mask = self.volumes[fname]
        h, w = kspace.shape[-2:]
        attrs = {"max": float(target.max()), "norm": float(np.linalg.norm(target)), "acquisition": "CORPD_FBK",
                 "padding_left": 0, "padding_right": 0, "encoding_size": (2 * h, w, 1), "recon_size": (h, w, 1),
                 "n2r_supervised": fname in self.supervised}
        return self.transform(kspace[s], sens, mask, np.array([]), target[s], attrs, fname, s)


def poisson2d_mask(ds_cfg, h, w, fname):
    """The mask the transform of ``ds_cfg`` draws itself for any slice of
    ``fname`` (its masker, seeded by the file name under ``use_seed``, at
    the shape the transform gives it), and the seconds it took; run in the
    worker processes."""
    from mridc_tpu_torch.data.factory import build_transforms

    masking = build_transforms(ds_cfg).masking
    t0 = time.perf_counter()
    mask, _ = masking.mask_func[0](np.array([1, h, w, 2]), tuple(map(ord, fname)),
                                   half_scan_percentage=masking.half_scan_percentage, scale=masking.center_scale)
    return mask, time.perf_counter() - t0


def d_volumes(prefix, n, slices, coils, h, w, seed, masks=None):
    rng = np.random.default_rng(seed)
    return {f"{prefix}_{i}.h5": (*phantom_volume(rng, slices, coils, h, w), None if masks is None else masks[i])
            for i in range(n)}


def to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()  # bf16 -> float32 is exact
    return x


def same_batches(name, got, want, on_card=(), dev=None):
    """Every leaf of each of ``got`` equal to ``want``'s bit for bit (tensors
    brought back from the card; bf16 in float32, exactly), and the
    ``on_card`` leaves lying on ``dev``."""
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} batches, {len(want)} expected")
    leaves = 0
    for b, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w):
            raise AssertionError(f"{name}[{b}]: leaves {sorted(g)} != {sorted(w)}")
        for k in w:
            gk, wk = to_host(g[k]), to_host(w[k])
            if isinstance(wk, np.ndarray):
                ok = isinstance(gk, np.ndarray) and gk.dtype == wk.dtype and gk.shape == wk.shape and np.array_equal(
                    gk.view(np.uint8), wk.view(np.uint8))
            else:
                ok = gk == wk
            if not ok:
                raise AssertionError(f"{name}[{b}]: leaf {k} differs")
            if k in on_card and not (isinstance(g[k], torch.Tensor) and g[k].device.type == dev.type):
                raise AssertionError(f"{name}[{b}]: leaf {k} is not on the card")
            leaves += 1
    emit({"check": name, "batches": len(got), "leaves_bit_identical": leaves, "ok": True})


def bf16_rounded(batch):
    """The host batch with its heavy leaves rounded to bfloat16 on the host
    (torch, to nearest even) and back to float32: what the bf16 transfer
    carries, upcast."""
    import torch

    out = dict(batch)
    for k in ("kspace", "masked_kspace", "sensitivity_maps"):
        out[k] = torch.from_numpy(batch[k]).to(torch.bfloat16).float().numpy()
    return out


def union_ms(prof) -> float:
    """Device busy time of a profiled window: the union of its CUDA events'
    intervals (kernels and copies, on every stream)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def data_phases(dev, card, rows, state, state_small, small, phase8, masks) -> dict:
    """Phases D1-D3 (see the module docstring). ``state`` and ``state_small``
    are phases 5 and 4's weights, ``small`` phase 4's configuration, ``phase8``
    phase 8's records by run, ``masks`` the futures of the poisson2d masks.
    Returns D2's records by (run, feeding mode)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.data import factory
    from mridc_tpu_torch.data.loaders import BatchLoader
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.train.trainer import Trainer

    def mask_of(key):
        return masks[key].result()[0]

    emit({"phase": "D_masks", "poisson2d_seconds_per_mask": {f"{k[0]}/{k[3]}": masks[k].result()[1] for k in masks},
          "note": "the config's masker (pure-Python dart throwing) for one slice; under use_seed each slice of a "
                  "volume redraws the same mask", "card": card})

    def source(ds, volumes):
        return PhantomSource(volumes, factory.build_transforms(ds))

    def loader(src, ds, batch, stages=()):
        """``BatchLoader`` over ``src`` wrapped in the stages of
        ``factory.build_dataloader`` that ``stages`` names."""
        cfg = {**ds, **dict(stages)}
        ldr = BatchLoader(src, batch_size=batch, shuffle=cfg["shuffle"], seed=0,
                          num_workers=int(cfg.get("num_workers", 0)), transfer_dtype=cfg.get("transfer_dtype"))
        ldr = factory.maybe_prefetch(ldr, cfg, device_keys=factory.RECON_DEVICE_PREFETCH_KEYS, device=dev)
        return factory.maybe_device_cache(ldr, cfg, exclude=("kspace",), device=dev)

    # D1. small: five ways of feeding, bit-identical on the card; then fit on
    # the card against the CPU
    t_d = time.perf_counter()
    srcs = {}
    for label, ds in (("poisson2d", TRAIN_DS), ("equispaced1d", EQUISPACED_DS)):
        vols = d_volumes("d1", D1_VOLUMES, D1_SLICES, D1_COILS, D1_HW, D1_HW, seed=21,
                         masks=[mask_of(("d1", D1_HW, D1_HW, f"d1_{i}.h5")) for i in range(D1_VOLUMES)]
                         if label == "poisson2d" else None)
        src = srcs[label] = source(ds, vols)
        plain = loader(src, ds, D1_BATCH)
        want = [list(plain), list(plain)]  # two epochs of the host loader
        on_card = factory.RECON_DEVICE_PREFETCH_KEYS
        same_batches(f"d1_prefetch_2_workers[{label}]",
                     list(loader(src, ds, D1_BATCH, {"num_workers": 2})), want[0])
        same_batches(f"d1_device_prefetch[{label}]",
                     list(loader(src, ds, D1_BATCH, {"device_prefetch": True})), want[0], on_card, dev)
        cache = loader(src, ds, D1_BATCH, {"device_cache_dataset": True})
        cache_keys = ("masked_kspace", "sensitivity_maps", "mask", "target", "initial_prediction")
        same_batches(f"d1_device_cache_epoch1[{label}]", list(cache), want[0], cache_keys, dev)
        if not cache._populated:
            raise AssertionError("d1: the device cache did not populate in one epoch")
        same_batches(f"d1_device_cache_epoch2_gathered[{label}]",
                     [{k: v for k, v in b.items() if k != "kspace"} for b in cache],
                     [{k: v for k, v in b.items() if k != "kspace"} for b in want[1]], cache_keys, dev)
        same_batches(f"d1_bf16_transfer_device_prefetch[{label}]",
                     list(loader(src, ds, D1_BATCH, {"transfer_dtype": "bfloat16", "device_prefetch": True})),
                     [bf16_rounded(b) for b in want[0]], on_card, dev)

    # fit: phase 4's small CIRIM (with the config's FFT convention) on the
    # poisson2d loader, 2 epochs, from the same weights on the card (fed by
    # the device prefetcher) and on the CPU; per-step losses, then validate()
    cfg = dict(small, fft_centered=False, fft_normalization="backward")
    src = srcs["poisson2d"]
    fits = {}
    for where in (DEVICE, "cpu"):
        model = build_model(cfg, device=where)
        model.load_state_dict(state_small)
        trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg={"max_epochs": 2, "log_every_n_steps": 3},
                          device=where)
        trainer.setup_optimization(num_samples=len(src), batch_size=D1_BATCH)
        trainer.init_state()
        losses, step = [], trainer.training_batch
        trainer.training_batch = lambda b, step=step, losses=losses: (lambda m: losses.append(m["loss"]) or m)(step(b))
        stages = {"device_prefetch": True} if where == DEVICE else {}
        history = trainer.fit(loader(src, TRAIN_DS, D1_BATCH, stages), BatchLoader(src, batch_size=D1_BATCH))
        val = trainer.validate(BatchLoader(src, batch_size=D1_BATCH))
        fits[where] = (torch.stack(losses).cpu(), history, val)
    (l_dev, h_dev, v_dev), (l_cpu, h_cpu, v_cpu) = fits[DEVICE], fits["cpu"]
    check("d1_fit_step_losses", l_dev, l_cpu, 2e-3, 2e-4, note=f"{len(l_cpu)} steps over 2 epochs")
    keys = sorted(v_cpu)
    check("d1_validate_metrics", torch.tensor([v_dev[k] for k in keys], dtype=torch.float64),
          torch.tensor([v_cpu[k] for k in keys], dtype=torch.float64), 2e-3,
          2e-4 / max(abs(v) for v in v_cpu.values()), note=json.dumps({"card": v_dev, "cpu": v_cpu}))
    check("d1_fit_epoch_metrics", torch.tensor([[h[k] for k in sorted(h_cpu[0])] for h in h_dev], dtype=torch.float64),
          torch.tensor([[h[k] for k in sorted(h_cpu[0])] for h in h_cpu], dtype=torch.float64), 2e-3,
          2e-4 / max(abs(v) for h in h_cpu for v in h.values() if v))
    emit({"phase": "D1", "seconds": time.perf_counter() - t_d})

    # D2. full width: the host pipeline alone, then fit in four feeding modes
    t_d = time.perf_counter()
    data_counts = {k: 0 for k in kernels.launch_counts()}
    trained, d2_recs = None, {}
    for name, (ds, model_over, batch, p8) in D2_RUNS.items():
        poisson = ds["mask_args"]["type"] == "poisson2d"
        train_masks = [mask_of(("d2", H, W, f"d2_{i}.h5")) for i in range(D2_TRAIN_VOLUMES)] if poisson else None
        vols = d_volumes("d2", D2_TRAIN_VOLUMES, D2_SLICES, COILS, H, W, seed=22, masks=train_masks)
        src = source(ds, vols)
        cfg = flagship_cfg(fft_centered=ds["fft_centered"], fft_normalization=ds["fft_normalization"], **model_over)
        # (a) the host pipeline alone: batches of the plain loader, no card work
        host = BatchLoader(src, batch_size=batch, shuffle=True, seed=0)
        it, times = iter(host), []
        for _ in range(min(3, len(host))):
            t0 = time.perf_counter()
            next(it)
            times.append((time.perf_counter() - t0) * 1e3)
        del it
        emit({"d2": name, "host_pipeline_ms_per_batch": float(np.mean(times)), "batch": batch,
              "host_pipeline_ms_per_slice": float(np.mean(times)) / batch, "batches": len(times),
              "note": "transform + collate of the plain loader, numpy on the host; the poisson2d masks come with "
                      "the volumes (D_masks gives the masker's own time)" if poisson else
                      "transform (equispaced1d masker included) + collate of the plain loader", "card": card})
        for mode in D2_MODES:
            stages = {"plain": {}, "prefetch": {"num_workers": D2_WORKERS, "prefetch_batches": 2},
                      "prefetch+device_prefetch": {"num_workers": D2_WORKERS, "prefetch_batches": 2,
                                                   "device_prefetch": True},
                      "device_cache_gathered": {"num_workers": D2_WORKERS, "prefetch_batches": 2,
                                                "device_prefetch": True, "device_cache_dataset": True}}[mode]
            ldr = loader(src, ds, batch, stages)
            if mode == "device_cache_gathered":
                for _ in ldr:  # the populating epoch, no training
                    pass
                if ldr._disabled:  # over its max_bytes budget: the reference's pass-through
                    emit({"d2": name, "mode": mode, "device_cache": "disabled, batches pass through the host "
                          "pipeline", "max_bytes": ldr.max_bytes, "card": card})
                elif not ldr._populated:
                    raise AssertionError(f"{name}: the device cache did not populate in one epoch")
            model = build_model(cfg, device=dev)
            model.load_state_dict(state)
            steps = D2_WARMUP + D2_ITERS + 1  # the last one traced
            trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg={"max_steps": steps, "max_epochs": 100},
                              device=dev)
            trainer.setup_optimization(num_samples=len(src), batch_size=batch)
            trainer.init_state()
            marks, step = {}, trainer.training_batch
            prof = profile(activities=[ProfilerActivity.CUDA])

            def timed(b, step=step, marks=marks, prof=prof):
                n = marks.setdefault("n", 0)
                if n == D2_WARMUP:
                    torch.cuda.synchronize()
                    marks["t0"] = time.perf_counter()
                if n == steps - 1:
                    torch.cuda.synchronize()
                    marks["t1"] = time.perf_counter()
                    prof.start()
                out = step(b)
                if n == steps - 1:
                    torch.cuda.synchronize()
                    marks["traced_wall_ms"] = (time.perf_counter() - marks["t1"]) * 1e3
                    prof.stop()
                marks["n"] = n + 1
                return out

            trainer.training_batch = timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            trainer.fit(ldr)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if marks.get("n") != steps:
                raise AssertionError(f"{name}/{mode}: {marks.get('n')} steps, {steps} expected")
            delta = {k: v for k, v in counts.items() if v}
            want = {k: v * steps for k, v in data_per_step(name).items()}
            ms = (marks["t1"] - marks["t0"]) / D2_ITERS * 1e3
            device_ms = union_ms(prof)
            rec = {"d2": name, "mode": mode, "batch": batch, "steps_timed": D2_ITERS, "ms_per_step": ms,
                   "slices_per_s": batch / ms * 1e3, "device_ms_per_step": device_ms,
                   "device_idle_share": 1.0 - device_ms / ms, "traced_step_wall_ms": marks["traced_wall_ms"],
                   "launches_per_step": {k: v / steps for k, v in delta.items()},
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "phase8_synthetic": {k: phase8[p8][k] for k in ("batch", "ms_per_step", "slices_per_s")},
                   "card": card}
            emit(rec)
            d2_recs[(name, mode)] = rec
            if delta != want:
                raise AssertionError(f"{name}/{mode}: launches {delta} != expected {want}")
            for k, v in delta.items():
                data_counts[k] += v
            if name == "data_f32_full":
                trained = trainer
            del ldr, model
        del src, vols
        torch.cuda.empty_cache()
    for r in rows:
        r["data_launches"] = data_counts.get(r["name"], 0)
    missing = [k for k in set().union(*map(data_per_step, D2_RUNS)) if data_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the data path: {missing}")
    emit({"phase": "D2", "seconds": time.perf_counter() - t_d})

    # D3. evaluating from data: data_f32_full's trained weights over the
    # validation slices, then the plain CPU path's metrics on the same
    # predictions
    t_d = time.perf_counter()
    vol = d_volumes("d2_val", 1, D2_VAL_SLICES, COILS, H, W, seed=23, masks=[mask_of(("d2", H, W, "d2_val_0.h5"))])
    val = BatchLoader(source({**TRAIN_DS, "shuffle": False}, vol), batch_size=TRAIN_F32_BATCH, shuffle=False)
    preds, predict = [], trained.predict_batch
    trained.predict_batch = lambda b, use_ema=False: preds.append(predict(b, use_ema)) or preds[-1]
    results = {}
    for what in ("validate", "test"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[what] = getattr(trained, what)(val)
        results[f"{what}_ms_per_slice"] = (time.perf_counter() - t0) * 1e3 / D2_VAL_SLICES
    cpu = Trainer(build_model(flagship_cfg(compute_dtype=None, dc_mode="full"), device="cpu"), device="cpu")
    replay = iter(preds)
    cpu.predict_batch = lambda b, use_ema=False: next(replay)
    cpu_val, (cpu_recons, cpu_test) = cpu.validate(val), cpu.test(val)
    card_recons, card_test = results["test"]
    rec = {"d3": "data_f32_full", "slices": D2_VAL_SLICES, "validate_ms_per_slice": results["validate_ms_per_slice"],
           "test_ms_per_slice": results["test_ms_per_slice"], "validate": results["validate"], "test": card_test,
           "cpu_path_validate": cpu_val, "cpu_path_test": cpu_test, "card": card}
    emit(rec)
    if results["validate"] != cpu_val or card_test != cpu_test or sorted(card_recons) != sorted(cpu_recons) or any(
            not np.array_equal(card_recons[k], cpu_recons[k]) for k in cpu_recons):
        raise AssertionError("d3: the card's metrics differ from the CPU path's on the same predictions")
    finite = all(np.isfinite(v) for v in list(cpu_val.values()) + list(cpu_test.values()))
    if not finite or len(preds) != 2 * -(-D2_VAL_SLICES // TRAIN_F32_BATCH):
        raise AssertionError(f"d3: metrics not finite or {len(preds)} prediction batches")
    emit({"phase": "D3", "seconds": time.perf_counter() - t_d})
    return d2_recs


def launch_phase(dev, card, rows, masks, d2_recs) -> None:
    """Phase L: the launch path at full width, through the entry point a user
    calls. ``run_from_config`` of LAUNCH_CFG (the flagship config as written)
    with the overrides printed, mode ``train``: the initial validation, then
    ``fit`` with the profiler window, validation-end checkpoints and the
    archive at the end. L1 ``launch_f32_full`` (poisson2d: full DC, K2 and
    K3-f32), L2 ``launch_f32_psf1d`` (equispaced1d, acceleration 4: psf1d DC,
    K1-f32 and K3-f32).

    The script needs no h5py: for the phase, the port's
    ``data/factory.py:ReconstructionMRIDataset`` is replaced by a factory that
    returns ``PhantomSource(volumes[root], transform)`` over D2's phantom
    volumes (15 coils, 320x320; 48 training slices, of which a run takes
    ``L_STEPS``, and 16 validation slices), with
    their pre-drawn poisson2d masks for L1. Only the file read is replaced:
    the transform, the loader and the rest of the path are the port's, and
    ``tests/test_torch_port_launch.py`` holds the h5 read against mridc_tpu on
    the CPU. Then L1's archive, restored with ``checkpoints.restore_model``,
    tests as the trained model does; a second ``fit`` on L1's run dir
    (``resume_if_exists``) gets SIGTERM after its first step, returns, and
    saves ``last``; a third resumes from it."""
    import os
    import shutil
    import signal
    import tempfile
    import threading
    from unittest import mock

    import torch

    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.data import factory
    from mridc_tpu_torch.launch import run_from_config
    from mridc_tpu_torch.train import checkpoints
    from mridc_tpu_torch.train.config import apply_overrides, load_config
    from mridc_tpu_torch.train.trainer import Trainer

    t_l = time.perf_counter()
    train = d_volumes("d2", D2_TRAIN_VOLUMES, D2_SLICES, COILS, H, W, seed=22,
                      masks=[masks[("d2", H, W, f"d2_{i}.h5")].result()[0] for i in range(D2_TRAIN_VOLUMES)])
    val = d_volumes("d2_val", 1, D2_VAL_SLICES, COILS, H, W, seed=23,
                    masks=[masks[("d2", H, W, "d2_val_0.h5")].result()[0]])
    unmasked = lambda v: {f: (*a[:3], None) for f, a in v.items()}  # noqa: E731
    vols = {"phantom/poisson2d/train": train, "phantom/poisson2d/val": val,
            "phantom/1d/train": unmasked(train), "phantom/1d/val": unmasked(val)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    record = {"marks": [], "counts": [], "steps_before": [], "sigterm_after": None}
    step = Trainer.training_batch

    def recording(self, batch):
        record["marks"].append(time.perf_counter())
        record["steps_before"].append(self.state.step if self.state is not None else 0)
        before = kernels.launch_counts()
        out = step(self, batch)
        after = kernels.launch_counts()
        record["counts"].append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        if record["sigterm_after"] == len(record["marks"]):
            timer = threading.Timer(0.0, os.kill, (os.getpid(), signal.SIGTERM))
            timer.start()
            timer.join()
        return out

    def source(root, transform, **_):
        return PhantomSource(vols[root], transform)

    def launch(overrides):
        record.update(marks=[], counts=[], steps_before=[])
        return run_from_config(apply_overrides(LAUNCH_CFG, overrides))

    launch_counts = {k: 0 for k in kernels.launch_counts()}
    try:
        with mock.patch.object(factory, "ReconstructionMRIDataset", source), \
                mock.patch.object(Trainer, "training_batch", recording):
            for run_name, (extra, root, p8) in L_RUNS.items():
                profile_dir = tmp / run_name / "profile"
                overrides = ["trainer.max_epochs=1", f"trainer.limit_train_batches={L_STEPS}",
                             f'model.train_ds.data_path="{root}/train"',
                             f'model.validation_ds.data_path="{root}/val"', f'model.test_ds.data_path="{root}/val"',
                             f'trainer.profile_dir="{profile_dir}"', f'exp_manager.exp_dir="{tmp / run_name}"', *extra]
                emit({"phase": "L", "run": run_name, "config": "projects/reconstruction/conf/base_cirim_train.yaml",
                      "overrides": overrides, "batch": 1, "card": card})
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                trainer, history = launch(overrides)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                for k, v in kernels.launch_counts().items():
                    launch_counts[k] += v
                want = fed_per_step(p8)
                steps = len(record["marks"])
                bad = [c for c in record["counts"] if c != want]
                marks = record["marks"][10:]  # after the profiler window (steps 3-7) and its stop
                ms = (marks[-1] - marks[0]) / (len(marks) - 1) * 1e3
                run_dir = trainer.exp_manager.log_dir
                traces = sorted(p.name for p in profile_dir.glob("*.json"))
                ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
                files = sorted(p.name for p in run_dir.iterdir())
                d2 = d2_recs[("data_f32_full", "plain")]
                emit({"l": run_name, "batch": 1, "steps": steps, "ms_per_step": ms, "slices_per_s": 1e3 / ms,
                      "steps_timed": len(marks) - 1, "seconds": seconds,
                      "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches_per_step": record["counts"][-1], "history": history, "traces": traces,
                      "checkpoints": ckpts, "run_dir": files,
                      "d2_data_f32_full_plain": {k: d2[k] for k in ("batch", "ms_per_step", "slices_per_s")},
                      "note": "ms per step between the starts of consecutive steps after the profiler window: the "
                              "plain loader's host pipeline and the step, at the config's batch size 1",
                      "card": card})
                if steps != L_STEPS or bad:
                    raise AssertionError(f"{run_name}: {steps} steps; launches per step {bad[:1]} != {want}")
                if not traces or not history or not all(np.isfinite(v) for v in history[-1].values()):
                    raise AssertionError(f"{run_name}: no trace in {profile_dir} or no finite history {history}")
                need = {"config.yaml", "hparams.yaml", "checkpoints", "cirim.mridc"}
                if not need <= set(files) or "last" not in ckpts or not any(c.isdigit() for c in ckpts):
                    raise AssertionError(f"{run_name}: run dir {files}, checkpoints {ckpts}")
                if run_name != "launch_f32_full":
                    del trainer
                    continue

                # the archive (the best monitored weights: those of the one
                # validation, the final ones) restored on the card tests as
                # the trained model does
                restored, _, _ = checkpoints.restore_model(run_dir / "cirim.mridc", device="cuda")
                val_loader = factory.build_dataloader(load_config(run_dir / "config.yaml")["model"]["validation_ds"],
                                                      load_config(run_dir / "hparams.yaml"), shuffle=False,
                                                      device=dev)
                got, _ = Trainer(restored, device=dev).test(val_loader)
                want_recons, _ = trainer.test(val_loader)
                check("launch_archive_restored_test", torch.from_numpy(np.stack([got[k] for k in sorted(got)])),
                      torch.from_numpy(np.stack([want_recons[k] for k in sorted(want_recons)])), *F32,
                      note=f"{len(got)} volume(s) of {D2_VAL_SLICES} slices")
                del restored, val_loader, trainer

                # SIGTERM after the first step of a resumed fit, then resume again
                resume = overrides + ["exp_manager.resume_if_exists=true", f'exp_manager.version="{run_dir.name}"',
                                      f"trainer.limit_val_batches={L_VAL_LIMIT}"]
                emit({"phase": "L", "run": "sigterm", "overrides": resume[len(overrides):], "card": card})
                record["sigterm_after"] = 1
                before = signal.getsignal(signal.SIGTERM)
                _, history2 = launch(resume)
                record["sigterm_after"] = None
                last = checkpoints.StepCheckpointer(run_dir / "checkpoints").restore_last()
                resumed_at = record["steps_before"][0]
                emit({"l": "sigterm", "resumed_at": resumed_at, "steps": len(record["marks"]), "history": history2,
                      "last_step": int(last["step"]), "handler_restored": signal.getsignal(signal.SIGTERM) == before,
                      "card": card})
                if (resumed_at != steps or len(record["marks"]) != 1 or int(last["step"]) != steps + 1
                        or not isinstance(history2, list) or signal.getsignal(signal.SIGTERM) != before):
                    raise AssertionError(f"sigterm: resumed at {resumed_at}, {len(record['marks'])} steps, last at "
                                         f"{int(last['step'])}, history {history2}")
                _, history3 = launch(resume + [f"trainer.max_steps={steps + 3}"])
                emit({"l": "resume_after_sigterm", "steps_before": record["steps_before"], "history": history3,
                      "card": card})
                if record["steps_before"] != [steps + 1, steps + 2]:
                    raise AssertionError(f"resume: steps {record['steps_before']}, expected from {steps + 1}")
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in rows:
        r["launch_launches"] = launch_counts.get(r["name"], 0)
    missing = [k for k in set().union(*(fed_per_step(p8) for *_, p8 in L_RUNS.values())) if launch_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the launch path: {missing}")
    emit({"phase": "L", "seconds": time.perf_counter() - t_l})


@contextlib.contextmanager
def plain_k2():
    """While active, K2's stage wrappers are their plain versions (the same
    index arithmetic in PyTorch ops) whatever device the tensors lie on: the
    oracle of a model's forward and training step on the card. They launch
    nothing, so they count nothing."""
    from mridc_tpu_torch.kernels import k2_full_dc as k2

    names = ("expand", "residual", "load", "reduce", "apply_mask", "reduce_acc")
    saved = {n: getattr(k2, n) for n in names}
    for n in names:
        setattr(k2, n, getattr(k2, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(k2, n, fn)


def zoo_phases(dev, card, rows) -> None:
    """Phases Z and Z8: ZF, ProximalGradient, UNet and ResNet at the widths of
    their projects/reconstruction/conf configs (``ZOO_CFGS``), on
    ``bench_data`` at 15 coils, 320x320, with random weights from a seed.

    Z: the CG's normal operator (``normal_op``, K2's expand, mask and reduce
    around cuFFT) against its plain version at B=8, forward and backward (x's
    and mu's gradients), uncentered backward and centered ortho (F32); each
    model serving B=8 (2 warm-up, 5 timed forwards: ms, slices/s, launches
    per forward against ``ZOO_PER_FORWARD``), its prediction against the same
    forward with K2's plain twins on the card (F32); one traced ResNet
    forward by layer, and one traced CG solve (its launches by layer: K2
    stages, cuFFT and the CG's elementwise, dot-product and reduction
    launches).

    Z8: one training step each through ``Trainer`` (Adam under
    InverseSquareRootAnnealing, the configs' optim block): ZF, UNet and PG at
    B=8, ResNet at its config's B=1 and at B=2; first the loss and each
    parameter's gradient against the same step with K2's plain twins on the
    card (loss at F32; gradients at relative l2 1e-3 a parameter: a relu or
    leaky-relu kink that a 1e-7 change of an activation flips moves a
    gradient elementwise, V1); then 2 warm-up and 3 timed steps (ms,
    slices/s, peak memory, launches per step against ``ZOO_PER_STEP``); ZF's
    loss finite and its grad_norm 0; one traced ResNet step at B=1. Then
    accumulation: UNet with ``accumulate_grad_batches=2`` over the two B=4
    halves of the B=8 batch against one optimizer step on the mean of the
    halves' gradients (the B=8 step of a loss that averages its halves; the
    reconstruction loss normalises by the batch's maximum, so the B=8 loss
    itself is not that mean): the mean gradient at F32, the parameters after
    the step at F32 where |g| > 1e-3 x max (Adam's first step is a sign step)."""
    import torch

    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.kernels import binding
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.models.recon import resnet as tresnet
    from mridc_tpu_torch.train.losses import process_reconstruction_loss
    from mridc_tpu_torch.train.trainer import Trainer

    t_z = time.perf_counter()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    y, sens, mask = (t(a) for a in bench_data(BATCH, COILS, H, W))
    cfgs = {name: {**ZOO_COMMON, **cfg} for name, cfg in ZOO_CFGS.items()}

    def fresh(name):
        return build_model(cfgs[name], device=dev, generator=torch.Generator().manual_seed(ZOO_SEED))

    # Z. the normal operator against its plain version, forward and backward
    gen = torch.Generator().manual_seed(21)
    x0, g0 = (torch.randn(BATCH, H, W, 2, generator=gen).to(dev) for _ in range(2))
    for centered, norm in ((False, "backward"), (True, "ortho")):
        tag = f"{'c' if centered else 'u'}-{norm}"
        res = {}
        for which, fn in (("kernel", k2.normal_op), ("plain", k2.normal_op_plain)):
            x = x0.clone().requires_grad_(True)
            mu = torch.tensor([0.05], device=dev, requires_grad=True)
            out = fn(x, sens, mask, mu, centered, norm)
            out.backward(g0)
            res[which] = (out.detach(), x.grad, mu.grad)
        for i, part in enumerate(("forward", "dx", "dmu")):
            check(f"normal_op[{part}/{tag}]", res["kernel"][i], res["plain"][i], *F32)
        with torch.inference_mode():
            emit({"function": "normal_op", "fft": tag, "shape": tuple(x0.shape),
                  "ms": time_ms(lambda: k2.normal_op(x0, sens, mask, 0.05, centered, norm)),
                  "plain_ms": time_ms(lambda: k2.normal_op_plain(x0, sens, mask, 0.05, centered, norm)),
                  "note": "K2 expand, mask, reduce around cuFFT and one addcmul; launches counted under the stages",
                  "card": card})
    del res, x, out

    # Z. serving at B=8; the counters zeroed before each model and read after
    zoo_counts = {k: 0 for k in binding.LAUNCHES}
    serve_ms = {}
    for name in cfgs:
        model = fresh(name)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            for _ in range(WARMUP):
                model(y, sens, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                pred = model(y, sens, mask).prediction
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        delta = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {k: v * (WARMUP + ITERS) for k, v in ZOO_PER_FORWARD[name].items()}
        serve_ms[name] = dt / ITERS * 1e3
        emit({"run": f"zoo_{name}", "config": f"projects/reconstruction/conf/base_{name}_train.yaml",
              "batch": BATCH, "forwards_timed": ITERS, "seconds": dt, "slices_per_s": ITERS * BATCH / dt,
              "ms_per_forward": serve_ms[name],
              "launches_per_forward": {k: v / (WARMUP + ITERS) for k, v in delta.items()}, "card": card})
        if delta != want:
            raise AssertionError(f"zoo_{name}: launches {delta} != expected {want}")
        if not bool(torch.isfinite(pred).all()) or tuple(pred.shape) != (BATCH, H, W, 2):
            raise AssertionError(f"zoo_{name}: prediction not finite or of shape {tuple(pred.shape)}")
        for k, v in delta.items():
            zoo_counts[k] += v
        with torch.inference_mode(), plain_k2():
            plain = model(y, sens, mask).prediction
        check(f"zoo[{name}]", pred, plain, *F32, note="the same forward with K2's plain twins on the card")
        if name == "resnet":
            with torch.inference_mode():
                emit({"trace": "zoo_resnet", **trace_call(lambda: model(y, sens, mask), serve_ms[name]),
                      "card": card})
                rhs, its = model.zero_filled(y, sens), ZOO_CFGS["resnet"]["conjugate_gradient_iterations"]

                def solve():
                    return tresnet.conjugate_gradient(rhs, sens, mask, model.mu, its, False, "backward")

                emit({"trace": "zoo_resnet_cg_solve", "iterations": its,
                      "solves_per_forward": ZOO_CFGS["resnet"]["unrolled_iterations"], **trace_call(solve, None),
                      "card": card})
        del model, pred, plain
        torch.cuda.empty_cache()
    emit({"phase": "Z", "seconds": time.perf_counter() - t_z})

    # Z8. one training step each
    t_z8 = time.perf_counter()
    target8 = t(train_target(BATCH, H, W))
    zoo_train_counts = {k: 0 for k in binding.LAUNCHES}
    for name in cfgs:
        for b in ((1, 2) if name == "resnet" else (ZOO_TRAIN_BATCH[name],)):
            run = f"train_{name}" + (f"_b{b}" if name == "resnet" else "")
            batch = {"masked_kspace": y[:b], "sensitivity_maps": sens[:b], "mask": mask[:b], "target": target8[:b]}
            first = {}
            for which, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_k2)):
                model = fresh(name)
                with ctx():
                    loss = process_reconstruction_loss(model(y[:b], sens[:b], mask[:b], train=True), target8[:b], "l1")
                    if loss.requires_grad:
                        loss.backward()
                first[which] = (loss.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()})
                del model, loss
            check(f"zoo_train_loss[{run}]", first["kernel"][0], first["plain"][0], *F32)
            if first["plain"][1]:
                gd, gc = first["kernel"][1], first["plain"][1]
                rel = {k: float((gd[k] - gc[k]).norm() / gc[k].norm()) if float(gc[k].norm()) > 0
                       else float(gd[k].norm()) for k in gc}
                worst = max(rel, key=rel.get)
                emit({"check": f"zoo_train_grads[{run}]", "entries": len(rel), "worst": worst,
                      "max_rel_l2": rel[worst], "limit": 1e-3, "ok": rel[worst] <= 1e-3})
                if rel[worst] > 1e-3:
                    raise AssertionError(f"zoo_train_grads[{run}]: {worst} at relative l2 {rel[worst]}")
            del first
            model = fresh(name)
            trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=dev)
            before = {k: v.detach().clone() for k, v in model.named_parameters()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            for _ in range(TRAIN_WARMUP):
                trainer.training_batch(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_ITERS):
                metrics = trainer.training_batch(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            delta = {k: v for k, v in kernels.launch_counts().items() if v}
            steps = TRAIN_WARMUP + TRAIN_ITERS
            want = {k: v * steps for k, v in ZOO_PER_STEP[f"train_{name}"].items()}
            moved = max((float((p.detach() - before[k]).abs().max()) for k, p in model.named_parameters()),
                        default=0.0)
            rec = {"run": run, "batch": b, "steps_timed": TRAIN_ITERS, "seconds": dt,
                   "slices_per_s": TRAIN_ITERS * b / dt, "ms_per_step": dt / TRAIN_ITERS * 1e3,
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "max_param_change": moved, "launches_per_step": {k: v / steps for k, v in delta.items()},
                   "card": card}
            emit(rec)
            if delta != want:
                raise AssertionError(f"{run}: launches {delta} != expected {want}")
            if not np.isfinite(rec["loss"]) or (name == "zf") != (moved == 0.0):
                raise AssertionError(f"{run}: loss {rec['loss']} not finite or parameters moved {moved}")
            if name == "zf" and rec["grad_norm"] != 0.0:
                raise AssertionError(f"{run}: grad_norm {rec['grad_norm']} of a model without parameters")
            for k, v in delta.items():
                zoo_train_counts[k] += v
            if run == "train_resnet_b1":
                emit({"trace": run, **trace_call(lambda: trainer.training_batch(batch), rec["ms_per_step"]),
                      "card": card})
            del trainer, model, batch, before
            torch.cuda.empty_cache()

    # Z8. accumulation: two B=4 micro-steps against one step on their mean gradient
    half = BATCH // 2
    halves = [{"masked_kspace": y[i:i + half], "sensitivity_maps": sens[i:i + half], "mask": mask[i:i + half],
               "target": target8[i:i + half]} for i in (0, half)]
    model = fresh("unet")
    trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg={**TRAIN_CFG, "accumulate_grad_batches": 2},
                      device=dev)
    for h in halves:
        trainer.training_batch(h)
    acc = {k: (p.grad.detach().clone(), p.detach().clone()) for k, p in model.named_parameters()}
    ref_model = fresh("unet")
    ref = Trainer(ref_model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=dev)
    ref.init_state()
    grads = []
    for h in halves:
        ref_model.zero_grad(set_to_none=True)
        process_reconstruction_loss(ref_model(h["masked_kspace"], h["sensitivity_maps"], h["mask"], train=True),
                                    h["target"], "l1").backward()
        grads.append({k: p.grad.detach().clone() for k, p in ref_model.named_parameters()})
    params = list(ref_model.parameters())
    for k, p in ref_model.named_parameters():
        p.grad = (grads[0][k] + grads[1][k]) / 2
    ref._optimizer_step(ref.state.optimizer, params)
    rp = dict(ref_model.named_parameters())
    check_all("zoo_accumulation_mean_gradient[unet, 2 x B=4]", {k: v[0] for k, v in acc.items()},
              {k: p.grad for k, p in rp.items()}, *F32)
    sure = {k: p.grad.abs() > 1e-3 * float(p.grad.abs().max()) for k, p in rp.items()}
    check_all("zoo_accumulation_params[unet, 2 x B=4]", {k: v[1][sure[k]] for k, v in acc.items()},
              {k: p.detach()[sure[k]] for k, p in rp.items()}, *F32,
              note=f"state.step {trainer.state.step}, optimizer steps {trainer.state.gradient_step}")
    if (trainer.state.step, trainer.state.gradient_step) != (2, 1):
        raise AssertionError(f"accumulation: steps {trainer.state.step}, "
                             f"optimizer steps {trainer.state.gradient_step}")
    del model, trainer, ref_model, ref, grads, acc, halves
    torch.cuda.empty_cache()

    for r in rows:
        r["zoo_launches"] = zoo_counts.get(r["name"], 0)
        r["zoo_train_launches"] = zoo_train_counts.get(r["name"], 0)
    missing = [k for k in set().union(*ZOO_PER_FORWARD.values()) if zoo_counts[k] == 0]
    missing += [k for k in set().union(*ZOO_PER_STEP.values()) if zoo_train_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the zoo's paths: {missing}")
    emit({"phase": "Z8", "seconds": time.perf_counter() - t_z8})


def op_device_ms(prof, top=14) -> dict:
    """Total device time by ATen op (its kernels and its children's) of a
    profiled call: where a layer's passes go (``aten::where`` is the PReLU
    and the soft DC, ``aten::pixel_shuffle`` the subpixel copies)."""
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", None)
        ms = getattr(e, "cuda_time_total", 0.0) if ms is None else ms
        if ms and e.key.startswith("aten::"):
            out[e.key] = ms / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def zoo2_phase(dev, card, rows) -> None:
    """Phase Z2: CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet and DUNet
    at the widths of their projects/reconstruction/conf configs
    (``ZOO2_CFGS``), on ``bench_data`` at 15 coils, 320x320, with random
    weights from ``ZOO_SEED``.

    K2's masked expansion (``sens_expand(mask=)``, XPDNet's and LPDNet's
    forward operator) against its plain version at B=8, forward and backward,
    uncentered backward and centered ortho (F32). Serving at B=8: 2 warm-up
    and 5 timed forwards per model (ms, slices/s, launches per forward against
    ``ZOO2_PER_FORWARD``), the prediction against the same forward with K2's
    plain twins on the card (F32). Training through ``Trainer`` (the YAMLs'
    Adam under InverseSquareRootAnnealing) at the configs' batch 1, and
    CascadeNet at B=8: the first step's loss (F32) and the gradient (relative
    l2 1e-3 whole, 2e-2 a parameter; where a 1e-7 relative change of y moves
    the plain twins' own gradient more than 1e-3, 3x that spread whole)
    against the plain twins, then 2 warm-up and 3
    timed steps (ms, slices/s, peak memory, launches per step against
    ``ZOO2_PER_STEP``). Traces: a forward and a training step of the model
    with the most device time per forward, and a KIKINet forward (its DIDN on
    B x 15 coil images), by layer and by ATen op. BatchNorm: CascadeNet with
    live statistics (``ZOO2_BN_CFG``, B=2), two SGD steps on the card against
    the same two on the CPU (loss, gradients, parameters, the running mean
    and variance after each), then an eval forward with those statistics. SGD
    there, not the YAMLs' Adam: the conv biases before each BatchNorm have
    roundoff gradients, which Adam's first step turns into full steps of
    either sign on the card and the CPU alike."""
    import torch

    from mridc_tpu_torch import kernels
    from mridc_tpu_torch.kernels import binding
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.nn import mwcnn as tmwcnn
    from mridc_tpu_torch.train.losses import process_reconstruction_loss
    from mridc_tpu_torch.train.trainer import Trainer

    t_z2 = time.perf_counter()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    y, sens, mask = (t(a) for a in bench_data(BATCH, COILS, H, W))
    cfgs = {name: {**ZOO_COMMON, **cfg} for name, cfg in ZOO2_CFGS.items()}

    def fresh(name, where=dev):
        return build_model(cfgs[name], device=where, generator=torch.Generator().manual_seed(ZOO_SEED))

    # the masked expansion against its plain version, forward and backward
    gen = torch.Generator().manual_seed(23)
    x0 = torch.randn(BATCH, H, W, 2, generator=gen).to(dev)
    g0 = torch.randn(BATCH, COILS, H, W, 2, generator=gen).to(dev)
    for centered, norm in ((False, "backward"), (True, "ortho")):
        tag = f"{'c' if centered else 'u'}-{norm}"
        res = {}
        for which, fn in (("kernel", k2.sens_expand), ("plain", k2.sens_expand_plain)):
            x = x0.clone().requires_grad_(True)
            out = fn(x, sens, centered, norm, mask=mask)
            out.backward(g0)
            res[which] = (out.detach(), x.grad)
        check(f"sens_expand_masked[forward/{tag}]", res["kernel"][0], res["plain"][0], *F32)
        check(f"sens_expand_masked[dx/{tag}]", res["kernel"][1], res["plain"][1], *F32)
        with torch.inference_mode():
            emit({"function": "sens_expand_masked", "fft": tag, "shape": tuple(x0.shape),
                  "ms": time_ms(lambda: k2.sens_expand(x0, sens, centered, norm, mask=mask)),
                  "plain_ms": time_ms(lambda: k2.sens_expand_plain(x0, sens, centered, norm, mask=mask)),
                  "note": "K2 expand, cuFFT, mask (and the fftshift load when centered); launches counted under "
                          "the stages", "card": card})
    del res, x, out, g0

    # serving at B=8; the counters zeroed before each model and read after
    z2_counts = {k: 0 for k in binding.LAUNCHES}
    serve_ms = {}
    for name in cfgs:
        model = fresh(name)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            for _ in range(WARMUP):
                model(y, sens, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                pred = model(y, sens, mask).prediction
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        delta = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {k: v * (WARMUP + ITERS) for k, v in ZOO2_PER_FORWARD[name].items()}
        serve_ms[name] = dt / ITERS * 1e3
        emit({"run": f"zoo2_{name}", "config": f"projects/reconstruction/conf/base_{name}_train.yaml",
              "batch": BATCH, "forwards_timed": ITERS, "seconds": dt, "slices_per_s": ITERS * BATCH / dt,
              "ms_per_forward": serve_ms[name],
              "launches_per_forward": {k: v / (WARMUP + ITERS) for k, v in delta.items()}, "card": card})
        if delta != want:
            raise AssertionError(f"zoo2_{name}: launches {delta} != expected {want}")
        if not bool(torch.isfinite(pred).all()) or tuple(pred.shape) != (BATCH, H, W, 2):
            raise AssertionError(f"zoo2_{name}: prediction not finite or of shape {tuple(pred.shape)}")
        for k, v in delta.items():
            z2_counts[k] += v
        with torch.inference_mode(), plain_k2():
            plain = model(y, sens, mask).prediction
        check(f"zoo2[{name}]", pred, plain, *F32, note="the same forward with K2's plain twins on the card")
        if name == "kikinet":
            with torch.inference_mode():
                emit({"trace": "zoo2_kikinet", "batch": BATCH,
                      **trace_call(lambda: model(y, sens, mask), serve_ms[name]), "card": card})
        del model, pred, plain
        torch.cuda.empty_cache()
    heaviest = max(serve_ms, key=serve_ms.get)
    if heaviest != "kikinet":  # KIKINet's forward is traced above
        model = fresh(heaviest)
        with torch.inference_mode():
            emit({"trace": f"zoo2_{heaviest}", "batch": BATCH,
                  **trace_call(lambda: model(y, sens, mask), serve_ms[heaviest]), "card": card})
        del model
    # the DWT and IWT passes of XPDNet's MWCNN (12 channels, 16 x 2 scales) at B=8, alone
    with torch.inference_mode():
        xm = torch.randn(BATCH, 32, H, W, device=dev).contiguous(memory_format=torch.channels_last)
        xi = tmwcnn.dwt2(xm).contiguous(memory_format=torch.channels_last)
        emit({"function": "mwcnn_dwt2_iwt2", "shape": tuple(xm.shape), "dwt2_ms": time_ms(lambda: tmwcnn.dwt2(xm)),
              "iwt2_ms": time_ms(lambda: tmwcnn.iwt2(xi)), "copy_ms": time_ms(lambda: xm.clone()), "card": card})
        del xm, xi
    torch.cuda.empty_cache()

    # training: the first step against the plain twins, then timed steps
    target8 = t(train_target(BATCH, H, W))
    z2_train_counts = {k: 0 for k in binding.LAUNCHES}
    for name in cfgs:
        for b in ((ZOO2_TRAIN_BATCH, BATCH) if name == ZOO2_BIG_TRAIN else (ZOO2_TRAIN_BATCH,)):
            run = f"train_{name}" + (f"_b{b}" if name == ZOO2_BIG_TRAIN else "")
            batch = {"masked_kspace": y[:b], "sensitivity_maps": sens[:b], "mask": mask[:b], "target": target8[:b]}
            first = {}
            y_p = y[:b] * (1 + 1e-7 * torch.randn(y[:b].shape, generator=torch.Generator().manual_seed(5)).to(dev))
            for which, ctx, yb in (("kernel", contextlib.nullcontext, y[:b]), ("plain", plain_k2, y[:b]),
                                   ("plain_perturbed", plain_k2, y_p)):
                model = fresh(name)
                with ctx():
                    out = model(yb, sens[:b], mask[:b], train=True)
                    loss = process_reconstruction_loss(out, target8[:b], "l1")
                    loss.backward()
                first[which] = (loss.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()})
                del model, loss, out
            check(f"zoo2_train_loss[{run}]", first["kernel"][0], first["plain"][0], *F32)
            gc = first["plain"][1]

            def rel_l2(g):
                rel = {k: float((g[k] - gc[k]).norm() / gc[k].norm()) if float(gc[k].norm()) > 0
                       else float(g[k].norm()) for k in gc}
                whole = float(torch.cat([(g[k] - gc[k]).flatten() for k in gc]).norm()
                              / torch.cat([gc[k].flatten() for k in gc]).norm())
                return rel, whole

            rel, whole = rel_l2(first["kernel"][1])
            rel_p, whole_p = rel_l2(first["plain_perturbed"][1])
            # The gradient against the plain twins' at Z8's 1e-3 whole and V1's
            # 2e-2 a parameter, where the gradient is well posed: a 1e-7
            # relative change of y moves the plain twins' own whole gradient
            # less than 1e-3. ReLU, PReLU and LeakyReLU kinks that such a change
            # flips move single parameters (a PReLU alpha sums g x over a whole
            # activation). Where it moves more (DUNet's ten random DIDNs: the
            # chip reads 1.2e-2 whole and 19% for one PReLU alpha), the
            # first-step gradient is chaotic, and the kernels are held to 3x the
            # plain twins' own spread, whole gradient
            posed = whole_p < 1e-3
            worst = sorted(rel, key=lambda k: -rel[k])[:3]
            ok = (whole <= 1e-3 and all(v <= 2e-2 for v in rel.values())) if posed else whole <= 3 * whole_p
            emit({"check": f"zoo2_train_grads[{run}]", "entries": len(rel), "whole_rel_l2": whole,
                  "perturbed_whole_rel_l2": whole_p, "posed": posed,
                  "worst": {k: [rel[k], rel_p[k], gc[k].numel()] for k in worst}, "max_rel_l2": rel[worst[0]],
                  "limit": "1e-3 whole, 2e-2 a parameter" if posed else f"{3 * whole_p:.3g} whole (3x perturbed)",
                  "ok": ok})
            if not ok:
                raise AssertionError(f"zoo2_train_grads[{run}]: whole {whole} (perturbed {whole_p}), worst "
                                     f"{worst[0]} at relative l2 {rel[worst[0]]}")
            del first, gc
            model = fresh(name)
            trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=dev)
            before = {k: v.detach().clone() for k, v in model.named_parameters()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            for _ in range(TRAIN_WARMUP):
                trainer.training_batch(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_ITERS):
                metrics = trainer.training_batch(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            delta = {k: v for k, v in kernels.launch_counts().items() if v}
            steps = TRAIN_WARMUP + TRAIN_ITERS
            want = {k: v * steps for k, v in ZOO2_PER_STEP[f"train_{name}"].items()}
            moved = max(float((p.detach() - before[k]).abs().max()) for k, p in model.named_parameters())
            rec = {"run": f"zoo2_{run}", "batch": b, "steps_timed": TRAIN_ITERS, "seconds": dt,
                   "slices_per_s": TRAIN_ITERS * b / dt, "ms_per_step": dt / TRAIN_ITERS * 1e3,
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "max_param_change": moved, "launches_per_step": {k: v / steps for k, v in delta.items()},
                   "card": card}
            emit(rec)
            if delta != want:
                raise AssertionError(f"zoo2_{run}: launches {delta} != expected {want}")
            if not np.isfinite(rec["loss"]) or not moved > 0:
                raise AssertionError(f"zoo2_{run}: loss {rec['loss']} not finite or parameters unchanged ({moved})")
            for k, v in delta.items():
                z2_train_counts[k] += v
            if name == heaviest and b == ZOO2_TRAIN_BATCH:
                emit({"trace": f"zoo2_{run}", **trace_call(lambda: trainer.training_batch(batch),
                                                              rec["ms_per_step"]), "card": card})
            del trainer, model, batch, before
            torch.cuda.empty_cache()

    # BatchNorm with live statistics: two SGD steps on the card against the CPU
    bn_b = ZOO2_BN_BATCH
    bn_batch = {"masked_kspace": y[:bn_b], "sensitivity_maps": sens[:bn_b], "mask": mask[:bn_b],
                "target": target8[:bn_b]}
    bn_optim = {"name": "sgd", "lr": 0.05}
    runs = {}
    for where in (dev, torch.device("cpu")):
        model = build_model(ZOO2_BN_CFG, device=where, generator=torch.Generator().manual_seed(ZOO_SEED))
        trainer = Trainer(model, optim_cfg=bn_optim, trainer_cfg=TRAIN_CFG, device=where)
        hist = []
        for _ in range(2):
            loss = float(trainer.training_batch({k: v.to(where) for k, v in bn_batch.items()})["loss"])
            hist.append((loss, {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                         {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}))
        with torch.inference_mode():
            pred = model(*(bn_batch[k].to(where) for k in ("masked_kspace", "sensitivity_maps", "mask"))).prediction
        runs[where.type] = (hist, pred.cpu())
        del model, trainer
    prev_var, prev_d, prev_c = {}, {}, {}
    init = build_model(ZOO2_BN_CFG, device="cpu", generator=torch.Generator().manual_seed(ZOO_SEED)).state_dict()
    for step, ((l_d, g_d, s_d), (l_c, g_c, s_c)) in enumerate(zip(runs[dev.type][0], runs["cpu"][0])):
        check(f"zoo2_bn_loss[step {step}]", torch.tensor(l_d), torch.tensor(l_c), *F32)
        # every conv feeds a train-mode BatchNorm, whose batch mean removes the
        # conv's bias: those gradients are roundoff on both sides (their
        # largest is reported beside the largest gradient)
        noise = {k for k in g_c if ".convs." in k and k.endswith(".bias")}
        top = max(float(g.abs().max()) for g in g_c.values())
        roundoff = max(max(float(g_d[k].abs().max()), float(g_c[k].abs().max())) for k in noise)
        rel = {k: float((g_d[k] - g_c[k]).norm() / g_c[k].norm()) for k in g_c
               if k not in noise and float(g_c[k].norm()) > 0}
        whole = float(torch.cat([(g_d[k] - g_c[k]).flatten() for k in rel]).norm()
                      / torch.cat([g_c[k].flatten() for k in rel]).norm())
        worst = max(rel, key=rel.get)
        # as in the training check: 1e-3 whole, V1's card-vs-CPU 2e-2 a
        # parameter (a PReLU alpha's gradient, a sum of g x over a whole
        # activation, moves with the kinks that the two devices' summation
        # orders flip)
        ok = whole <= 1e-3 and rel[worst] <= 2e-2
        emit({"check": f"zoo2_bn_grads[step {step}]", "entries": len(rel), "roundoff_left_out": len(noise),
              "roundoff_max_grad": roundoff, "max_grad": top, "whole_rel_l2": whole, "worst": worst,
              "max_rel_l2": rel[worst], "limit": "1e-3 whole, 2e-2 a parameter", "ok": ok})
        if not ok:
            raise AssertionError(f"zoo2_bn_grads[step {step}]: whole {whole}, {worst} at relative l2 {rel[worst]}")
        stats = {k for k in s_c if k.endswith(("running_mean", "running_var"))}
        variances = {k for k in stats if k.endswith("running_var")}
        check_all(f"zoo2_bn_running_var[step {step}]", {k: s_d[k] for k in variances},
                  {k: s_c[k] for k in variances}, *F32)
        # a running mean adds m x the batch's mean, a sum over 2 x 320 x 320
        # values with cancellation: its error scales with those values' std,
        # m sqrt(var_batch), not with the mean, so F32's atol is taken of that.
        # The batch's mean carries the preceding conv's bias, whose roundoff
        # gradient moved it differently on the two sides in the steps before:
        # m x that difference is added
        worst_share, bad, shift = 0.0, [], 0.0
        for k in stats - variances:
            var = f"{k[:-len('running_mean')]}running_var"
            before = prev_var.get(var, torch.ones_like(s_c[var]))
            std = float(((s_c[var] - (1 - 0.1) * before) / 0.1).clamp(min=0).sqrt().max())
            bias = k.replace(".bns.", ".convs.")[:-len("running_mean")] + "bias"
            moved = float((prev_d[bias] - prev_c[bias]).abs().max()) if prev_d else 0.0
            shift = max(shift, moved)
            atol = F32[1] * max(float(s_c[k].abs().max()), 0.1 * std) + 0.1 * moved
            err = (s_d[k] - s_c[k]).abs()
            share = float((err / (atol + F32[0] * s_c[k].abs())).max())
            worst_share = max(worst_share, share)
            if share > 1:
                bad.append(k)
        emit({"check": f"zoo2_bn_running_mean[step {step}]", "entries": len(stats - variances),
              "worst_err_over_limit": worst_share, "bias_difference_before": shift,
              "limit": "F32, atol of max(|mean|, m std of the batch) + m x the preceding bias's difference",
              "ok": not bad})
        if bad:
            raise AssertionError(f"zoo2_bn_running_mean[step {step}]: outside the limits: {bad}")
        prev_var, prev_d, prev_c = {k: s_c[k] for k in variances}, s_d, s_c
        # the parameters after the steps at F32 where they did not start at 0;
        # one that did (a BatchNorm bias) is -lr x its summed gradients, which
        # the gradient check holds
        held = [k for k in s_c if k not in stats and k not in noise and bool(init[k].any())]
        check_all(f"zoo2_bn_params[step {step}]", {k: s_d[k] for k in held}, {k: s_c[k] for k in held}, *F32,
                  note=f"{len(noise)} conv biases with roundoff gradients held to 1e-5 absolute; "
                       f"{len(s_c) - len(stats) - len(noise) - len(held)} zero-initialised parameters by their "
                       "gradients")
        far = max((float((s_d[k] - s_c[k]).abs().max()) for k in noise), default=0.0)
        if far > 1e-5:
            raise AssertionError(f"zoo2_bn_params[step {step}]: a roundoff-gradient bias moved {far}")
    check("zoo2_bn_eval_forward", runs[dev.type][1], runs["cpu"][1], *F32,
          note="eval mode: normalised with the running statistics of the two steps")
    del runs
    torch.cuda.empty_cache()

    for r in rows:
        r["zoo2_launches"] = z2_counts.get(r["name"], 0)
        r["zoo2_train_launches"] = z2_train_counts.get(r["name"], 0)
    missing = [k for k in set().union(*ZOO2_PER_FORWARD.values()) if z2_counts[k] == 0]
    missing += [k for k in set().union(*ZOO2_PER_STEP.values()) if z2_train_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on Z2's paths: {missing}")
    emit({"phase": "Z2", "seconds": time.perf_counter() - t_z2})

def empty_noise_mask_step(run_cfg, batches, dev, card, step) -> None:
    """Phase S, after the n2r_unet run: one consistency step, from a fresh
    model of the run's config, on one of the run's consistency batches with
    its noisier input masked to nothing. The config's noise std is 0, so that
    is what its n2r masker draws with probability 0.2, and from the init's
    zero biases the second forward predicts exactly 0: the loss, the gradient
    norm and every parameter after the step must be finite (the magnitude's
    gradient at 0, train/losses.py:_mag). ``step`` is the package's own
    ``Trainer.training_batch``: phase S records the runs' steps in its place."""
    import torch

    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.train.trainer import Trainer

    model_cfg = run_cfg["model"]
    batch = next(b for b in batches if "n2r_masked_kspace" in b
                 and not any(a.get("n2r_supervised", False) for a in b.get("attrs") or []))
    batch = dict(batch, n2r_masked_kspace=batch["n2r_masked_kspace"] * 0, n2r_mask=batch["n2r_mask"] * 0)
    trainer = Trainer(build_model(model_cfg, device=dev), optim_cfg=model_cfg["optim"],
                      trainer_cfg={"n2r_loss_weight": float(model_cfg["n2r_loss_regularization_factor"])},
                      loss_type=model_cfg["train_loss_fn"], device=dev,
                      loss_regularization_factor=float(model_cfg["reconstruction_loss_regularization_factor"]))
    trainer.setup_optimization()
    y, sens, _, init_pred = trainer._model_inputs(batch)
    with torch.no_grad():
        noisy = trainer.model(y * 0, sens, trainer._tensor(batch["n2r_mask"]), init_pred).prediction
    out = step(trainer, batch)
    rec = {"s": "n2r_unet_empty_noise_mask", "loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
           "noisy_prediction_max_abs": float(noisy.abs().max()),
           "parameters_finite": all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters()),
           "card": card}
    emit(rec)
    if not (np.isfinite([rec["loss"], rec["grad_norm"]]).all() and rec["parameters_finite"]):
        raise AssertionError(f"a consistency step on an empty noise mask: {rec}")


def selfsup_phase(dev, card, rows, masks) -> None:
    """Phase S: ``python -m mridc_tpu_torch run -c`` (``cli.main``) of
    projects/unselfsupervised/conf/base_ssdu_train.yaml (``ssdu_resnet``:
    ResNet 5 x 5 x 64, CG 10, mu 0, centered ortho, the k-space loss on the
    SSDU loss mask) and base_n2r_train.yaml (``n2r_unet``: UNet 32 channels x
    4 pools, a consistency step's two forwards) as written (``SSDU_CFG``,
    ``N2R_CFG``, given to the CLI as JSON text: the card has no PyYAML), at
    their batch size 1, one epoch cut to ``S_STEPS`` steps and ``S_VAL_LIMIT``
    validation batches, on the card. The h5 read is replaced as in phase L by
    phantom volumes (15 coils, 320x320; 3 training volumes, of which the
    dataset's rule makes one n2r-supervised, and 1 validation volume) with
    their premade poisson2d masks (acceleration 12, centre 0.7, scale 0.02);
    the transform draws the SSDU split and the noise masks itself. ms per
    step (between the starts of consecutive steps), slices/s, peak memory,
    launches per step against ``S_PER_STEP`` (an n2r step is supervised or a
    consistency step), the validations, and the run dir (``last``, the
    archive); then the host pipeline's ms per batch alone and one traced step
    by layer (the device's idle share beside the ms per step). Every step's
    loss and gradient norm must be finite; after the n2r run,
    ``empty_noise_mask_step``."""
    import json as json_mod
    import random
    import shutil
    import tempfile
    from unittest import mock

    import torch

    from mridc_tpu_torch import cli, kernels
    from mridc_tpu_torch.data import factory
    from mridc_tpu_torch.train.config import apply_overrides
    from mridc_tpu_torch.train.trainer import Trainer

    t_s = time.perf_counter()
    train = d_volumes("s", S_TRAIN_VOLUMES, S_SLICES, COILS, H, W, seed=31,
                      masks=[masks[("s", H, W, f"s_{i}.h5")].result()[0] for i in range(S_TRAIN_VOLUMES)])
    val = d_volumes("s_val", 1, S_VAL_SLICES, COILS, H, W, seed=32,
                    masks=[masks[("s", H, W, "s_val_0.h5")].result()[0]])
    vols = {"phantom/s/train": train, "phantom/s/val": val}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_selfsup_"))
    record = {"marks": [], "counts": [], "consistency": [], "outs": [], "trainer": None, "validations": []}
    step, validate = Trainer.training_batch, Trainer.validate

    def validating(self, *a, **kw):
        out = validate(self, *a, **kw)
        record["validations"].append(dict(out))
        return out

    def recording(self, batch):
        record["trainer"] = self
        record["consistency"].append("n2r_masked_kspace" in batch and not any(
            a.get("n2r_supervised", False) for a in batch.get("attrs") or []))
        record["marks"].append(time.perf_counter())
        before = kernels.launch_counts()
        out = step(self, batch)
        after = kernels.launch_counts()
        record["counts"].append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        record["outs"].append(out)
        return out

    def source(root, transform, n2r_supervised_rate=0.0, **_):
        # the dataset's rule (data/loaders.py): a seeded sample of the files
        files = sorted(vols[root])
        chosen = random.Random(1234).sample(files, int(np.round(n2r_supervised_rate * len(files)))) \
            if n2r_supervised_rate else []
        return PhantomSource(vols[root], transform, chosen)

    selfsup_counts = {k: 0 for k in kernels.launch_counts()}
    try:
        with mock.patch.object(factory, "ReconstructionMRIDataset", source), \
                mock.patch.object(Trainer, "training_batch", recording), \
                mock.patch.object(Trainer, "validate", validating):
            for run, cfg, yaml_name in (("ssdu_resnet", SSDU_CFG, "base_ssdu_train"),
                                        ("n2r_unet", N2R_CFG, "base_n2r_train")):
                cfg_path = tmp / f"{yaml_name}.json"
                cfg_path.write_text(json_mod.dumps(cfg))
                overrides = ["trainer.max_epochs=1", f"trainer.limit_train_batches={S_STEPS}",
                             f"trainer.limit_val_batches={S_VAL_LIMIT}",
                             'model.train_ds.data_path="phantom/s/train"',
                             'model.validation_ds.data_path="phantom/s/val"', f'exp_manager.exp_dir="{tmp / run}"']
                emit({"phase": "S", "run": run, "config": f"projects/unselfsupervised/conf/{yaml_name}.yaml",
                      "overrides": overrides, "batch": 1, "card": card})
                record.update(marks=[], counts=[], consistency=[], outs=[], trainer=None, validations=[])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                cli.main(["run", "-c", str(cfg_path), *overrides])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                for k, v in kernels.launch_counts().items():
                    selfsup_counts[k] += v
                trainer = record["trainer"]
                marks = record["marks"]
                ms = (marks[-1] - marks[0]) / (len(marks) - 1) * 1e3
                kinds = [S_PER_STEP["ssdu_resnet"] if run == "ssdu_resnet" else
                         S_PER_STEP[f"n2r_unet_{'consistency' if cons else 'supervised'}"]
                         for cons in record["consistency"]]
                bad = [(c, k) for c, k in zip(record["counts"], kinds) if c != k]
                run_dir = trainer.exp_manager.log_dir
                ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
                files = sorted(p.name for p in run_dir.iterdir())
                rec = {"s": run, "batch": 1, "steps": len(marks), "ms_per_step": ms, "slices_per_s": 1e3 / ms,
                       "steps_timed": len(marks) - 1, "seconds": seconds,
                       "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "launches_per_step": record["counts"],
                       "consistency_steps": sum(record["consistency"]),
                       "n2r_loss_weight": trainer.trainer_cfg.get("n2r_loss_weight"),
                       "losses": [float(o["loss"]) for o in record["outs"]],
                       "grad_norms": [float(o["grad_norm"]) for o in record["outs"]],
                       "validations": record["validations"],
                       "checkpoints": ckpts, "run_dir": files,
                       "note": "ms per step between the starts of consecutive steps: the plain loader's host pipeline "
                               "(the SSDU split, the noise masks) and the step, at the config's batch size 1",
                       "card": card}
                emit(rec)
                # where a step's time goes: the host pipeline alone (a fresh
                # iteration of the run's training loader), then one traced
                # step on one of its batches (the idle share: 1 - device ms /
                # ms per step)
                run_cfg = apply_overrides(cfg, overrides)
                loader = factory.build_dataloader(run_cfg["model"]["train_ds"], run_cfg["model"], shuffle=True,
                                                  device=dev)
                t0 = time.perf_counter()
                batches = [b for _, b in zip(range(S_STEPS), loader)]
                host_ms = (time.perf_counter() - t0) / len(batches) * 1e3
                traced = trace_call(lambda: step(trainer, batches[-1]), ms)
                emit({"trace": run, "host_pipeline_ms_per_batch": host_ms,
                      "device_idle_share": None if traced.get("device_ms") is None else 1 - traced["device_ms"] / ms,
                      **traced, "card": card})
                if run == "n2r_unet":
                    empty_noise_mask_step(run_cfg, batches, dev, card, step)
                del loader, batches
                if len(marks) != S_STEPS or bad:
                    raise AssertionError(f"{run}: {len(marks)} steps; launches per step, expected: {bad[:1]}")
                if not np.isfinite(rec["losses"] + rec["grad_norms"]).all():
                    raise AssertionError(f"{run}: losses {rec['losses']}, gradient norms {rec['grad_norms']}")
                if "last" not in ckpts or f"{cfg['exp_manager']['name']}.mridc" not in files:
                    raise AssertionError(f"{run}: run dir {files}, checkpoints {ckpts}")
                if len(rec["validations"]) != 2 or not all(np.isfinite(v) for val in rec["validations"]
                                                           for v in val.values()):
                    raise AssertionError(f"{run}: validations {rec['validations']} (the initial and the epoch's)")
                if run == "n2r_unet" and (trainer.trainer_cfg.get("n2r_loss_weight") != 0.1
                                          or not 0 < rec["consistency_steps"] < S_STEPS):
                    raise AssertionError(f"{run}: n2r loss weight {trainer.trainer_cfg.get('n2r_loss_weight')}, "
                                         f"{rec['consistency_steps']} consistency steps of {S_STEPS}")
                del trainer
                record["trainer"] = None
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in rows:
        r["selfsup_launches"] = selfsup_counts.get(r["name"], 0)
    missing = [k for k in set().union(*S_PER_STEP.values()) if selfsup_counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the self-supervised paths: {missing}")
    emit({"phase": "S", "seconds": time.perf_counter() - t_s})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import mridc_tpu_torch  # noqa: F401  (raises outside a checkout of the repository)

    t_start = time.perf_counter()
    # the poisson2d masks of D1-D3, drawn beside phases 2-V4, and of S, beside
    # Z and Z8 (module docstring)
    # at a lower priority than the kernel build and the phases they run beside
    mask_pool = ProcessPoolExecutor(max_workers=D2_TRAIN_VOLUMES + 1 + D1_VOLUMES,
                                    mp_context=multiprocessing.get_context("spawn"), initializer=os.nice,
                                    initargs=(10,))
    try:
        masks = {key: mask_pool.submit(poisson2d_mask, TRAIN_DS, *key[1:]) for key in
                 [("d2", H, W, f"d2_{i}.h5") for i in range(D2_TRAIN_VOLUMES)] + [("d2", H, W, "d2_val_0.h5")]
                 + [("d1", D1_HW, D1_HW, f"d1_{i}.h5") for i in range(D1_VOLUMES)]}

        def s_masks():
            # phase S's masks, drawn beside phases Z and Z8 (after the host-bound
            # phases that D's masks run beside)
            return {key: mask_pool.submit(poisson2d_mask, _S_DS, *key[1:]) for key in
                    [("s", H, W, f"s_{i}.h5") for i in range(S_TRAIN_VOLUMES)] + [("s", H, W, "s_val_0.h5")]}

        return run(t_start, masks, s_masks)
    finally:
        mask_pool.shutdown(cancel_futures=True)


def run(t_start, masks, s_masks) -> int:
    """Every phase; ``masks`` are the futures of D's poisson2d masks,
    ``s_masks()`` submits S's and returns their futures."""
    import torch

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

    # cuDNN's TF32 flag is left as PyTorch sets it (on): the package runs its
    # float32 convolutions in full float32 itself (phase 2b)
    torch.backends.cuda.matmul.allow_tf32 = False
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

    # 2b. the package's float32 convolutions run in full float32 whatever
    # cuDNN's TF32 flag says: with the flag on, a 3x3 conv (the VarNet's
    # 18 -> 36 channels at B=2, 160 x 160) forward and backward against float64
    # on the CPU; PyTorch's own conv under the same flag beside it
    check_tf32_rule(dev, card)

    def rand(*shape, dtype=torch.float32, positive=False):
        x = torch.rand(shape, generator=gen) if positive else torch.randn(shape, generator=gen)
        return x.to(dev, dtype)

    def cl(x):
        return x.contiguous(memory_format=torch.channels_last)

    errors = {}

    # 3. kernels against their plain versions on the card
    with torch.inference_mode():
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
                errors.setdefault("k2_mask", []).append(
                    check(f"k2_mask[{tag}]", k2.apply_mask(kk.clone(), mask, centered),
                          k2.apply_mask_plain(kk, mask, centered), *EXACT))
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

        # K2's expand, load and mask at the shapes their index arithmetic must
        # take: 34 x 38 centered (an odd column shift), an odd H with 7 coils
        # (coil groups of 3, 3 and 1) with and without the fftshift, the main
        # width; eta as channels 2:4 of a [B, H, W, 4] g (eta_stride 2), views
        # one pixel off 16 bytes, load with and without the mask; mask in place
        # on a fresh clone of an FFT output, by bench.py's 1D mask, by a
        # [B, 1, 1, W] row the wrapper broadcasts and by a mask of values in
        # [0, 1) (a product, not a select)
        for label, (b, c, h, w) in {"w38": (2, 3, 34, 38), "odd_h": (2, 7, 33, 40),
                                    "flagship_b2": (2, COILS, H, W)}.items():
            y, sens, mask = (t(a) for a in bench_data(b, c, h, w, seed=5))
            eta, g = rand(b, h, w, 2), rand(b, h, w, 4)
            for centered in (True, False):
                cu = "c" if centered else "u"
                for tag, e, s in (("eta", eta, sens), ("g_2:4", g[..., 2:], sens),
                                  ("eta_off", off_by_one_pixel(eta), sens), ("sens_off", eta, off_by_one_pixel(sens))):
                    errors.setdefault("k2_expand", []).append(check(
                        f"k2_expand[{label}/{cu}/{tag}]", k2.expand(e, s, centered), k2.expand_plain(e, s, centered),
                        *F32))
                for fftshift in (False, True):
                    for tag, yy, m in (("mask", y, mask), ("no_mask", y, None), ("y_off", off_by_one_pixel(y), mask)):
                        errors.setdefault("k2_load", []).append(check(
                            f"k2_load[{label}/{cu}{'/fftshift' if fftshift else ''}/{tag}]",
                            k2.load(yy, m, centered, fftshift), k2.load_plain(yy, m, centered, fftshift), *F32))
                kk = torch.fft.fft2(k2.expand_plain(eta, sens, centered), norm="ortho")
                soft = torch.rand((b, 1, h, w), generator=torch.Generator().manual_seed(7)).to(dev)
                for tag, m in (("mask", mask), ("row", mask[:, :, :1]), ("soft", soft)):
                    errors.setdefault("k2_mask", []).append(check(
                        f"k2_mask[{label}/{cu}/{tag}]", k2.apply_mask(kk.clone(), m, centered),
                        k2.apply_mask_plain(kk, m, centered), *EXACT))

        # K1 forward and backward at the edges of its tiles. bf16: 64 rows by
        # 64 columns, 64 by 32 where W > 320; f32: 32 by 32 up to W = 320, 16
        # by 32 with rings of 3 chunks up to W = 384 and of 2 up to W = 416,
        # the first version's kernel (32 x 64 blocks) above. One coil; a width that no
        # column tile divides (200); a height that no row tile divides (40);
        # the fastMRI widths on the narrower tiles: 368 (16-byte copies) and
        # 396 (bf16: W % 8 != 0, 4-byte copies of s_c and eta, plain operator
        # loads; f32: 2 stages); 640 in both dtypes (the wide routes, one block
        # a 32 x 64 tile: the operator is staged in chunks for every coil); bench.py's
        # 1D mask. Each dtype's launch setup and route are printed for each
        for label, (b, c, h, w) in {"one_coil": (2, 1, 64, 64), "w200": (2, COILS, 64, 200),
                                    "h40": (2, COILS, 40, 64), "w368": (1, 4, 48, 368),
                                    "w396": (1, 4, 48, 396), "w640": (1, 2, 40, 640),
                                    "w640_c4": (1, 4, 48, 640)}.items():
            y_e, sens_e, mask_e = (t(a) for a in bench_data(b, c, h, w, seed=6))
            operands = (rand(b, h, w, 2), sens_e, psf1d_gauss_mats(mask_e[:, 0, 0, :], True, "ortho"),
                        k2.sens_reduce_plain(y_e, sens_e, mask_e, True, "ortho"))
            for dt, tol in ((torch.float32, F32), (torch.bfloat16, K1_BF16)):
                args = [a.to(dt) for a in operands]
                sym = K1[dt]
                errors[sym].append(check(f"{sym}[{label}]", kernels.psf1d_dc(*args, 0.7),
                                         rounded_once(kernels.psf1d_dc_plain, *args, 0.7), *tol))
                check_k1_bwd(label, b, c, h, w, dt)
                if label == "w640_c4":  # the wide routes' times beside their bounds (forward; the
                    # backward reads g [.., 4] and writes [.., 2]: the same bytes but z0's)
                    es = args[0].element_size()
                    nbytes = es * (b * h * w * 2 + b * c * h * w * 2 + b * 3 * w * w + b * h * w * 2 + b * h * w * 4)
                    dname = str(dt).replace("torch.", "")
                    bms, by = bound(nbytes, {PRODUCTS[dname]: 6 * b * c * h * w * w, "float32": 17 * b * c * h * w})
                    bargs = (rand(b, h, w, 4).to(dt), args[1], args[2], 0.7)
                    emit({"kernel": sym, "route": "wide", "shape": [b, c, h, w],
                          "ms": time_ms(lambda: kernels.psf1d_dc(*args, 0.7)),
                          "plain_ms": time_ms(lambda: kernels.psf1d_dc_plain(*args, 0.7)),
                          "bwd_ms": time_ms(lambda: k1mod.psf1d_dc_bwd(*bargs)),
                          "bwd_plain_ms": time_ms(lambda: k1mod.psf1d_dc_bwd_plain(*bargs)),
                          "bound_ms": bms, "bound_by": by, "card": card})
            emit({"k1_f32_launch": label, "shape": [b, c, h, w], **k1mod.f32_setup(b, h, w, dev), "card": card})
            emit({"k1_bf16_launch": label, "shape": [b, c, h, w], **k1mod.bf16_setup(b, h, w, dev), "card": card})

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

        # K3 at widths and input kernels its kernels refused before their calls
        # were split (kernels.k3_indrnn.plan: out-channel chunks, in-channel
        # chunks in the backward, zero padding, a larger input kernel's patch
        # channels): bf16 48 -> 200 (out-channels past 128), float32 64 -> 300
        # (past 256), bf16 320 -> 64 (the backward's in-channels past 256), and
        # a 3x3 input kernel at dilation 2, 64 -> 64, at the flagship's B=2
        # 320x320 (576 patch channels). Forward through kernels.indrnn against
        # the plain cell; backward through indrnn_bwd on the gathered patch
        # channels autograd hands it; each call's launches are its plan's, and
        # each planned backward launch's route is the one k3_indrnn_bwd_setup
        # reports
        for label, (dt, ci, fo, k, dil, (b, h, w)) in {
            "bf16_48->200": (torch.bfloat16, 48, 200, 1, 1, (2, 33, 35)),
            "f32_64->300": (torch.float32, 64, 300, 1, 1, (2, 33, 35)),
            "bf16_320->64": (torch.bfloat16, 320, 64, 1, 1, (2, 33, 35)),
            "f32_3x3_d2_64->64": (torch.float32, 64, 64, 3, 2, (2, H, W)),
            "bf16_3x3_d2_64->64": (torch.bfloat16, 64, 64, 3, 2, (2, H, W)),
        }.items():
            plan = k3mod.plan(dt, ci, fo, k)
            bwd_dt = getattr(torch, plan.bwd_dtype)  # float32 for a bf16 cell split by out-channels
            routes = [k3mod.bwd_setup(bwd_dt, b * h * w, c1 - c0, f1 - f0, dev)["route"]
                      for (f0, f1), (c0, c1), _ in plan.bwd]
            emit({"k3_plan": label, "shape": [b, ci, h, w], **plan.as_dict(), "bwd_setup_routes": routes,
                  "card": card})
            if routes != [r for *_, r in plan.bwd] or plan.f_pad != fo:
                raise AssertionError(f"k3 plan {label}: routes {routes} on the card, plan {plan.as_dict()}")
            tol = F32 if dt == torch.float32 else K3_BF16
            x, hprev = cl(rand(b, ci, h, w)).to(dt), cl(rand(b, fo, h, w, positive=True)).to(dt)
            wt, bias = (rand(fo, ci, k, k) / np.sqrt(ci * k * k)).to(dt), (rand(fo) * 0.1).to(dt)
            hh = rand(1, fo, 1, 1, positive=True).to(dt)
            binding.reset_launch_counts()
            got = kernels.indrnn(x, hprev, wt, bias, hh, dilation=dil)
            launched = kernels.launch_counts()[K3[dt]]
            errors.setdefault(K3[dt], []).append(check(f"{K3[dt]}[{label}]", got, rounded_once(
                kernels.indrnn_plain, x, hprev, wt, bias, hh, dil), *tol))
            xp, wp = k3mod._patches(x, wt, dil, plan.ci_pad) if (k > 1 or plan.ci_pad != ci) else (x, wt)
            out, g = cl(torch.relu(rand(b, fo, h, w))).to(dt), cl(rand(b, fo, h, w)).to(dt)
            binding.reset_launch_counts()
            check_k3_bwd(label, (g, cl(xp), hprev, out, wp, hh))
            launched_bwd = kernels.launch_counts()[K3_BWD[bwd_dt]]
            emit({"k3_plan_launches": label, "forward": launched, "backward": launched_bwd, "card": card})
            # times beside bounds: the forward as a call of the cell (gather,
            # padding and chunks included) reads x and h and writes h'; the
            # backward on the patch channels reads x, h, h' and g and writes dx
            # and dh; products on the dtype's tensor-core route
            es, p_ = x.element_size(), b * h * w
            fwd_bound = bound(es * p_ * (ci + 2 * fo), {PRODUCTS[plan.dtype]: 2 * p_ * plan.ci * fo})
            bwd_bound = bound(es * p_ * 2 * (plan.ci_pad + 2 * fo), {PRODUCTS[plan.dtype]: 4 * p_ * plan.ci * fo})
            bargs = (g, cl(xp), hprev, out, wp, hh)
            emit({"kernel": f"k3_plan[{label}]", "ms": time_ms(lambda: kernels.indrnn(
                      x, hprev, wt, bias, hh, dilation=dil), iters=5, warmup=1),
                  "plain_ms": time_ms(lambda: kernels.indrnn_plain(x, hprev, wt, bias, hh, dil), iters=5, warmup=1),
                  "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                  "bwd_ms": time_ms(lambda: k3mod.indrnn_bwd(*bargs), iters=5, warmup=1),
                  "bwd_plain_ms": time_ms(lambda: k3mod.indrnn_bwd_plain(*bargs), iters=5, warmup=1),
                  "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1], "launches": list(plan.launches),
                  "card": card})
            del got, x
            if (launched, launched_bwd) != plan.launches:
                raise AssertionError(f"k3 plan {label}: launched {(launched, launched_bwd)}, planned {plan.launches}")
            del xp, wp, out, g
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

    def row(sym, source, replaces, fn, plain, args, nbytes, flops, tol, launches=None, per="forward", library=None,
            extra=None):
        # the oracle first: k2_residual overwrites its first operand; tol None:
        # the caller has checked the kernel
        if tol is not None:
            want = rounded_once(plain, *args)
            errors.setdefault(sym, []).append(check(f"{sym}[main_b{args[0].shape[0]}]", fn(*args), want, *tol))
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(lambda: plain(*args))
        library_ms = None if library is None else time_ms(library)
        if extra is not None and library is not None:
            lib = traced_kernel_ms(library)
            extra.update(library_traced_device_ms=lib["traced_device_ms"], library_traced_kernels=lib["traced_kernels"])
        bound_ms, by = bound(nbytes, flops)
        table = PER_FORWARD if per == "forward" else PER_STEP
        rows.append({"name": sym, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": (main_counts if launches is None else launches).get(sym, 0),
                     "max_abs_err": max(errors[sym]), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms})
        emit({"kernel": sym, "shape": tuple(args[0].shape), "dtype": str(args[0].dtype), "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
              "flops": flops,
              f"launches_per_{per}": {r: table[r].get(sym, 0) for r in table}, **(extra or {}), "card": card})

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
        # bytes: what each stage must read and write once; a few flops per
        # element. library_ms: the one PyTorch call that computes the stage's
        # function in the uncentered order (no shift) on these operands:
        # expand a complex mul, load a mul by the mask, reduce
        # linalg.vecdot(s, P, dim=1) = sum_c conj(s_c) P_c (reduce's [eta,
        # grad] concatenation left out); residual, m * (k - y), takes two
        # expand and load also print their ms at sh = 0 (``ms_sh0``: the order
        # library_ms computes in) and the device time a call in a trace of 20
        # calls, theirs (``traced_device_ms``: ``ms`` less it is the gap the
        # wrapper's host work leaves) and the library call's
        # (``library_traced_device_ms``): device time against device time
        sens_cx, y_cx, eta_cx = (torch.view_as_complex(a) for a in (sens, y, eta))
        row("k2_expand", src, rep, k2.expand, k2.expand_plain, (eta, sens, True),
            2 * coil + b * hw * 8, {"float32": 6 * b * c * hw}, F32,
            library=lambda: torch.mul(eta_cx.unsqueeze(1), sens_cx),
            extra={"ms_sh0": time_ms(lambda: k2.expand(eta, sens, False)),
                   **traced_kernel_ms(lambda: k2.expand(eta, sens, True), "expand_kernel")})
        row("k2_residual", src, rep, k2.residual, k2.residual_plain, (k_c, y, mask, True),
            3 * coil + b * hw * 4, {"float32": 4 * b * c * hw}, F32)
        row("k2_reduce", src, rep, k2.reduce, k2.reduce_plain, (p_c, sens, eta, True),
            2 * coil + b * hw * 8 + b * hw * 16, {"float32": 8 * b * c * hw}, F32,
            library=lambda: torch.linalg.vecdot(sens_cx, p_c, dim=1))
        row("k2_load", src, "mridc_tpu/nn/dc.py:59 (sens_reduce)", k2.load, k2.load_plain, (y, mask, True),
            2 * coil + b * hw * 4, {"float32": 2 * b * c * hw}, F32, library=lambda: torch.mul(y_cx, mask),
            extra={"ms_sh0": time_ms(lambda: k2.load(y, mask, False)),
                   **traced_kernel_ms(lambda: k2.load(y, mask, True), "load_kernel")})
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
    # the soft-DC tail (no_dc false; stack_intermediates off, so that the loss
    # reads the tail's output and its backward runs: SENSE expand and reduce)
    tail = {"no_dc": False, "stack_intermediates": False}
    for mode, extra in (("psf1d", {}), ("full", {}), ("full_soft_dc", tail)):
        cfg = dict(small, dc_mode=mode.split("_")[0], remat_mode="step+cascade", **extra)
        res = {}
        for where in (DEVICE, "cpu"):
            model = build_model(cfg, device=where)
            # the tail's weights: 0.7 and 0.9
            model.load_state_dict({**state_small, **{f"cirim.{i}.dc_weight": torch.tensor([0.7 + 0.2 * i])
                                                     for i in range(small["num_cascades"]) if extra}})
            trainer = Trainer(model, optim_cfg=TRAIN_OPTIM, trainer_cfg=TRAIN_CFG, device=where)
            loss = trainer.training_batch(small_batch)["loss"]
            # the cascades chain detached: with the tail's output as the loss's
            # input, only the last cascade's parameters take a gradient
            res[where] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None},
                          {k: p.detach().cpu() for k, p in model.named_parameters()})
        (l_dev, g_dev, p_dev), (l_cpu, g_cpu, p_cpu) = res[DEVICE], res["cpu"]
        if sorted(g_dev) != sorted(g_cpu) or (extra and f"cirim.{small['num_cascades'] - 1}.dc_weight" not in g_dev):
            raise AssertionError(f"train_small[{mode}]: gradients for {sorted(g_dev)} on the card, "
                                 f"{sorted(g_cpu)} on the CPU")
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
        # mask prints what expand and load print in phase 6, timed on a copy of
        # k_c (it works in place; the 0/1 mask leaves repeated products
        # unchanged), and the in-place library call on a line of its own
        k_t = k_c.clone()
        row("k2_mask", src, rep, k2.apply_mask, k2.apply_mask_plain, (k_c, mk, centered),
            2 * coil + b * hw * 4, {"float32": 2 * b * c * hw}, EXACT, train_counts, "step",
            library=lambda: torch.mul(k_c, mk),
            extra={"ms_sh0": time_ms(lambda: k2.apply_mask(k_t, mk, False)),
                   **traced_kernel_ms(lambda: k2.apply_mask(k_t, mk, centered), "mask_kernel")})
        emit({"kernel": "k2_mask", "yardstick": "k.mul_(mask), in place", "ms": time_ms(lambda: k_t.mul_(mk)),
              **traced_kernel_ms(lambda: k_t.mul_(mk)), "card": card})
        del k_t
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

    # V1-V4. E2EVN/VarNet (the CIRIM phases' operands freed first, so that
    # V3's peak memory is the VarNet step's own)
    t_vn = time.perf_counter()
    captured.clear()
    del k3_args, eta, mats, z0, y, sens, mask, target8, g, sk, mk, x, hprev, out, wt, hh, args
    torch.cuda.empty_cache()
    varnet_phases(dev, card, rows)
    emit({"phase": "varnet", "seconds": time.perf_counter() - t_vn})

    # D1-D3. training and evaluating from a dataset
    d2_recs = data_phases(dev, card, rows, state, state_small, small, {r["run"]: r for r in train_recs}, masks)

    # L. the launch path: training from the config file at full width
    launch_phase(dev, card, rows, masks, d2_recs)

    # Z, Z8. the zoo: ZF, ProximalGradient, UNet and ResNet serving and training,
    # beside the draws of S's masks
    masks.update(s_masks())
    zoo_phases(dev, card, rows)

    # Z2. CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet and DUNet serving
    # and training, and live BatchNorm card-vs-CPU
    zoo2_phase(dev, card, rows)

    # S. the self-supervised branches from their config files
    selfsup_phase(dev, card, rows, masks)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
