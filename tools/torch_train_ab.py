#!/usr/bin/env python3
"""Time flagship CIRIM training steps, or serving forwards, of two checkouts
of the port, in turns, on one card.

Each side runs in its own process (its own copy of ``mridc_tpu_torch``, its
kernels built from its own sources). Training: ``Trainer`` steps of
chip_smoke.py's flagship at B=8 with the DC in a given ``dc_mode`` (f32,
remat step+cascade), 2 warm-up and 5 timed. ``--serve``: chip_smoke.py's
phase 5 forwards instead (``bf16_psf1d``, ``f32_psf1d``, ``f32_full``: the
flagship at B=8 with phase 5's weights), 2 warm-up and 10 timed each under
``torch.inference_mode``. Host clock around synchronised steps beside the
CUDA-event time. Rounds alternate baseline, change, change, baseline.
``--global-tf32-off`` also runs both with cuDNN's TF32 flag set off before
their steps (a checkout that does not hold its float32 convolutions'
precision itself runs them in TF32 otherwise).

    python3 tools/torch_train_ab.py --baseline DIR [--dc-mode full] [--rounds 2] [--global-tf32-off] [--trace]
    python3 tools/torch_train_ab.py --baseline DIR --serve [--rounds 12]

DIR holds another checkout (its ``mridc_tpu_torch`` and ``chip_smoke.py``),
e.g. ``git archive`` of the parent commit unpacked into a directory that
.gitignore lists. Prints one JSON line per side, round and run, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import cirim_params_from_jax
if sys.argv[3] == "1":
    torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
cfg = cs.flagship_cfg(compute_dtype=None, dc_mode=sys.argv[2])
model = build_model(cfg, device=dev)
model.load_state_dict(cirim_params_from_jax(cs.jax_layout_tree(cs.flagship_cfg(), seed=0, gain=cs.MAIN_GAIN)))
y, sens, mask = (torch.from_numpy(a).to(dev) for a in cs.bench_data(cs.BATCH, cs.COILS, cs.H, cs.W))
batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask,
         "target": torch.from_numpy(cs.train_target(cs.BATCH, cs.H, cs.W)).to(dev)}
trainer = Trainer(model, optim_cfg=cs.TRAIN_OPTIM, trainer_cfg=cs.TRAIN_CFG, device=dev)
for _ in range(2):
    trainer.training_batch(batch)
torch.cuda.synchronize()
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
t0 = time.perf_counter()
start.record()
for _ in range(5):
    trainer.training_batch(batch)
end.record()
torch.cuda.synchronize()
rec = {"wall_ms_per_step": (time.perf_counter() - t0) / 5 * 1e3, "event_ms_per_step": start.elapsed_time(end) / 5}
if sys.argv[4] == "1":
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.training_batch(batch)
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by.get(e.name[:100], (0.0, 0))
            by[e.name[:100]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rec["kernels_ms_calls"] = sorted(([k, round(v[0], 3), v[1]] for k, v in by.items()), key=lambda r: -r[1])[:25]
print(json.dumps(rec))
"""

SERVE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from mridc_tpu_torch import kernels
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.utils.params import cirim_params_from_jax
torch.backends.cuda.matmul.allow_tf32 = False
kernels.build()
dev = torch.device("cuda")
state = cirim_params_from_jax(cs.jax_layout_tree(cs.flagship_cfg(), seed=0, gain=cs.MAIN_GAIN))
y, sens, mask = (torch.from_numpy(a).to(dev) for a in cs.bench_data(cs.BATCH, cs.COILS, cs.H, cs.W))
runs = {"bf16_psf1d": {}, "f32_psf1d": {"compute_dtype": None}, "f32_full": {"compute_dtype": None, "dc_mode": "full"}}
out = {}
for name, over in runs.items():
    model = build_model(cs.flagship_cfg(stack_intermediates=False, **over), device=dev)
    model.load_state_dict(state)
    with torch.inference_mode():
        for _ in range(2):
            model(y, sens, mask)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(10):
            model(y, sens, mask)
        end.record()
        torch.cuda.synchronize()
    out[name] = {"wall_ms_per_forward": (time.perf_counter() - t0) / 10 * 1e3,
                 "event_ms_per_forward": start.elapsed_time(end) / 10}
    del model
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def serve(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", SERVE_CHILD, str(root)], capture_output=True, text=True, check=True,
                         cwd=root)
    return json.loads(out.stdout.strip().splitlines()[-1])


def run(root: Path, dc_mode: str, tf32_off: bool, trace: bool) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(root), dc_mode, "1" if tf32_off else "0",
                          "1" if trace else "0"],
                         capture_output=True, text=True, check=True, cwd=root)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--dc-mode", default="full", choices=("full", "psf1d"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--global-tf32-off", action="store_true")
    ap.add_argument("--trace", action="store_true", help="also list one traced step's kernels (ms, calls)")
    ap.add_argument("--serve", action="store_true", help="time phase 5's serving forwards instead of training steps")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sides = [("baseline", args.baseline.resolve(), False), ("change", ROOT, False)]
    if args.global_tf32_off:
        sides = [("baseline_global_tf32_off", args.baseline.resolve(), True), *sides,
                 ("change_global_tf32_off", ROOT, True)]
    for r in range(args.rounds):
        for name, root, off in (sides if r % 2 == 0 else sides[::-1]):
            if args.serve:
                for run_name, rec in serve(root).items():
                    print(json.dumps({"round": r, "side": name, "run": run_name, **rec, "card": card}), flush=True)
                continue
            print(json.dumps({"round": r, "side": name, "dc_mode": args.dc_mode,
                              **run(root, args.dc_mode, off, args.trace and r == 0),
                              "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
