#!/usr/bin/env python3
"""First-step training gradients of the flagship CIRIM in bf16 against float32,
on one NVIDIA GPU and on the CPU path, at chip_smoke.py's B=8 inputs.

For the flagship weights of ``chip_smoke.py`` (gain 0.3) and for its default
(flax-like) initialisation: the cosine between the whole parameter gradients
of the flagship in bf16 (compute and DC), in bf16 compute with a float32 DC,
and in float32, on the card and (gain 0.3 only) on the CPU path, where every
kernel runs its plain version; then the same cosines on the card for each of
the 8 slices alone, with each slice's float32 gradient norm.

    python3 tools/torch_train_grad_agreement.py

Run from the repository root. Prints the card's name and power limit, then
one JSON line per gradient and per comparison. The CPU part takes about ten
minutes on 8 cores.
"""

import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.utils.params import cirim_params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(8)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)
B = 8
y, s, m = (torch.from_numpy(a) for a in cs.bench_data(B, cs.COILS, cs.H, cs.W))
tgt = torch.from_numpy(cs.train_target(B, cs.H, cs.W))
cfgs = {"f32": cs.flagship_cfg(compute_dtype=None), "bf16_f32dc": cs.flagship_cfg(train_dc_dtype=None),
        "bf16": cs.flagship_cfg()}


def grads(cfg, state, where):
    model = build_model(cfg, device=where)
    model.load_state_dict(state)
    loss = process_reconstruction_loss(model(*(a.to(where) for a in (y, s, m)), train=True), tgt.to(where), "l1")
    loss.backward()
    return torch.cat([p.grad.flatten().double().cpu() for _, p in sorted(model.named_parameters())])


def cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


for label, gain, wheres in (("gain0.3", cs.MAIN_GAIN, ("cuda", "cpu")), ("default_init", None, ("cuda",))):
    state = cirim_params_from_jax(cs.jax_layout_tree(cs.flagship_cfg(), seed=0, gain=gain))
    for where in wheres:
        g = {}
        for name, cfg in cfgs.items():
            t0 = time.time()
            g[name] = grads(cfg, state, where)
            print(json.dumps({"weights": label, "where": where, "run": name, "s": time.time() - t0}), flush=True)
        print(json.dumps({"weights": label, "where": where, "B": B,
                          "bf16_vs_f32": cos(g["bf16"], g["f32"]),
                          "bf16dc_vs_f32dc": cos(g["bf16"], g["bf16_f32dc"]),
                          "bf16_f32dc_vs_f32": cos(g["bf16_f32dc"], g["f32"])}), flush=True)
        if where == "cuda":
            per = []
            for i in range(B):
                gi = {}
                for name in ("f32", "bf16", "bf16_f32dc"):
                    model = build_model(cfgs[name], device="cuda")
                    model.load_state_dict(state)
                    sl = [a[i : i + 1].cuda() for a in (y, s, m)]
                    process_reconstruction_loss(model(*sl, train=True), tgt[i : i + 1].cuda(), "l1").backward()
                    gi[name] = torch.cat([p.grad.flatten().double().cpu() for _, p in sorted(model.named_parameters())])
                per.append([cos(gi["bf16"], gi["f32"]), cos(gi["bf16"], gi["bf16_f32dc"]), float(gi["f32"].norm())])
            print(json.dumps({"weights": label, "per_slice_bf16_vs_f32__bf16dc_vs_f32dc__norm": per}), flush=True)
