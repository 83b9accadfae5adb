#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size, many
seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control] [--faults] [--first N] [--seconds 3]

For each seed: the program's numbers (serving: a short window at the cell's
load, sampling as many answers as a run compares; training: the three
checked steps through the window's call), then with ``--control`` the
reference itself in the program's place at the precision below the one the
configuration states (float32: TF32; bfloat16: fp8), and with ``--faults``
(training) the program fed half of each batch, the mean taken over the rest.
Each is compared with the float32 reference as a run compares it. One JSON
line a seed, and a last line with the largest program reading and the
smallest control and fault readings of each number. The benchmark's runs do
not run this.
"""

from __future__ import annotations

import json
import os
import sys
import time


def readings(cell, seeds, seconds: float, control: bool, faults: bool, device, first: int = 0):
    """One record a seed (see the module), then the summary; ``first`` > 0
    takes the control and the faults on the first ``first`` seeds only."""
    import numpy as np
    import torch

    from mribench import cell as C
    from mribench import checks
    from mribench.traffic import Pool, seed_stream
    from reference.common import Precision

    below = "fp8" if str(C.program_config(cell).get("compute_dtype") or "float32") == "bfloat16" else "tf32"
    summary = {"program": {}, "control": {}, "half_batch": {}}
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        control_here = control and (first <= 0 or n < first)
        faults_here = faults and (first <= 0 or n < first)
        pcfg, weights, pool, program = C.setup(cell, seed, device)
        rec = {"seed": seed}
        if cell.serving:
            for i in range(int(cell.mix["warmup"])):
                program(pool.batch(i))
            win = C._window(program, pool, 0, seconds, int(cell.mix["sample_batches"]),
                            np.random.default_rng(seed_stream(seed, 2)))
            kept = win["kept"]
            program.trainer = None
            idx = [i for i, _ in kept]
            ref = C.reference_predictions(cell, pcfg, weights, pool, idx, Precision("float32"), device)
            rec["program"] = C.serving_numbers(kept, ref, int(cell.mix["batch"]))
            if control_here:
                ctl = C.reference_predictions(cell, pcfg, weights, pool, idx, Precision(below), device)
                as_host = [(i, torch.view_as_real(ctl[i]).cpu().numpy()) for i in idx]
                rec["control"] = C.serving_numbers(as_host, ref, int(cell.mix["batch"]))
        else:
            beta1 = float(cell.mix["train"]["optim"]["betas"][0])
            prog = C.first_steps(program, pool, beta1)
            program.trainer = None
            ref = C.reference_training(cell, pcfg, weights, pool, Precision("float32"), device)
            rec["program"] = checks.training_numbers(prog, ref)
            rec["program_worst_leaves"] = checks.worst_leaves(prog, ref)
            if control_here:
                ctl = C.reference_training(cell, pcfg, weights, pool, Precision(below), device)
                rec["control"] = checks.training_numbers(ctl, ref)
                rec["control_worst_leaves"] = checks.worst_leaves(ctl, ref)
            if faults_here:
                half = int(cell.mix["batch"]) // 2
                cut = Pool([{k: v[:half] for k, v in b.items()} for b in pool.batches])
                faulty = C.Program(cell, pcfg, weights, device)
                rec["half_batch"] = checks.training_numbers(C.first_steps(faulty, cut, beta1), ref)
                faulty.trainer = None
        rec["seconds"] = time.perf_counter() - t0
        yield rec
        for kind in summary:
            for k, v in rec.get(kind, {}).items():
                old = summary[kind].get(k)
                pick = max if kind == "program" else min
                summary[kind][k] = v if old is None else pick(old, v)
        del program, pool, weights
        if device.type == "cuda":
            torch.cuda.empty_cache()
    yield {"summary": summary, "control_precision": below}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Readings of a cell's correctness numbers over seeds.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--first", type=int, default=0, help="take the control and faults on the first N seeds only")
    a = p.parse_args(argv)
    bench = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [bench, os.path.dirname(bench)]

    import torch

    from mribench.spec import load_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from mridc_tpu_torch import kernels

    kernels.build()
    cell = load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    for rec in readings(cell, seeds, a.seconds, a.control, a.faults, torch.device("cuda"), a.first):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
