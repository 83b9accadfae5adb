"""Multirun sweep launcher (counterpart of ``mridc_tpu/utils/sweep.py``;
reference: mridc/core/utils/process_launcher/launcher.py:40-376
``ProcessLauncher``, N subprocess jobs over M cards through
``CUDA_VISIBLE_DEVICES`` slots, polled).

Jobs are dotlist override sets on a base config (the cartesian product of the
swept values), each run as ``python -m mridc_tpu_torch.launch`` in a process
of its own. With more than one slot each job sees only its slot's card
(``CUDA_VISIBLE_DEVICES``) unless the caller sets the visibility itself.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from mridc_tpu_torch.utils.logging import get_logger

logger = get_logger()

__all__ = ["expand_sweep", "launch_sweep"]


def expand_sweep(sweep: Dict[str, Sequence]) -> List[List[str]]:
    """{'model.lr': [1e-3, 1e-4], 'model.num_cascades': [2, 4]} ->
    dotlist override sets (cartesian product, hydra -m semantics)."""
    keys = list(sweep)
    return [[f"{k}={v}" for k, v in zip(keys, combo)] for combo in itertools.product(*sweep.values())]


def launch_sweep(
    config_path: str,
    config_name: str,
    sweep: Dict[str, Sequence],
    num_slots: int = 1,
    jobs_per_slot: int = 1,
    extra_env: Optional[Dict[str, str]] = None,
    poll_interval: float = 2.0,
) -> List[int]:
    """Run the sweep as subprocesses, at most num_slots*jobs_per_slot at once.

    Returns the list of return codes (job order)."""
    jobs = expand_sweep(sweep)
    num_slots = max(num_slots, 1)
    max_parallel = max(num_slots * jobs_per_slot, 1)
    running: List = []
    codes: List[Optional[int]] = [None] * len(jobs)
    next_job = 0
    # explicit free-slot pool (the reference ProcessLauncher keeps a free-GPU
    # queue; len(running) % num_slots collides after out-of-order finishes)
    slot_pool = [s for s in range(num_slots) for _ in range(max(jobs_per_slot, 1))]

    def spawn(idx: int, slot: int):
        env = dict(os.environ)
        env.update(extra_env or {})
        # per-slot device isolation (the reference's CUDA_VISIBLE_DEVICES
        # slots): each job sees only its card unless the caller sets the
        # visibility itself
        env["MRIDC_TPU_SWEEP_SLOT"] = str(slot)
        if num_slots > 1 and "CUDA_VISIBLE_DEVICES" not in (extra_env or {}):
            env["CUDA_VISIBLE_DEVICES"] = str(slot)
        cmd = [
            sys.executable,
            "-m",
            "mridc_tpu_torch.launch",
            "--config-path",
            str(config_path),
            "--config-name",
            str(config_name),
            *jobs[idx],
        ]
        logger.info(f"sweep job {idx} (slot {slot}): {' '.join(jobs[idx])}")
        return subprocess.Popen(cmd, env=env)

    while next_job < len(jobs) or running:
        while next_job < len(jobs) and len(running) < max_parallel and slot_pool:
            slot = slot_pool.pop(0)
            running.append((next_job, slot, spawn(next_job, slot)))
            next_job += 1
        still = []
        for idx, slot, proc in running:
            rc = proc.poll()
            if rc is None:
                still.append((idx, slot, proc))
            else:
                codes[idx] = rc
                slot_pool.append(slot)
                logger.info(f"sweep job {idx} finished with code {rc}")
        running = still
        if running:
            time.sleep(poll_interval)
    return [c if c is not None else -1 for c in codes]
