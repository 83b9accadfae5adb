#!/usr/bin/env python3
"""Benchmark of ``mridc_tpu_torch``, the PyTorch and CUDA port, on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on a machine with the card(s) the cell asks for:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (``benchmark/configs/<config>.json``) under a
traffic mix (``benchmark/traffic/<mix>.json``), with the limits of its
correctness check in ``benchmark/limits/<cell>.json``; each per-layer metric
is read by ``benchmark/metrics/<metric>.py``. Adding a cell, mix or metric
adds files and edits none.

A run makes its weights and inputs on the card from ``--seed``, builds the
program and warms it (set-up, ``setup_s``), measures ``--seconds`` of back
to back calls (the window), and with ``--trace 1`` profiles a few more calls
for the per-layer metrics. Once the window has closed and the program is
freed, the plain reference (``benchmark/reference``) recomputes what the
window produced, and the run prints each number compared beside its limit as
the last lines of standard error, and as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``platform``, ``kind``, ``count``, ``memory_peak_bytes``, the card's power
limit, and with ``--trace 1`` ``busy_s`` and ``window_s``), ``breakdown``
(``--trace 1``) and ``checks`` (last).

Caches: the package builds its CUDA kernels with nvcc into
``mridc_tpu_torch/_build/`` inside the checkout, so only the first run in a
checkout compiles; PyTorch's extension and Triton caches are pointed at
``benchmark/.cache/`` inside the checkout. A run reads and writes nothing
else but its ``HOME``, ``XDG_CACHE_HOME`` and ``TMPDIR``: no ``/dev/shm`` and
no fixed ``/tmp`` path. It starts no process but ``nvidia-smi``, which it
waits for.

A run fails, printing no result, without a CUDA device (or with fewer than
the cell asks for), outside a checkout that holds the package, and if JAX,
flax, optax, orbax, ml_dtypes or the JAX package ``mridc_tpu`` is loaded in
the process once the window has closed (compared by whole top-level module
name: ``mridc_tpu_torch`` is not ``mridc_tpu``).
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the wall clock (from /proc where it exists)."""
    try:
        ticks = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in open("/proc/stat") if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "mridc_tpu")


def loaded_forbidden(modules=None) -> list:
    """Top-level names of loaded modules that the run may not hold, compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    cache = os.path.join(BENCH, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    sys.path.insert(0, BENCH)
    sys.path.insert(1, os.path.dirname(BENCH))

    import json
    import math

    import torch

    from mribench.spec import load_cell

    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload}: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    from mridc_tpu_torch import kernels
    from mribench.cell import run

    kernels.build()  # nvcc into mridc_tpu_torch/_build on a checkout's first run; nothing after
    result = run(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), T_START)
    result["device"]["power_limit"] = _power_limit()
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 3
    print(f"setup phases (s): {json.dumps(result.pop('setup_phases_s'))}", file=sys.stderr)
    checks = result.pop("checks")
    for c in checks.values():  # JSON has no NaN or infinity
        c["value"] = c["value"] if math.isfinite(c["value"]) else str(c["value"])
    result["checks"] = checks  # the key that comes last
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
