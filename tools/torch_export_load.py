#!/usr/bin/env python3
"""Time loading an exported program with and without the deserializer's
memoised type hints (``mridc_tpu_torch/utils/export.py:_cached_type_hints``).

Exports chip_smoke.py's flagship CIRIM at its full depth (5 cascades x 8 time
steps, so the program has the full-size node count) but narrow (4 filters,
2 coils, 16x16, batch 1) on the CPU, then loads it ``--rounds`` times each
way, in turns. The load is host work: its time does not depend on the
widths. Prints one JSON line per load and the graph's node count.

    python3 tools/torch_export_load.py [--rounds 2] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None, help="directory for the .pt2 file (default: a temporary one)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    import mridc_tpu_torch.kernels  # noqa: F401  (registers the custom ops the program calls)
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.utils import export as ex

    cfg = cs.flagship_cfg(stack_intermediates=False, compute_dtype=None, dc_mode="full", conv_filters=[4, 4, 2],
                          recurrent_filters=[4, 4, 0])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    inputs = tuple(torch.from_numpy(a) for a in cs.bench_data(1, 2, 16, 16))
    path = Path(args.out or tempfile.mkdtemp(prefix="export_load_")) / "cirim_full_depth.pt2"
    t0 = time.perf_counter()
    ex.export_model(model, inputs, path)
    print(json.dumps({"export_s": time.perf_counter() - t0}), flush=True)
    ex._register_outputs()
    for r in range(args.rounds):
        for memo in (True, False):
            t0 = time.perf_counter()
            if memo:
                with ex._cached_type_hints():
                    program = torch.export.load(str(path))
            else:
                program = torch.export.load(str(path))
            print(json.dumps({"round": r, "memoised_type_hints": memo, "load_s": time.perf_counter() - t0,
                              "nodes": len(program.graph.nodes)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
