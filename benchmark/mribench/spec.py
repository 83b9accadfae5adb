"""A cell as ``BENCHMARK.json`` defines it, with what its names point to.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by name: ``benchmark/configs/<config>.json``
(the file that ``configs[].file`` gives), ``benchmark/traffic/<traffic>.json``,
``benchmark/limits/<workload>.json`` (the limits of the numbers compared),
``benchmark/metrics/<metric>.py`` (a reader with ``read(ctx)``), and the
configuration's model module ``benchmark/mribench/models/<model>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "Cell", "load_benchmark", "load_cell", "metric_reader"]


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict  # the configuration file
    mix: dict  # the traffic mix file
    limits: dict  # the limits file: {number: limit}
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # and with --trace 1
    model: object  # the configuration's model module

    @property
    def serving(self) -> bool:
        return self.mix["mode"] == "serve"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())
    model = importlib.import_module(f"mribench.models.{cfg['benchmark_model']}")
    return Cell(name=workload, chips=int(w["chips"]), cfg=cfg, mix=mix, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)], model=model)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def limits_of(cell: Cell) -> Dict[str, float]:
    return {k: float(v["limit"]) for k, v in cell.limits["numbers"].items()}
