"""BENCHMARK.json against the benchmark's contract, and every name it gives
against the files the harness finds by it."""

import json
import re

import pytest
from mribench.spec import BENCH, ROOT, load_benchmark, load_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per|channels"
                   r"|filters")

B = load_benchmark()


def test_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"] and len(B["command"]) <= 32
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in B["paths"])
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in B[kind]]
    assert len(set(names)) == len(names)
    for e in B[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_configs():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in B["workloads"])
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])


def test_workloads_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert all(w["chips"] in (1, 4) for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_end_to_end_bounds():
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        cell = load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]


def test_per_layer_moves_are_reported():
    """Each per-layer metric's cells report the end-to-end metric it moves,
    and one layer name is spelt one way."""
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_found_by_name():
    for w in B["workloads"]:
        cell = load_cell(w["name"])
        assert cell.limits["numbers"], w["name"]
        assert cell.mix["mode"] in ("serve", "train")
    for m in B["per_layer"]:
        assert callable(metric_reader(m["name"]))
    for f in BENCH.rglob("*"):
        if f.is_file() and ".cache" not in f.parts and "__pycache__" not in f.parts:
            assert PATH.match(str(f.relative_to(ROOT))), f


def test_run_seconds_budget():
    """A full check of 24 cells at this length, 14 runs a cell of run_seconds + 60 s each, fits 12 hours."""
    cells = 24
    assert (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
