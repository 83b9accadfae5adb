"""Config assembly behind the run-builder app (counterpart of
``mridc_tpu/app/core.py``; reference: mridc/app/run.py:2790-2833, export the
config, then ``mridc run -c <yaml>``).

The project config zoo (projects/<task>/conf/base_<model>_{train,run}.yaml)
supplies the defaults, the form is the flattened key space of that config,
user edits are dotlist overrides, and the structured schemas
(``train/schemas.py``) validate the result before it is exported (as JSON
text, which YAML readers read unchanged) and launched with
``python -m mridc_tpu_torch.launch``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from mridc_tpu_torch.train.config import load_config, loads, save_config
from mridc_tpu_torch.train.schemas import validate_config

__all__ = [
    "list_tasks",
    "list_models",
    "load_defaults",
    "flatten_config",
    "build_config",
    "export_config",
    "run_command",
    "launch_run",
]

_TASK_DIRS = {
    "reconstruction": "reconstruction",
    "segmentation": "segmentation",
    "quantitative": "quantitative",
    "multitask": "multitask",
}


def projects_root() -> Path:
    """The projects/ config zoo (override with MRIDC_PROJECTS_DIR)."""
    env = os.environ.get("MRIDC_PROJECTS_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "projects"


def list_tasks() -> List[str]:
    root = projects_root()
    return [t for t, d in _TASK_DIRS.items() if (root / d / "conf").is_dir()]


def list_models(task: str) -> List[Dict[str, Any]]:
    """Models available for a task, with their base config files and modes."""
    conf = projects_root() / _TASK_DIRS[task] / "conf"
    found: Dict[str, Dict[str, Any]] = {}
    for p in sorted(conf.glob("base_*.yaml")):
        stem = p.stem[len("base_") :]
        for suffix in ("_train", "_run"):
            if stem.endswith(suffix):
                name, mode = stem[: -len(suffix)], suffix[1:]
                break
        else:
            name, mode = stem, "train"
        entry = found.setdefault(name, {"name": name, "modes": {}, "display": None})
        entry["modes"][mode] = str(p)
    for entry in found.values():
        first = next(iter(entry["modes"].values()))
        try:
            cfg = loads(Path(first).read_text()) or {}
            entry["display"] = (cfg.get("model") or {}).get("model_name", entry["name"])
        except Exception:
            entry["display"] = entry["name"]
    return sorted(found.values(), key=lambda e: e["name"])


def load_defaults(task: str, model: str, mode: str = "train") -> Dict[str, Any]:
    """Base config for (task, model, mode); falls back to the other mode's file."""
    models = {m["name"]: m for m in list_models(task)}
    if model not in models:
        raise KeyError(f"No base config for model {model!r} in task {task!r}")
    modes = models[model]["modes"]
    path = modes.get(mode) or next(iter(modes.values()))
    cfg = load_config(path)
    cfg["mode"] = "train" if mode == "train" else "test"
    return cfg


def flatten_config(cfg: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """Depth-first (dotkey, value) pairs — the app's form field list. Lists
    are leaves (edited as YAML text)."""
    out: List[Tuple[str, Any]] = []
    for k, v in cfg.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(flatten_config(v, key))
        else:
            out.append((key, v))
    return out


def build_config(task: str, model: str, mode: str, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Defaults + user edits, schema-validated. ``overrides`` maps dotkeys to
    already-typed values (the server parses form text with YAML semantics)."""
    cfg = load_defaults(task, model, mode)
    for key, value in (overrides or {}).items():
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value
    validate_config(cfg)
    return cfg


def export_config(cfg: Dict[str, Any], export_dir: str, name: Optional[str] = None) -> Path:
    """Validate and write the config the run command reads (reference
    run.py:2799-2807 'Export Configuration')."""
    validate_config(cfg)
    model_name = str(((cfg.get("model") or {}).get("model_name", "run"))).lower()
    mode = cfg.get("mode", "train")
    fname = name or f"{model_name}_{mode}.yaml"
    if not fname.endswith((".yaml", ".yml")):
        fname += ".yaml"
    path = Path(export_dir) / fname
    save_config(cfg, path)
    return path


def run_command(config_path: str) -> List[str]:
    """The launch command for an exported config (shown to the user, as the
    reference's ``mridc run -c <yaml>`` code box, run.py:2825): the port's
    launcher."""
    p = Path(config_path)
    return [
        sys.executable,
        "-m",
        "mridc_tpu_torch.launch",
        "--config-path",
        str(p.parent),
        "--config-name",
        p.name,
    ]


def launch_run(config_path: str, log_path: Optional[str] = None) -> Tuple[subprocess.Popen, Path]:
    """Launch the run detached, stdout/stderr into ``log_path``; returns
    ``(process, log_path)`` (reference run.py:2829-2833 spawns a terminal
    running ``mridc run``)."""
    log = Path(log_path) if log_path else Path(config_path).with_suffix(".log")
    log.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", str(Path(__file__).resolve().parents[2]))
    with open(log, "ab") as handle:
        # the child keeps its own duplicated descriptor; closing the parent's
        # copy on exit of this block avoids leaking one fd per launched run
        proc = subprocess.Popen(run_command(config_path), stdout=handle, stderr=subprocess.STDOUT, env=env)
    return proc, log
