"""Config loading with dotlist overrides (counterpart of
``mridc_tpu/train/config.py``): ``load_config(path, overrides=["model.lr=1e-3",
"mode=test"])``, the ``model:/trainer:/exp_manager:/mode:`` layout of the
``projects/`` YAMLs and the ``key=value`` override syntax.

The port writes configs as JSON text (:func:`save_config`): JSON is a subset of
YAML, so ``yaml.safe_load`` and the JAX package's ``load_config`` read the files
unchanged, and a machine without PyYAML writes them. The readers try JSON
first, so files the port wrote, and override values that are JSON, need no
PyYAML; a YAML file or a YAML-only value imports it then.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

__all__ = ["load_config", "merge_dicts", "apply_overrides", "parse_value", "save_config", "maybe_update_config_version"]


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading YAML needs PyYAML (pip install pyyaml); JSON text reads without it") from e
    return yaml


def merge_dicts(base: Dict, update: Dict) -> Dict:
    """Recursive dict merge (update wins)."""
    out = copy.deepcopy(base)
    for k, v in (update or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_value(text: str) -> Any:
    """An override value with YAML semantics ('1e-3' -> float, 'null' -> None):
    JSON where the text is JSON (the same value YAML gives), else YAML."""
    try:
        return json.loads(text)
    except ValueError:
        pass
    yaml = _yaml()
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        # YAML 1.1 treats dot-less scientific notation ('1e-3') as a string
        try:
            return float(value)
        except ValueError:
            return value
    return value


def apply_overrides(cfg: Dict, overrides: Optional[Sequence[str]]) -> Dict:
    """Apply ``a.b.c=value`` dotlist overrides (a leading ``+`` is allowed);
    returns a new dict."""
    cfg = copy.deepcopy(cfg)
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override {item!r} is not of the form key=value")
        key, _, value = item.partition("=")
        node = cfg
        parts = key.strip().lstrip("+").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"Cannot override through non-dict key {p!r} in {key!r}")
        node[parts[-1]] = parse_value(value)
    return cfg


def maybe_update_config_version(cfg: Any) -> Any:
    """Recursively migrate legacy config layouts: ``cls`` -> ``_target_``, and
    the contents of a nested ``params`` block hoisted into the parent."""
    if not isinstance(cfg, dict):
        return cfg
    out = dict(cfg)
    if "cls" in out and "_target_" not in out:
        out["_target_"] = out.pop("cls")
    params = out.pop("params", None)
    if isinstance(params, dict):
        for k, v in params.items():
            out.setdefault(k, v)
    elif params is not None:
        out["params"] = params  # non-dict params: leave untouched
    return {k: maybe_update_config_version(v) if isinstance(v, dict) else v for k, v in out.items()}


def loads(text: str) -> Any:
    """A config document: JSON, else YAML."""
    try:
        return json.loads(text)
    except ValueError:
        return _yaml().safe_load(text)


def load_config(path: Union[str, Path], overrides: Optional[Sequence[str]] = None) -> Dict:
    cfg = loads(Path(path).read_text(encoding="utf-8")) or {}
    cfg = maybe_update_config_version(cfg)
    return apply_overrides(cfg, overrides)


def save_config(cfg: Dict, path: Union[str, Path]):
    """``cfg`` as JSON text (which YAML readers read unchanged)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(cfg, indent=2) + "\n", encoding="utf-8")
