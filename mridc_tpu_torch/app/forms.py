"""Schema-driven per-model parameter forms for the run-builder app
(counterpart of ``mridc_tpu/app/forms.py``; reference: mridc/app/run.py:24-304).

The model's base YAML supplies defaults and grouping, the structured schemas
(``train/schemas.py``) supply types and the full optional key surface, and
the port's registries supply the choice lists (optimizers, schedulers, mask
types, model names and the model knobs), the same fields and choices as the
JAX package's form: the port validates the same keys.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from mridc_tpu_torch.app.core import flatten_config, load_defaults

__all__ = ["form_spec"]


_GROUP_ORDER = [
    ("model", "Model hyperparameters"),
    ("model.optim", "Optimizer"),
    ("model.optim.sched", "LR schedule"),
    ("model.train_ds", "Training data"),
    ("model.validation_ds", "Validation data"),
    ("model.test_ds", "Test data"),
    ("trainer", "Trainer"),
    ("exp_manager", "Experiment manager"),
    ("", "Run"),
]


def _group_of(dotkey: str) -> str:
    """Longest matching group prefix for a flattened key."""
    best = ""
    for prefix, _ in _GROUP_ORDER:
        if prefix and (dotkey == prefix or dotkey.startswith(prefix + ".")):
            if len(prefix) > len(best):
                best = prefix
    return best


def _schema_types() -> Dict[str, Any]:
    """dotkey-prefix -> {key: allowed types} from the structured schemas."""
    from mridc_tpu_torch.train import schemas as s

    return {
        "trainer": s.TRAINER_KEYS,
        "model.optim": s.OPTIM_KEYS,
        "model.optim.sched": s.SCHED_KEYS,
        "exp_manager": s.EXP_MANAGER_KEYS,
        "exp_manager.checkpoint_callback_params": s.CHECKPOINT_KEYS,
        "exp_manager.ema": s.EMA_KEYS,
    }


def _type_name(allowed) -> str:
    if allowed is object:
        return "yaml"
    if isinstance(allowed, tuple):
        if bool in allowed and len(allowed) == 1:
            return "bool"
        if str in allowed and len(allowed) == 1:
            return "string"
        if all(t in (int, float, bool) for t in allowed):
            return "number"
        if list in allowed or tuple in allowed:
            return "yaml"
    if allowed is dict:
        return "yaml"
    return "yaml"


def _infer_from_value(value: Any) -> str:
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, (int, float)):
        return "number"
    if isinstance(value, str):
        return "string"
    return "yaml"


def _choices_for(dotkey: str) -> Optional[List[str]]:
    leaf = dotkey.rsplit(".", 1)[-1]
    if dotkey == "model.model_name":
        from mridc_tpu_torch.models import available_models

        return available_models()
    if dotkey == "model.optim.name":
        from mridc_tpu_torch.train.optim import AVAILABLE_OPTIMIZERS

        return sorted(AVAILABLE_OPTIMIZERS)
    if dotkey == "model.optim.sched.name":
        from mridc_tpu_torch.train.schedulers import AVAILABLE_SCHEDULERS

        return sorted(AVAILABLE_SCHEDULERS)
    if leaf == "type" and ".mask_args." in dotkey:
        from mridc_tpu_torch.data.subsample import MASKER_NAMES

        return sorted(MASKER_NAMES)
    if dotkey == "mode":
        return ["train", "test"]
    # model knobs: the lists mirror the validators (models/recon/cirim.py
    # remat_mode, data/transforms.py normalization); lane_fold is accepted
    # and ignored, as every config key the JAX package takes
    knob_choices = {
        "compute_dtype": ["", "bfloat16"],
        "dc_mode": ["full", "psf1d"],
        "lane_fold": ["auto", "always", "never"],
        "remat_mode": ["step+cascade", "cascade", "step", "none"],
        "coil_combination_method": ["SENSE", "RSS"],
        "fft_normalization": ["backward", "ortho", "forward"],
        "normalization_type": ["max", "mean", "minmax"],
    }
    if leaf in knob_choices:
        return knob_choices[leaf]
    return None


def _field(dotkey: str, default: Any, declared_type: Optional[str], from_schema: bool) -> Dict[str, Any]:
    ftype = declared_type or _infer_from_value(default)
    choices = _choices_for(dotkey)
    if choices is not None:
        ftype = "choice"
    return {
        "key": dotkey,
        "label": dotkey.rsplit(".", 1)[-1],
        "type": ftype,
        "default": default,
        "choices": choices,
        # schema-known keys absent from the base YAML render as optional
        # extras (the reference forms expose the full surface, run.py:24-304)
        "optional": from_schema,
    }


def form_spec(task: str, model: str, mode: str = "train") -> Dict[str, Any]:
    """Grouped, typed form description for (task, model, mode)."""
    cfg = load_defaults(task, model, mode)
    schema_types = _schema_types()

    groups: Dict[str, List[Dict[str, Any]]] = {prefix: [] for prefix, _ in _GROUP_ORDER}
    seen = set()
    for dotkey, value in flatten_config(cfg):
        group = _group_of(dotkey)
        declared = None
        for prefix, keys in schema_types.items():
            if dotkey.startswith(prefix + ".") and dotkey[len(prefix) + 1 :] in keys:
                declared = _type_name(keys[dotkey[len(prefix) + 1 :]])
                break
        groups.setdefault(group, []).append(_field(dotkey, value, declared, from_schema=False))
        seen.add(dotkey)

    # schema keys the YAML doesn't set: offer as optional fields so the form
    # covers the full configurable surface, not just the defaults file
    for prefix, keys in schema_types.items():
        if not any(k.startswith(prefix.split(".")[0]) for k in seen):
            continue  # e.g. run-mode configs without an optimizer block
        for key, allowed in sorted(keys.items()):
            if allowed is dict:
                continue  # sub-blocks are their own groups
            dotkey = f"{prefix}.{key}"
            if dotkey in seen:
                continue
            groups.setdefault(_group_of(dotkey), []).append(
                _field(dotkey, None, _type_name(allowed), from_schema=True)
            )

    out_groups = []
    for prefix, title in _GROUP_ORDER:
        fields = groups.get(prefix) or []
        if fields:
            out_groups.append({"prefix": prefix, "title": title, "fields": fields})
    return {"task": task, "model": model, "mode": mode, "groups": out_groups}
