"""Structured config validation for the trainer/optim/sched/exp_manager blocks
(counterpart of ``mridc_tpu/train/schemas.py``; pure Python, the same key
tables).

Typo'd or mistyped keys in these blocks fail loudly at load time instead of
being silently ignored: plain key/type tables over the config dicts
(``train/config.py``). The ``model:`` block itself is permissive (its keys are
per-model) except for the nested ``optim``/``sched`` blocks, which are
structural. Optimizer names are checked against the optimizers the port
builds (``train/optim.py``), every name the JAX package knows, so a config
validates alike in both packages.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["ConfigValidationError", "validate_config"]


class ConfigValidationError(ValueError):
    """A config block contains an unknown key or a value of the wrong type."""


_NUM = (int, float)
_BOOL = (bool,)
_STR = (str,)
_ANY = object  # unchecked


# key -> allowed types (None is always allowed; _ANY skips the type check).
# Includes every key the TPU Trainer consumes plus the reference
# TrainerConfig's PTL-era keys that are accepted (and mapped or ignored) for
# config compatibility (reference core/conf/trainer.py:17-70).
TRAINER_KEYS: Dict[str, Any] = {
    "max_epochs": _NUM,
    "max_steps": _NUM,
    "min_epochs": _NUM,
    "min_steps": _NUM,
    "gradient_clip_val": _NUM,
    "gradient_clip_algorithm": _STR,
    "accumulate_grad_batches": _NUM,
    "log_every_n_steps": _NUM,
    "check_val_every_n_epoch": _NUM,
    "val_check_interval": _NUM,
    "limit_train_batches": _NUM,
    "limit_val_batches": _NUM,
    "limit_test_batches": _NUM,
    "limit_predict_batches": _NUM,
    "n2r_loss_weight": _NUM,
    "num_nodes": _NUM,
    "devices": _ANY,
    "accelerator": _STR,
    "strategy": _ANY,
    "precision": _ANY,
    "profile_dir": _STR,
    "profile_start_step": _NUM,
    "profile_steps": _NUM,
    "logger": _ANY,
    "callbacks": _ANY,
    "default_root_dir": _STR,
    "enable_checkpointing": _BOOL,
    "enable_progress_bar": _BOOL,
    "enable_model_summary": _BOOL,
    "num_sanity_val_steps": _NUM,
    "resume_from_checkpoint": _STR,
    "benchmark": _BOOL,
    "deterministic": _BOOL,
    "detect_anomaly": _BOOL,
    "fast_dev_run": _ANY,
    "overfit_batches": _NUM,
    "track_grad_norm": _NUM,
    "sync_batchnorm": _BOOL,
    "replace_sampler_ddp": _BOOL,
    "reload_dataloaders_every_n_epochs": _NUM,
    "max_time": _ANY,
    "amp_backend": _STR,
    "amp_level": _STR,
    "plugins": _ANY,
    "move_metrics_to_cpu": _BOOL,
    "multiple_trainloader_mode": _STR,
    "gpus": _ANY,
    "tpu_cores": _ANY,
    "ipus": _ANY,
    "auto_select_gpus": _BOOL,
    "auto_lr_find": _ANY,
    "auto_scale_batch_size": _ANY,
    "profiler": _ANY,
    "seed": _NUM,
}

# reference core/conf/optimizers.py param families, flattened: the union of
# every optimizer's accepted kwargs (each optimizer builder rejects kwargs it
# does not take — this table catches typos before that).
OPTIM_KEYS: Dict[str, Any] = {
    "name": _STR,
    "lr": _NUM,
    "betas": (list, tuple),
    "weight_decay": _NUM,
    "eps": _NUM,
    "momentum": _NUM,
    "nesterov": _BOOL,
    "amsgrad": _BOOL,
    "rho": _NUM,
    "alpha": _NUM,
    "centered": _BOOL,
    "etas": (list, tuple),
    "step_sizes": (list, tuple),
    "beta": _NUM,
    "grad_averaging": _BOOL,
    "luc": _BOOL,
    "luc_trust": _NUM,
    "luc_eps": _NUM,
    "scale_parameter": _BOOL,
    "relative_step": _BOOL,
    "warmup_init": _BOOL,
    "clipping_threshold": _NUM,
    "min_lr": _NUM,
    "decay_rate": _NUM,
    "sched": dict,
}

# reference core/conf/schedulers.py param families, flattened.
SCHED_KEYS: Dict[str, Any] = {
    "name": _STR,
    "warmup_steps": _NUM,
    "warmup_ratio": _NUM,
    "hold_steps": _NUM,
    "hold_ratio": _NUM,
    "max_steps": _NUM,
    "min_lr": _NUM,
    "last_epoch": _NUM,
    "constant_steps": _NUM,
    "constant_ratio": _NUM,
    "power": _NUM,
    "cycle": _BOOL,
    "decay_rate": _NUM,
    "d_model": _NUM,
    "gamma": _NUM,
    "step_size": _NUM,
    "milestones": (list, tuple),
    "factor": _NUM,
    "patience": _NUM,
    "mode": _STR,
    "threshold": _NUM,
    "cooldown": _NUM,
    "eps": _NUM,
    "t_max": _NUM,
    "monitor": _STR,
    "reduce_on_plateau": _BOOL,
}

EXP_MANAGER_KEYS: Dict[str, Any] = {
    "name": _STR,
    "exp_dir": _STR,
    "version": _STR,
    "create_tensorboard_logger": _BOOL,
    "create_wandb_logger": _BOOL,
    "wandb_logger_kwargs": dict,
    "create_checkpoint_callback": _BOOL,
    "checkpoint_callback_params": dict,
    "resume_if_exists": _BOOL,
    "resume_past_end": _BOOL,
    "resume_ignore_no_checkpoint": _BOOL,
    "use_datetime_version": _BOOL,
    "log_local_rank_0_only": _BOOL,
    "log_global_rank_0_only": _BOOL,
    "files_to_copy": (list, tuple),
    "ema": dict,
}

CHECKPOINT_KEYS: Dict[str, Any] = {
    "monitor": _STR,
    "mode": _STR,
    "save_top_k": _NUM,
    "save_last": _BOOL,
    "always_save_mridc": _BOOL,
    "save_best_model": _BOOL,
    "every_n_epochs": _NUM,
    "every_n_train_steps": _NUM,
    "filename": _STR,
    "prefix": _STR,
    "postfix": _STR,
    "save_mridc_on_train_end": _BOOL,
    "model_parallel_size": _NUM,
}

EMA_KEYS: Dict[str, Any] = {
    "enable": _BOOL,
    "decay": _NUM,
    "cpu_offload": _BOOL,
    "validate_original_weights": _BOOL,
    "every_n_steps": _NUM,
    "apply_ema_every_n_steps": _NUM,
    "start_step": _NUM,
    "evaluate_ema_weights_instead": _BOOL,
}


def _suggest(key: str, known: Sequence[str]) -> str:
    close = difflib.get_close_matches(key, known, n=1)
    return f" Did you mean {close[0]!r}?" if close else ""


def _check_block(block: Optional[Dict], keys: Dict[str, Any], path: str, problems: List[str]):
    if block is None:
        return
    if not isinstance(block, dict):
        problems.append(f"{path}: expected a mapping, got {type(block).__name__}")
        return
    for k, v in block.items():
        if k not in keys:
            problems.append(f"{path}.{k}: unknown key.{_suggest(k, list(keys))}")
            continue
        want = keys[k]
        if want is _ANY or v is None:
            continue
        types: Tuple[type, ...] = want if isinstance(want, tuple) else (want,)
        # bool is an int subclass: only accept it where _BOOL was declared
        if isinstance(v, bool) and bool not in types:
            problems.append(f"{path}.{k}: expected {'/'.join(t.__name__ for t in types)}, got bool")
        elif not isinstance(v, types):
            problems.append(
                f"{path}.{k}: expected {'/'.join(t.__name__ for t in types)}, got {type(v).__name__} ({v!r})"
            )


def validate_config(cfg: Dict, strict: bool = True) -> List[str]:
    """Validate the structural blocks of a run config.

    Returns the list of problems; with ``strict`` (default) raises
    :class:`ConfigValidationError` when any are found.
    """
    problems: List[str] = []
    if not isinstance(cfg, dict):
        raise ConfigValidationError(f"config root must be a mapping, got {type(cfg).__name__}")

    _check_block(cfg.get("trainer"), TRAINER_KEYS, "trainer", problems)

    model = cfg.get("model") or {}
    if model and not isinstance(model, dict):
        problems.append(f"model: expected a mapping, got {type(model).__name__}")
        model = {}
    optim = model.get("optim")
    _check_block(optim, OPTIM_KEYS, "model.optim", problems)
    if isinstance(optim, dict):
        name = optim.get("name")
        if isinstance(name, str):
            from mridc_tpu_torch.train.optim import AVAILABLE_OPTIMIZERS

            known = list(AVAILABLE_OPTIMIZERS)
            if name.lower() not in known:
                problems.append(f"model.optim.name: unknown optimizer {name!r}.{_suggest(name.lower(), known)}")
        sched = optim.get("sched")
        _check_block(sched, SCHED_KEYS, "model.optim.sched", problems)
        if isinstance(sched, dict):
            sname = sched.get("name")
            if isinstance(sname, str):
                from mridc_tpu_torch.train.schedulers import AVAILABLE_SCHEDULERS

                if sname not in AVAILABLE_SCHEDULERS:
                    problems.append(
                        f"model.optim.sched.name: unknown scheduler {sname!r}."
                        f"{_suggest(sname, list(AVAILABLE_SCHEDULERS))}"
                    )

    em = cfg.get("exp_manager")
    _check_block(em, EXP_MANAGER_KEYS, "exp_manager", problems)
    if isinstance(em, dict):
        _check_block(em.get("checkpoint_callback_params"), CHECKPOINT_KEYS, "exp_manager.checkpoint_callback_params", problems)
        _check_block(em.get("ema"), EMA_KEYS, "exp_manager.ema", problems)

    if strict and problems:
        raise ConfigValidationError("invalid config:\n  " + "\n  ".join(problems))
    return problems
