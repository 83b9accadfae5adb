"""Learning-rate schedules matching the reference's scheduler zoo (a copy of
``mridc_tpu/train/schedulers.py`` on numpy).

Functional parity with reference: mridc/core/optim/lr_scheduler.py
(``AVAILABLE_SCHEDULERS`` :1057 — WarmupPolicy, WarmupHoldPolicy,
SquareAnnealing, SquareRootAnnealing, CosineAnnealing, NoamAnnealing,
NoamHoldAnnealing, WarmupAnnealing, InverseSquareRootAnnealing,
T5InverseSquareRootAnnealing, PolynomialDecayAnnealing,
PolynomialHoldDecayAnnealing, StepLR, ExponentialLR, ReduceLROnPlateau,
CyclicLR; ``compute_max_steps`` :1033).

Each schedule is a plain ``step -> lr`` callable in float32 numpy math,
identical to the reference formulas (:362-431); the trainer applies
``sched(k)`` to update k, counting from 0, as optax does. ``ReduceLROnPlateau``
is host-driven (see :class:`ReduceLROnPlateau`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["get_scheduler", "AVAILABLE_SCHEDULERS", "compute_max_steps", "prepare_lr_schedule", "ReduceLROnPlateau"]

Schedule = Callable[[Any], Any]


def _resolve_warmup(warmup_steps, warmup_ratio, max_steps) -> int:
    if warmup_steps is not None:
        return int(warmup_steps)
    if warmup_ratio is not None:
        if max_steps is None:
            raise ValueError("If warmup_ratio is provided, max_steps must be provided.")
        return int(warmup_ratio * max_steps)
    return 0


def _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr):
    """Reference WarmupPolicy: warmup lr = max_lr*(step+1)/(warmup+1); past
    max_steps -> min_lr (reference :56-92)."""

    def schedule(step):
        step = np.asarray(step, np.float32)
        warm = max_lr * (step + 1) / (warmup_steps + 1)
        lr = body(step)
        out = np.where((warmup_steps > 0) & (step <= warmup_steps), warm, lr)
        out = np.where(step > max_steps, min_lr, out)
        return np.asarray(out, np.float32)

    return schedule


def _warmup_hold_then(body, max_lr, warmup_steps, hold_steps, max_steps, min_lr):
    """Reference WarmupHoldPolicy (reference :159-256): warmup, hold at max_lr,
    then the body; past max_steps -> min_lr."""

    def schedule(step):
        step = np.asarray(step, np.float32)
        warm = max_lr * (step + 1) / (warmup_steps + 1)
        lr = body(step)
        out = np.where((hold_steps > 0) & (step <= hold_steps) & (step > warmup_steps), max_lr, lr)
        out = np.where((warmup_steps > 0) & (step <= warmup_steps), warm, out)
        out = np.where(step > max_steps, min_lr, out)
        return np.asarray(out, np.float32)

    return schedule


def warmup_policy(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    return _warmup_then(lambda s: np.full_like(s, max_lr), max_lr, warmup_steps, max_steps, min_lr)


def warmup_hold_policy(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, hold_steps=None, hold_ratio=None, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    hold = _resolve_warmup(hold_steps, hold_ratio, max_steps) + warmup_steps
    return _warmup_hold_then(lambda s: np.full_like(s, max_lr), max_lr, warmup_steps, hold, max_steps, min_lr)


def square_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=1e-5, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def body(step):
        mult = ((max_steps - warmup_steps) - (step - warmup_steps)) / (max_steps - warmup_steps)
        return np.maximum(max_lr * mult**2, min_lr)

    return _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr)


def square_root_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def body(step):
        mult = np.sqrt(np.maximum((max_steps - step) / max_steps, 0.0))
        return np.maximum(max_lr * mult, min_lr)

    return _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr)


def cosine_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, constant_steps=None, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    if constant_steps:
        decay_steps = max_steps - (constant_steps + warmup_steps)

        def schedule(step):
            step = np.asarray(step, np.float32)
            warm = max_lr * step / max(warmup_steps, 1)
            num = np.clip(step - warmup_steps, 0, decay_steps)
            coeff = 0.5 * (np.cos(np.pi * num / max(decay_steps, 1)) + 1.0)
            lr = min_lr + coeff * (max_lr - min_lr)
            out = np.where((warmup_steps > 0) & (step <= warmup_steps), warm, lr)
            out = np.where(step > warmup_steps + decay_steps, min_lr, out)
            return np.asarray(out, np.float32)

        return schedule

    def body(step):
        mult = 0.5 * (1 + np.cos(np.pi * (step - warmup_steps) / (max_steps - warmup_steps)))
        return (max_lr - min_lr) * mult + min_lr

    return _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr)


def noam_annealing(max_lr, max_steps=None, warmup_steps=None, warmup_ratio=None, min_lr=0.0, d_model=64, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps) or 1
    norm = d_model ** (-0.5)

    def schedule(step):
        step = np.maximum(np.asarray(step, np.float32), 1)
        out = max_lr * norm * np.minimum(step ** (-0.5), step * warmup_steps ** (-1.5))
        out = np.where(step > warmup_steps, np.maximum(out, min_lr), out)
        return np.asarray(out, np.float32)

    return schedule


def noam_hold_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, hold_steps=None, hold_ratio=None, decay_rate=0.5, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    if not warmup_steps:
        raise ValueError("Noam scheduler cannot be used without warmup steps")
    hold_total = _resolve_warmup(hold_steps, hold_ratio, max_steps) + warmup_steps
    hold = hold_total - warmup_steps if hold_total > 0 else 0

    def body(step):
        t_warm = max(1, warmup_steps**decay_rate)
        t_hold = np.maximum(1, np.maximum(step - hold, 1) ** decay_rate)
        return np.maximum(max_lr * t_warm / t_hold, min_lr)

    return _warmup_hold_then(body, max_lr, warmup_steps, hold_total, max_steps, min_lr)


def warmup_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def body(step):
        mult = (step - warmup_steps) / (max_steps - warmup_steps)
        return min_lr + (1 - mult) * (max_lr - min_lr)

    return _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr)


def inverse_square_root_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def body(step):
        return max_lr / np.sqrt((step + 1) / (warmup_steps + 1))

    return _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr)


def t5_inverse_square_root_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    # reference SquareRootConstantPolicy (+T5 _get_lr, lr_scheduler.py:95,674):
    # a CONSTANT 1/sqrt(constant_steps) during the constant/warmup phase, then
    # 1/sqrt(step) — continuous at the boundary (the previous max_lr plateau
    # created a discontinuity when max_lr != 1/sqrt(warmup_steps))
    def schedule(step):
        step = np.asarray(step, np.float32)
        const = 1.0 / np.sqrt(np.maximum(np.float32(warmup_steps), 1.0))
        lr = 1.0 / np.sqrt(np.maximum(step, 1))
        out = np.where(step <= warmup_steps, const, lr)
        out = np.where(step > max_steps, min_lr, out)
        return np.asarray(out, np.float32)

    return schedule


def _poly_decay_fn(max_lr, step, decay_steps, power, min_lr, cycle):
    if cycle:
        mult = np.where(step == 0, 1.0, np.ceil(step / decay_steps))
        decay = decay_steps * mult
    else:
        step = np.minimum(step, decay_steps)
        decay = decay_steps
    p = step / decay
    return (max_lr - min_lr) * np.power(1.0 - p, power) + min_lr


def polynomial_decay_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, min_lr=0.0, power=1.0, cycle=False, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def body(step):
        return _poly_decay_fn(max_lr, step - warmup_steps, max_steps - warmup_steps, power, min_lr, cycle)

    return _warmup_then(body, max_lr, warmup_steps, max_steps, min_lr)


def polynomial_hold_decay_annealing(max_lr, max_steps, warmup_steps=None, warmup_ratio=None, hold_steps=None, hold_ratio=None, min_lr=0.0, power=1.0, cycle=False, **_):
    warmup_steps = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    hold_total = _resolve_warmup(hold_steps, hold_ratio, max_steps) + warmup_steps

    def body(step):
        return _poly_decay_fn(
            max_lr, step - hold_total, max_steps - max(warmup_steps, hold_total), power, min_lr, cycle
        )

    return _warmup_hold_then(body, max_lr, warmup_steps, hold_total, max_steps, min_lr)


def step_lr(max_lr, step_size=10, gamma=0.1, **_):
    def schedule(step):
        return np.asarray(max_lr * gamma ** np.floor(np.asarray(step, np.float32) / step_size), np.float32)

    return schedule


def exponential_lr(max_lr, gamma=0.9, **_):
    def schedule(step):
        return np.asarray(max_lr * gamma ** np.asarray(step, np.float32), np.float32)

    return schedule


def cyclic_lr(max_lr, base_lr=None, step_size_up=2000, step_size_down=None, mode="triangular", gamma=1.0, **_):
    """torch CyclicLR (triangular/triangular2/exp_range)."""
    lo = base_lr if base_lr is not None else max_lr / 10
    down = step_size_down if step_size_down is not None else step_size_up
    total = step_size_up + down

    def schedule(step):
        step = np.asarray(step, np.float32)
        cycle = np.floor(1 + step / total)
        pos = step - (cycle - 1) * total
        x = np.where(pos <= step_size_up, pos / step_size_up, 1 - (pos - step_size_up) / down)
        scale = np.where(
            np.array(mode == "triangular2"), 1 / (2.0 ** (cycle - 1)),
            np.where(np.array(mode == "exp_range"), gamma**step, 1.0),
        )
        return np.asarray(lo + (max_lr - lo) * np.maximum(x, 0) * scale, np.float32)

    return schedule


class ReduceLROnPlateau:
    """Host-driven plateau scheduler: call ``update(metric)`` each validation;
    read ``lr`` (matches torch semantics: factor, patience, threshold rel)."""

    def __init__(self, max_lr, factor=0.1, patience=10, threshold=1e-4, min_lr=0.0, mode="min", **_):
        self.lr = float(max_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0

    def update(self, metric: float) -> float:
        improved = metric < self.best * (1 - self.threshold) if self.mode == "min" else metric > self.best * (1 + self.threshold)
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def __call__(self, step):
        return np.float32(self.lr)


AVAILABLE_SCHEDULERS: Dict[str, Callable] = {
    "WarmupPolicy": warmup_policy,
    "WarmupHoldPolicy": warmup_hold_policy,
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": square_root_annealing,
    "CosineAnnealing": cosine_annealing,
    "NoamAnnealing": noam_annealing,
    "NoamHoldAnnealing": noam_hold_annealing,
    "WarmupAnnealing": warmup_annealing,
    "InverseSquareRootAnnealing": inverse_square_root_annealing,
    "T5InverseSquareRootAnnealing": t5_inverse_square_root_annealing,
    "PolynomialDecayAnnealing": polynomial_decay_annealing,
    "PolynomialHoldDecayAnnealing": polynomial_hold_decay_annealing,
    "StepLR": step_lr,
    "ExponentialLR": exponential_lr,
    "CyclicLR": cyclic_lr,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def get_scheduler(name: str, max_lr: float, **kwargs) -> Schedule:
    if name not in AVAILABLE_SCHEDULERS:
        raise ValueError(f"Unknown scheduler {name!r}. Available: {sorted(AVAILABLE_SCHEDULERS)}")
    builder = AVAILABLE_SCHEDULERS[name]
    return builder(max_lr, **kwargs)


def compute_max_steps(
    max_epochs, accumulate_grad_batches, limit_train_batches, num_workers, num_samples, batch_size, drop_last
) -> int:
    """Effective max_steps (reference :1033-1056)."""
    _round = math.floor if drop_last else math.ceil
    sampler_num_samples = math.ceil(num_samples / max(1, num_workers))
    steps_per_epoch = _round(sampler_num_samples / batch_size)
    if isinstance(limit_train_batches, int) or limit_train_batches == 0.0:
        steps_per_epoch = min(steps_per_epoch, int(limit_train_batches))
    elif steps_per_epoch != float("inf"):
        steps_per_epoch = int(steps_per_epoch * limit_train_batches)
    return math.ceil(steps_per_epoch / accumulate_grad_batches) * max_epochs


def prepare_lr_schedule(optim_cfg: Dict, num_samples: int, batch_size: int, trainer_cfg: Optional[Dict] = None):
    """Build a schedule from an ``optim.sched`` config block, inferring
    max_steps from epochs x batches like the reference ``prepare_lr_scheduler``
    (reference :775-1032)."""
    sched = dict(optim_cfg.get("sched") or {})
    if not sched:
        return None
    trainer_cfg = trainer_cfg or {}
    name = sched.pop("name")
    max_lr = optim_cfg.get("lr", 1e-3)
    if "max_steps" not in sched or sched.get("max_steps") in (None, -1):
        max_steps = trainer_cfg.get("max_steps")
        if max_steps is None or max_steps < 0:
            max_steps = compute_max_steps(
                trainer_cfg.get("max_epochs", 1),
                trainer_cfg.get("accumulate_grad_batches", 1),
                trainer_cfg.get("limit_train_batches", 1.0),
                0,
                num_samples,
                batch_size,
                False,
            )
        sched["max_steps"] = max_steps
    sched.pop("last_epoch", None)
    sched.pop("monitor", None)
    return get_scheduler(name, max_lr, **sched)
