"""Training as the YAMLs state it, in plain PyTorch: the loss of a
reconstruction model's step estimates, the inverse-square-root schedule with
linear warm-up, and Adam.

The loss (the reference CIRIM's ``process_loss``): every estimate's magnitude
and the target's, each divided by its own largest value over the batch, give
an l1 loss; a cascade's step losses are summed and scaled by
``sum(logspace(-1, 0, T)) / T``, and the cascades' terms averaged.

The gradient of a batch is taken in blocks of rows so that it fits: a forward
pass without gradients gives every estimate, the loss's gradient with
respect to them is exact there (the normalising maxima couple the rows), and
each block's forward is run again with gradients and fed that block's part.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

__all__ = ["loss_of_estimates", "lr_at", "max_steps_of", "Adam", "loss_and_grads"]


def _norm_mag(x: torch.Tensor) -> torch.Tensor:
    mag = x.abs()
    return mag / torch.clamp(mag.amax(), min=1e-12)


def loss_of_estimates(estimates: Sequence[torch.Tensor], target: torch.Tensor, time_steps: int) -> torch.Tensor:
    """The l1 loss of ``estimates`` (cascades x time_steps complex [B, H, W]
    in order) against the real ``target`` [B, H, W]."""
    t = _norm_mag(target)
    losses = torch.stack([(t - _norm_mag(p)).abs().mean() for p in estimates])
    per_cascade = losses.reshape(-1, time_steps).sum(1) * (float(np.sum(np.logspace(-1, 0, time_steps))) / time_steps)
    return per_cascade.mean()


def max_steps_of(trainer: dict, num_samples: int, batch: int) -> int:
    """The schedule's length as the YAML's trainer block gives it: its
    ``max_steps``, or ``max_epochs`` epochs of ceil(samples / batch) steps."""
    if trainer.get("max_steps") not in (None, -1):
        return int(trainer["max_steps"])
    return math.ceil(num_samples / batch) * int(trainer.get("max_epochs", 1))


def lr_at(step: int, optim: dict, max_steps: int) -> float:
    """InverseSquareRootAnnealing with warm-up: lr (k + 1) / (n_w + 1) for
    k <= n_w = int(warmup_ratio max_steps), then lr / sqrt((k + 1) / (n_w + 1));
    ``min_lr`` past max_steps."""
    sched = optim["sched"]
    if sched["name"] != "InverseSquareRootAnnealing":
        raise ValueError(f"unsupported schedule {sched['name']!r}")
    lr, warm = float(optim["lr"]), int(sched.get("warmup_ratio", 0.0) * max_steps)
    if step > max_steps:
        return float(sched.get("min_lr", 0.0))
    if warm > 0 and step <= warm:
        return lr * (step + 1) / (warm + 1)
    return lr / math.sqrt((step + 1) / (warm + 1))


class Adam:
    """Adam (Kingma and Ba) with bias correction, L2 decay 0: m and v are the
    gradient's moving averages, p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.betas, self.eps, self.t = params, tuple(betas), eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def loss_and_grads(params: Dict[str, torch.Tensor], forward: Callable[[Dict[str, torch.Tensor], slice], List],
                   target: torch.Tensor, time_steps: int, block: int):
    """(loss, {name: gradient}) of the batch whose estimates ``forward(params,
    rows)`` gives for the rows ``rows``, ``block`` rows at a time."""
    n = target.shape[0]
    with torch.no_grad():
        parts = [forward(params, slice(i, min(i + block, n))) for i in range(0, n, block)]
    estimates = [torch.cat([p[j] for p in parts]).requires_grad_(True) for j in range(len(parts[0]))]
    del parts
    loss = loss_of_estimates(estimates, target, time_steps)
    seeds = torch.autograd.grad(loss, estimates)
    del estimates
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    for i in range(0, n, block):
        rows = slice(i, min(i + block, n))
        out = forward(leaves, rows)
        torch.autograd.backward(out, [s[rows] for s in seeds])
        del out
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in leaves.items()}
    return loss.detach(), grads
