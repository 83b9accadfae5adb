"""Optimizer registry (counterpart of ``mridc_tpu/train/optim.py``, which
builds optax transforms): torch-style hyperparameters (betas, eps,
weight_decay, momentum, alpha, rho, etas) onto optimizers with optax's update
rules.

Where a ``torch.optim`` class computes optax's rule it is used as it is: adam,
sgd, adamw and adadelta (their ``weight_decay`` is L2 decay added to the
gradient before the update, the JAX package's ``_l2``, except adamw's, which
is decoupled in both). The others differ from optax (adagrad's accumulator
starts at 0.1 and takes eps inside the square root; rmsprop's eps is inside
the square root and its momentum traces the learning-rate-scaled update;
adamax adds eps to |g| inside the max; radam's rectification; rprop's update
is the step of the previous iteration; adafactor's factored second moment with
block-rms clipping and parameter scaling) or have no torch class (novograd,
lamb), and run on :class:`OptaxRule` subclasses of the port's own. Each
takes the hyperparameters the JAX package's builder reads and ignores the
rest, as it does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["AVAILABLE_OPTIMIZERS", "OptaxRule", "get_optimizer", "parse_optimizer_args"]


def _betas(kw, default=(0.9, 0.999)) -> Tuple[float, float]:
    b1, b2 = kw.get("betas", default)
    return b1, b2


def _l2(kw) -> float:
    return kw.get("weight_decay", 0.0) or 0.0


class OptaxRule(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` that moves each parameter p by an optax
    rule's update of its gradient g (with ``l2``, of g + l2 * p: optax's
    ``add_decayed_weights`` chained before the rule). Subclasses give the
    rule's per-parameter state (:meth:`init`) and update (:meth:`update`,
    which returns the step added to p); ``group["lr"]`` is the step's rate,
    which the trainer sets from its schedule. Optax counts steps once for all
    parameters; here each parameter counts its own, which is the same count
    as every parameter takes a gradient at every step."""

    def __init__(self, params, lr: float, l2: float = 0.0, **hyper):
        super().__init__(params, dict(lr=lr, l2=l2, **hyper))

    def init(self, p: torch.Tensor, state: Dict[str, Any], group: Dict[str, Any]) -> None:
        raise NotImplementedError

    def update(self, p: torch.Tensor, g: torch.Tensor, state: Dict[str, Any], group: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not group["l2"] else p.grad + group["l2"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    self.init(p, state, group)
                state["step"] += 1
                p.add_(self.update(p, g, state, group))
        return loss


class Adamax(OptaxRule):
    """optax ``adamax``: nu = max(|g| + eps, b2 nu), update -lr mu_hat / nu."""

    def init(self, p, state, group):
        state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)

    def update(self, p, g, state, group):
        b1, b2 = group["betas"]
        state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        state["nu"] = torch.maximum(g.abs() + group["eps"], b2 * state["nu"])
        return -group["lr"] * (state["mu"] / (1 - b1 ** state["step"])) / state["nu"]


class Adagrad(OptaxRule):
    """optax ``adagrad`` (``scale_by_rss``): the sum of squares starts at
    ``initial_accumulator_value``; update -lr g / sqrt(sum + eps), 0 where the
    sum is 0."""

    def init(self, p, state, group):
        state["sum"] = torch.full_like(p, group["initial_accumulator_value"])

    def update(self, p, g, state, group):
        state["sum"].add_(g * g)
        s = state["sum"]
        return -group["lr"] * torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) * g


class RMSprop(OptaxRule):
    """optax ``rmsprop`` (not centered): nu = decay nu + (1 - decay) g^2,
    u = -lr g / sqrt(nu + eps), then with momentum t = u + momentum t."""

    def init(self, p, state, group):
        state["nu"] = torch.zeros_like(p)
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)

    def update(self, p, g, state, group):
        d = group["decay"]
        state["nu"].mul_(d).add_((1 - d) * g * g)
        u = -group["lr"] * torch.rsqrt(state["nu"] + group["eps"]) * g
        if group["momentum"] is None:
            return u
        state["trace"] = u + group["momentum"] * state["trace"]
        return state["trace"]


class Rprop(OptaxRule):
    """optax ``rprop`` (``scale_by_rprop`` then a sign flip): per element a
    step size (starting at lr) grown by eta_plus where g keeps the sign of
    the previous iteration's step and shrunk by eta_minus where it flips
    (clipped to [min_step_size, max_step_size]); the step stored is
    step_size * sign(g), 0 after a flip, and optax applies the step stored
    at the previous iteration (0 where the sign flipped). The rate is read
    once, at the first step, as in optax."""

    def init(self, p, state, group):
        state["step_sizes"] = torch.full_like(p, group["lr"])
        state["prev"] = torch.zeros_like(p)

    def update(self, p, g, state, group):
        sign = g * state["prev"]
        grown = torch.clamp(state["step_sizes"] * torch.where(sign > 0, group["eta_plus"], group["eta_minus"]),
                            min=group["min_step_size"], max=group["max_step_size"])
        state["step_sizes"] = torch.where(sign == 0, state["step_sizes"], grown)
        prev = state["prev"]
        state["prev"] = torch.where(sign < 0, 0.0, state["step_sizes"] * torch.sign(g))
        return -torch.where(sign < 0, 0.0, prev)


class NovoGrad(OptaxRule):
    """optax ``novograd``: a per-parameter second moment of |g|^2 (|g|^2 at
    the first step, then b2 nu + (1 - b2) |g|^2), mu = b1 mu + g / (sqrt(nu)
    + eps) + weight_decay p (the first step without b1 mu); update -lr mu."""

    def init(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros((), dtype=p.dtype, device=p.device)

    def update(self, p, g, state, group):
        b1, b2 = group["betas"]
        n2 = torch.linalg.vector_norm(g) ** 2
        state["nu"] = n2 if state["step"] == 1 else b2 * state["nu"] + (1 - b2) * n2
        add = g / (torch.sqrt(state["nu"]) + group["eps"]) + group["weight_decay"] * p
        state["mu"] = add if state["step"] == 1 else b1 * state["mu"] + add
        return -group["lr"] * state["mu"]


class RAdam(OptaxRule):
    """optax ``radam``: Adam's moments; where the length of the approximated
    SMA ro >= threshold the rectified update r mu_hat / (sqrt(nu_hat) + eps),
    else mu_hat; times -lr."""

    def init(self, p, state, group):
        state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)

    def update(self, p, g, state, group):
        b1, b2 = group["betas"]
        t = state["step"]
        state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        state["nu"].mul_(b2).add_((1 - b2) * g * g)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = np.float32(b2) ** np.float32(t)
        ro = float(np.float32(ro_inf) - np.float32(2 * t) * b2t / (np.float32(1) - b2t))
        mu_hat = state["mu"] / (1 - b1 ** t)
        if ro < group["threshold"]:
            return -group["lr"] * mu_hat
        r = float(np.sqrt(np.float32((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))))
        nu_hat = state["nu"] / (1 - b2 ** t)
        return -group["lr"] * (r * mu_hat / (torch.sqrt(nu_hat) + group["eps"]))


class Lamb(OptaxRule):
    """optax ``lamb``: the Adam update plus weight_decay p, scaled per
    parameter by the trust ratio |p| / |update| (1 where either norm is 0);
    times -lr."""

    def init(self, p, state, group):
        state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)

    def update(self, p, g, state, group):
        b1, b2 = group["betas"]
        t = state["step"]
        state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        state["nu"].mul_(b2).add_((1 - b2) * g * g)
        u = (state["mu"] / (1 - b1 ** t)) / (torch.sqrt(state["nu"] / (1 - b2 ** t)) + group["eps"])
        u = u + group["weight_decay"] * p
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
        return -group["lr"] * u * ratio


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """The two largest axes (second largest first) when the second largest is
    at least ``min_dim_size_to_factor``, as optax picks them."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(OptaxRule):
    """optax ``adafactor`` with its defaults (factored, decay rate 0.8, no
    momentum, min_dim_size_to_factor 128, clipping threshold 1, parameter
    scale, eps 1e-30): a second moment factored over a parameter's two
    largest axes (a full one otherwise) with decay 1 - (t)^-0.8, the update
    clipped to block rms 1, times lr and max(rms(p), 1e-3), plus
    ``weight_decay_rate`` p, subtracted. The factored statistics are means
    over axes, so a parameter's layout (OIHW here, HWIO in flax) does not
    change them."""

    def init(self, p, state, group):
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            state["v_row"] = torch.zeros_like(p.mean(dim=d0))
            state["v_col"] = torch.zeros_like(p.mean(dim=d1))

    def update(self, p, g, state, group):
        decay = 1.0 - float(np.float32(state["step"]) ** np.float32(-group["decay_rate"]))
        g2 = g * g + group["eps"]
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is None:
            state["v"] = decay * state["v"] + (1.0 - decay) * g2
            u = g * state["v"] ** -0.5
        else:
            d1, d0 = dims
            state["v_row"] = decay * state["v_row"] + (1.0 - decay) * g2.mean(dim=d0)
            state["v_col"] = decay * state["v_col"] + (1.0 - decay) * g2.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = state["v_row"].mean(dim=reduced_d1, keepdim=True)
            row_factor = (state["v_row"] / row_col_mean) ** -0.5
            u = g * row_factor.unsqueeze(d0) * state["v_col"].unsqueeze(d1) ** -0.5
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / group["clipping_threshold"], min=1.0)
        rms = torch.sqrt(torch.mean(p * p))
        u = group["lr"] * u * torch.where(rms <= 1e-3, 1e-3, rms)
        if group["weight_decay_rate"] is not None:
            u = u + group["weight_decay_rate"] * p
        return -u


def _adam(params, lr, **kw):
    return torch.optim.Adam(params, lr=lr, betas=_betas(kw), eps=kw.get("eps", 1e-8), weight_decay=_l2(kw))


def _sgd(params, lr, **kw):
    momentum = kw.get("momentum") or 0.0
    return torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=bool(momentum and kw.get("nesterov", False)),
                           weight_decay=_l2(kw))


def _adamw(params, lr, **kw):
    return torch.optim.AdamW(params, lr=lr, betas=_betas(kw), eps=kw.get("eps", 1e-8),
                             weight_decay=kw.get("weight_decay", 1e-2))


def _adadelta(params, lr, **kw):
    return torch.optim.Adadelta(params, lr=lr, rho=kw.get("rho", 0.9), eps=kw.get("eps", 1e-6), weight_decay=_l2(kw))


def _adamax(params, lr, **kw):
    return Adamax(params, lr, _l2(kw), betas=_betas(kw), eps=kw.get("eps", 1e-8))


def _adagrad(params, lr, **kw):
    return Adagrad(params, lr, _l2(kw), eps=kw.get("eps", 1e-10), initial_accumulator_value=0.1)


def _rmsprop(params, lr, **kw):
    return RMSprop(params, lr, _l2(kw), decay=kw.get("alpha", 0.99), eps=kw.get("eps", 1e-8),
                   momentum=kw.get("momentum") or None)


def _rprop(params, lr, **kw):
    etas = kw.get("etas", (0.5, 1.2))
    return Rprop(params, lr, eta_minus=etas[0], eta_plus=etas[1], min_step_size=1e-6, max_step_size=50.0)


def _novograd(params, lr, **kw):
    return NovoGrad(params, lr, betas=_betas(kw, (0.95, 0.98)), eps=kw.get("eps", 1e-8),
                    weight_decay=kw.get("weight_decay", 0.0))


def _adafactor(params, lr, **kw):
    return Adafactor(params, lr, weight_decay_rate=kw.get("weight_decay") or None, min_dim_size_to_factor=128,
                     decay_rate=0.8, clipping_threshold=1.0, eps=1e-30)


def _radam(params, lr, **kw):
    return RAdam(params, lr, _l2(kw), betas=_betas(kw), eps=kw.get("eps", 1e-8), threshold=5.0)


def _lamb(params, lr, **kw):
    return Lamb(params, lr, betas=_betas(kw), eps=kw.get("eps", 1e-6), weight_decay=kw.get("weight_decay", 0.0))


AVAILABLE_OPTIMIZERS = {
    "sgd": _sgd,
    "adam": _adam,
    "adamw": _adamw,
    "adadelta": _adadelta,
    "adamax": _adamax,
    "adagrad": _adagrad,
    "rmsprop": _rmsprop,
    "rprop": _rprop,
    "novograd": _novograd,
    "adafactor": _adafactor,
    "radam": _radam,
    "lamb": _lamb,
}


def parse_optimizer_args(optim_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Strip framework keys, keep optimizer hyperparameters (reference :38-135)."""
    kwargs = dict(optim_cfg or {})
    for k in ("name", "lr", "sched"):
        kwargs.pop(k, None)
    return kwargs


def get_optimizer(name: str, params: Iterable[torch.Tensor], lr: float, **kwargs) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` at learning rate ``lr`` (the
    trainer sets each step's rate from its schedule)."""
    name = str(name).lower()
    if name not in AVAILABLE_OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}. Available: {sorted(AVAILABLE_OPTIMIZERS)}")
    return AVAILABLE_OPTIMIZERS[name](params, lr, **kwargs)
