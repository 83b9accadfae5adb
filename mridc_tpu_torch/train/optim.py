"""Optimizer registry (counterpart of ``mridc_tpu/train/optim.py``, which
builds optax transforms): torch-style hyperparameters (betas, eps,
weight_decay) onto ``torch.optim``.

Adam is ported, the optimizer of every ``projects/`` config. Its
``weight_decay`` is L2 decay added to the gradient before the update (the JAX
package's ``_l2``, torch Adam's own semantics). The other names of the JAX
registry raise ``NotImplementedError`` (ROADMAP.md M5: the other optimizers).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

__all__ = ["AVAILABLE_OPTIMIZERS", "PENDING_OPTIMIZERS", "get_optimizer", "parse_optimizer_args"]


def _adam(params, lr, **kw):
    b1, b2 = kw.get("betas", (0.9, 0.999))
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=kw.get("eps", 1e-8),
                            weight_decay=kw.get("weight_decay", 0.0) or 0.0)


AVAILABLE_OPTIMIZERS = {"adam": _adam}
PENDING_OPTIMIZERS = (
    "sgd", "adamw", "adadelta", "adamax", "adagrad", "rmsprop", "rprop", "novograd", "adafactor", "radam", "lamb",
)


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
    if name in PENDING_OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported to mridc_tpu_torch yet: ROADMAP.md M5 "
                                  "(the other optimizers); 'adam' is")
    if name not in AVAILABLE_OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}. Available: {sorted(AVAILABLE_OPTIMIZERS)}")
    return AVAILABLE_OPTIMIZERS[name](params, lr, **kwargs)
