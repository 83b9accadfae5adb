"""Activation and gradient statistics for debugging (counterpart of
``mridc_tpu/utils/debug.py``; reference: mridc/utils/debug_hook.py:11-222,
forward and backward hooks logging the mean and the largest magnitude of
activations and gradients).

:func:`intermediate_stats` runs a module with a forward hook on every
submodule and keys each output's statistics by the submodule's path (the
JAX package keys flax's ``intermediates`` the same way); :func:`tree_stats`
gives the statistics of each tensor of a state dict or of any nest of dicts,
lists and tensors (the gradients, say).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["intermediate_stats", "tree_stats"]


def _stats(x) -> Dict[str, float]:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x).cpu().numpy()
    x = np.asarray(x)
    if x.dtype.kind not in "fc" or x.size == 0:
        return {}
    mag = np.abs(x)
    return {"mean": float(x.mean().real), "abs_max": float(mag.max()), "std": float(x.std())}


def _walk(node, prefix: str, out: Dict[str, Dict[str, float]]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _walk(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _walk(v, f"{prefix}[{i}]", out)
    elif hasattr(node, "__dataclass_fields__"):
        for k in node.__dataclass_fields__:
            _walk(getattr(node, k), f"{prefix}.{k}" if prefix else k, out)
    elif isinstance(node, (torch.Tensor, np.ndarray)):
        s = _stats(node)
        if s:
            out[prefix] = s


def intermediate_stats(model: torch.nn.Module, *args, **kwargs) -> Dict[str, Dict[str, float]]:
    """Run ``model(*args, **kwargs)`` without gradients, hooking every
    submodule: the statistics of each submodule's output (of each tensor in
    it), keyed by the submodule's path (``""`` is the model itself)."""
    out: Dict[str, Dict[str, float]] = {}
    handles = []
    for name, module in model.named_modules():
        def hook(mod, inputs, output, _name=name):
            _walk(output, _name, out)
        handles.append(module.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out


def tree_stats(tree: Any, prefix: str = "") -> Dict[str, Dict[str, float]]:
    """Per-tensor statistics of a state dict (or any nest of dicts, lists and
    tensors), keyed by their paths."""
    out: Dict[str, Dict[str, float]] = {}
    _walk(tree, prefix, out)
    return out
