"""Model export with numerical runtime verification (counterpart of
``mridc_tpu/utils/export.py``; reference: mridc/core/classes/export.py:43
``Exportable.export`` and ``verify_runtime`` :125), on ``torch.export``.

:func:`export_model` traces a module's (or a function's) inference forward on
example inputs and saves the program as a ``.pt2`` file. The hand kernels
survive the export: while it traces, every kernel wrapper a forward reaches
calls its ``mridc_tpu_torch::`` custom op (``kernels/common.py``), so the
program launches the same kernels as the eager forward on the card and runs
their plain versions on the CPU. :func:`load_exported` imports this package
first, which registers the ops, and returns a module that runs the program
with the port's float32 convolution rule (no TF32: the rule is a global
flag, which a program does not carry). :func:`verify_runtime` compares the
loaded program's outputs with the live call, leaf by leaf.
"""

from __future__ import annotations

import contextlib
import types
import typing
from pathlib import Path
from typing import Callable, Tuple, Union

import numpy as np
import torch

__all__ = ["export_model", "load_exported", "verify_runtime", "ExportedModel"]


def _register_outputs() -> None:
    """The models' output dataclass as a pytree node, which ``torch.export``
    needs to trace and to load a program that returns it."""
    from mridc_tpu_torch.models.base import ModelOutput

    if ModelOutput not in torch.utils._pytree.SUPPORTED_NODES:
        torch.export.register_dataclass(ModelOutput, serialized_type_name="mridc_tpu_torch.models.base.ModelOutput")


@contextlib.contextmanager
def _no_node_stack_traces():
    """Tracing without a stack trace recorded for each graph node (when this
    PyTorch has the switch): they take a third of the tracing time of the
    port's models, and a program does not need them."""
    config = torch.fx.config
    if not hasattr(config, "do_not_emit_stack_traces"):
        yield
        return
    before = config.do_not_emit_stack_traces
    config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        config.do_not_emit_stack_traces = before


@contextlib.contextmanager
def _cached_type_hints():
    """``typing.get_type_hints`` memoised for PyTorch's program deserializer
    alone, while a program loads: it resolves the hints of its schema's
    dataclasses for every field it reads, the same hints hundreds of thousands
    of times for a program of a few thousand nodes (most of the load's time
    without the memo). The memo replaces the ``typing`` that the deserializer's module sees by a view of
    ``typing`` with a memoised ``get_type_hints``; ``typing`` itself, and every
    other module, is left alone."""
    from torch._export.serde import serialize

    real = getattr(serialize, "typing", None)
    if real is not typing:
        yield
        return
    cache = {}

    def get_type_hints(obj, globalns=None, localns=None, include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in cache:
            cache[key] = typing.get_type_hints(obj, globalns, localns, include_extras)
        return cache[key]

    view = types.ModuleType("typing")
    view.__dict__.update(vars(typing))
    view.get_type_hints = get_type_hints
    serialize.typing = view
    try:
        yield
    finally:
        serialize.typing = real


class _Fn(torch.nn.Module):
    """A function as a module (``torch.export`` takes modules)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _module(fn_or_module: Union[Callable, torch.nn.Module]) -> torch.nn.Module:
    return fn_or_module if isinstance(fn_or_module, torch.nn.Module) else _Fn(fn_or_module)


def export_model(fn_or_module: Union[Callable, torch.nn.Module], example_args: Tuple, path) -> Path:
    """Trace ``fn_or_module(*example_args)`` without gradients (a module in its
    present train/eval mode) and save the program to ``path`` (``.pt2``).
    Raises where a forward cannot be traced, a kernel launch among them."""
    _register_outputs()
    with torch.no_grad(), _no_node_stack_traces():
        program = torch.export.export(_module(fn_or_module), tuple(example_args))
    program.example_inputs = None  # the file keeps the program and its weights, not the (coil-sized) inputs
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    return path


class ExportedModel(torch.nn.Module):
    """A loaded program as a module: ``program`` is the
    ``torch.export.ExportedProgram``; a call runs it without gradients, its
    float32 convolutions in full float32."""

    def __init__(self, program):
        super().__init__()
        self.program = program
        self.module_ = program.module()

    def forward(self, *args):
        from mridc_tpu_torch.nn.layers import cudnn_float32

        with torch.no_grad(), cudnn_float32():
            return self.module_(*args)


def load_exported(path) -> ExportedModel:
    """The program saved at ``path``, ready to call."""
    import mridc_tpu_torch.kernels  # noqa: F401  (registers the custom ops the program calls)

    _register_outputs()
    with _cached_type_hints():
        return ExportedModel(torch.export.load(str(path)))


def _leaves(tree):
    """Tensor leaves of nested tuples, lists, dicts and dataclasses, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for k in tree.__dataclass_fields__ for x in _leaves(getattr(tree, k))]
    return []


def verify_runtime(fn_or_module: Union[Callable, torch.nn.Module], example_args: Tuple, path, rtol: float = 1e-4,
                   atol: float = 1e-4) -> bool:
    """Compare the loaded program's outputs with the live call's; raise on a
    structure mismatch or a value out of tolerance."""
    got = load_exported(path)(*example_args)
    with torch.no_grad():
        want = _module(fn_or_module)(*example_args)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    if len(got_leaves) != len(want_leaves):
        raise AssertionError(
            f"exported artifact returns {len(got_leaves)} output leaves, live forward returns "
            f"{len(want_leaves)} — structure mismatch (stale or corrupt artifact?)"
        )
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(), w.detach().float().cpu().numpy(), rtol=rtol,
                                   atol=atol)
    return True
