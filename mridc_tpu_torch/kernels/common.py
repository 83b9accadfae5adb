"""Argument checks shared by the kernel wrappers, and the rules of their
gradients.

A wrapper takes its plain PyTorch version for tensors that lie on the CPU and
launches its kernel for tensors on a CUDA device; on any other device, or for
CUDA tensors the kernel does not take, it raises. It never falls back. Each
wrapper is a ``torch.autograd.Function``: on the card its backward launches
the backward kernel, on the CPU it runs the backward kernel's plain version.
An input whose gradient a backward does not compute raises when autograd asks
for it (:func:`refuse_grads`), never gets None or zeros.

While ``torch.export`` traces a model (``torch.compiler.is_exporting()``), the forward
kernels a serving forward reaches are called as ``torch.library`` custom ops
of the ``mridc_tpu_torch`` namespace, which the tracer records (it cannot
follow a ctypes launch): each op launches its kernel on CUDA tensors and runs
its plain version on CPU tensors when the exported program runs, and its
fake implementation gives the tracer the output's shape, dtype and layout.
Outside an export the wrappers launch directly, as before.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

__all__ = ["device_of", "check_operand", "refuse_grads", "dense", "GRAD_COPIES", "plain_route"]

# layout copies the backward wrappers made of incoming gradients, by wrapper
GRAD_COPIES: Dict[str, int] = {}


def plain_route(t: torch.Tensor) -> bool:
    """True where a wrapper runs its plain version in place of its stages:
    CPU tensors outside an export."""
    return t.device.type == "cpu" and not torch.compiler.is_exporting()


def device_of(name: str, *tensors: Optional[torch.Tensor]) -> torch.device:
    """The one device all given tensors lie on (None entries are skipped)."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must lie on one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev} are not supported (cpu: plain version, cuda: kernel)")
    return dev


def refuse_grads(name: str, needs_input_grad: Sequence[bool], unported: Mapping[int, str]) -> None:
    """Raise if autograd asks for the gradient of an input (position: what)
    that the backward does not compute."""
    asked = [what for i, what in unported.items() if needs_input_grad[i]]
    if asked:
        raise NotImplementedError(f"{name}: the gradient with respect to {', '.join(asked)} is not ported")


def dense(name: str, g: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
    """``g`` contiguous (or channels_last) and 16-byte aligned, as a kernel
    reads it; a copy, when one is needed, is counted in :data:`GRAD_COPIES`."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if torch.compiler.is_exporting():  # a traced tensor has no address: the op checks it when it runs
        return g.contiguous(memory_format=fmt)
    if g.is_contiguous(memory_format=fmt) and g.data_ptr() % 16 == 0:
        return g
    GRAD_COPIES[name] = GRAD_COPIES.get(name, 0) + 1
    return g.clone(memory_format=fmt)


def check_operand(
    name: str,
    t: torch.Tensor,
    shape: Sequence[int],
    dtypes: Sequence[torch.dtype],
    channels_last: bool = False,
    align: int = 16,
) -> None:
    """Shape, dtype, layout and alignment (bytes) the kernel relies on."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected dtype in {[str(d) for d in dtypes]}, got {t.dtype}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        layout = "channels_last" if channels_last else "contiguous"
        raise ValueError(f"{name}: the kernel needs a {layout} tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the kernel needs a {align}-byte aligned tensor (got a view with an offset)")
