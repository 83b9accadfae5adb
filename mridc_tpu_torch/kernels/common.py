"""Argument checks shared by the kernel wrappers.

A wrapper takes its plain PyTorch version for tensors that lie on the CPU and
launches its kernel for tensors on a CUDA device; on any other device, or for
CUDA tensors the kernel does not take, it raises. It never falls back.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

__all__ = ["device_of", "check_forward_only", "check_operand"]


def device_of(name: str, *tensors: Optional[torch.Tensor]) -> torch.device:
    """The one device all given tensors lie on (None entries are skipped)."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must lie on one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev} are not supported (cpu: plain version, cuda: kernel)")
    return dev


def check_forward_only(name: str, tensors: Iterable[Optional[torch.Tensor]]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; run under torch.inference_mode() or torch.no_grad(). "
            "Backward kernels come with the training step (ROADMAP M5)."
        )


def check_operand(
    name: str,
    t: torch.Tensor,
    shape: Sequence[int],
    dtypes: Sequence[torch.dtype],
    channels_last: bool = False,
) -> None:
    """Shape, dtype, layout and 16-byte alignment the kernel relies on."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected dtype in {[str(d) for d in dtypes]}, got {t.dtype}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        layout = "channels_last" if channels_last else "contiguous"
        raise ValueError(f"{name}: the kernel needs a {layout} tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor (got a view with an offset)")
