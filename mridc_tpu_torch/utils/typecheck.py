"""Runtime dtype/layout contract of real-view tensors (counterpart of
``mridc_tpu/utils/typecheck.py:check_rv``), and the device rule of the port's
entry points.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["check_rv", "ShapeError", "resolve_device"]


class ShapeError(ValueError):
    """Raised when a tensor violates its declared layout contract."""


def check_rv(x, name: str = "array", coil_axis: Optional[int] = None) -> None:
    """Assert real-view complex layout: float dtype, trailing axis of size 2."""
    shape = tuple(getattr(x, "shape", ()))
    if not shape or shape[-1] != 2:
        raise ShapeError(f"{name}: real-view arrays need a trailing (re, im) axis of 2, got {shape}")
    dtype = getattr(x, "dtype", None)
    if isinstance(dtype, torch.dtype):
        if dtype.is_complex:
            raise ShapeError(f"{name}: real-view array must be real-dtyped, got {dtype}")
        if not dtype.is_floating_point:
            raise ShapeError(f"{name}: real-view array must be float-dtyped, got {dtype}")
    if coil_axis is not None and len(shape) <= coil_axis:
        raise ShapeError(f"{name}: expected a coil axis at {coil_axis}, got rank {len(shape)}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without a card and without an explicit device this raises — the
    port never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mridc_tpu_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
