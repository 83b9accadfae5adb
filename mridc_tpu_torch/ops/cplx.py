"""Real-view complex algebra (counterpart of ``mridc_tpu/ops/cplx.py``):
complex tensors as float tensors with a trailing ``[..., 2]`` (re, im) axis —
the public tensor layout of both packages.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "cplx",
    "re",
    "im",
    "cmul",
    "cmul_conj",
    "cconj",
    "cabs",
    "cabs2",
    "crss",
    "csense",
    "ccombine",
    "to_rv",
    "from_rv",
]


def cplx(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    return torch.stack([real, imag], dim=-1)


def re(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0]


def im(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1]


def cmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(a+bi)(c+di) on [..., 2] views."""
    a, b = x[..., 0], x[..., 1]
    c, d = y[..., 0], y[..., 1]
    return torch.stack([a * c - b * d, a * d + b * c], dim=-1)


def cmul_conj(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * conj(y) without materializing conj."""
    a, b = x[..., 0], x[..., 1]
    c, d = y[..., 0], y[..., 1]
    return torch.stack([a * c + b * d, b * c - a * d], dim=-1)


def cconj(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0], -x[..., 1]], dim=-1)


def cabs2(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] ** 2 + x[..., 1] ** 2


def cabs(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(cabs2(x))


def crss(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Root-sum-of-squares over the coil axis -> magnitude [...] (no complex axis)."""
    return torch.sqrt(cabs2(x).sum(dim=dim))


def csense(x: torch.Tensor, sens: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """SENSE combine sum_c x_c conj(S_c) -> [..., 2]."""
    return cmul_conj(x, sens).sum(dim=dim)


def ccombine(x: torch.Tensor, sens: torch.Tensor, method: str = "SENSE", dim: int = 1) -> torch.Tensor:
    """Coil combination on real views. RSS returns a zero-imag [..., 2] view so
    downstream shapes stay uniform."""
    method = method.upper()
    if method == "SENSE":
        return csense(x, sens, dim)
    if method == "RSS":
        mag = crss(x, dim)
        return torch.stack([mag, torch.zeros_like(mag)], dim=-1)
    raise ValueError(f"Coil combination method not supported: {method}")


def to_rv(x: np.ndarray) -> np.ndarray:
    """host complex -> [..., 2] float32 real view."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.stack([x, np.zeros_like(x)], axis=-1).astype(np.float32)


def from_rv(x) -> np.ndarray:
    """[..., 2] float real view -> host complex64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
