"""SSIM training loss (counterpart of ``mridc_tpu/losses/ssim.py``): the
fastMRI SSIMLoss, a uniform 7x7 window, k1=0.01, k2=0.03, ``1 - SSIM`` over
the VALID region, as the reference's unpadded conv2d crops the edges."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssim_loss"]


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean filter via a VALID conv over [B, 1, H, W]."""
    w = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)
    return F.conv2d(x, w)


def ssim_loss(x, y, data_range, win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """``1 - mean(SSIM)`` over [batch, 1, h, w] (or [batch, h, w]) inputs;
    ``data_range`` has one value per batch element."""
    if x.ndim == 3:
        x = x[:, None]
    if y.ndim == 3:
        y = y[:, None]
    x, y = x.float(), y.float()
    data_range = torch.as_tensor(data_range, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)

    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    ux = _uniform_filter_valid(x, win_size)
    uy = _uniform_filter_valid(y, win_size)
    uxx = _uniform_filter_valid(x * x, win_size)
    uyy = _uniform_filter_valid(y * y, win_size)
    uxy = _uniform_filter_valid(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux**2 + uy**2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    return 1 - s.mean()

