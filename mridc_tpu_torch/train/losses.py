"""Reconstruction loss processing (counterpart of ``mridc_tpu/train/losses.py``).

Magnitude images normalized by their max, L1/L2/SSIM base losses, an optional
k-space branch, and the accumulated-prediction weighting
``sum_t(loss_t) * sum(logspace(-1, 0, T)) / T`` per cascade, averaged over
cascades: the reference's arithmetic (nn/cirim.py:351-363), which scales the
sum of a cascade's step losses by one mean weight rather than weighting each
step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mridc_tpu_torch.losses.ssim import ssim_loss
from mridc_tpu_torch.models.base import ModelOutput
from mridc_tpu_torch.ops.cplx import cabs2, cmul
from mridc_tpu_torch.ops.fft import fft2_rv

__all__ = ["base_loss_fn", "expand_op", "process_reconstruction_loss"]


def expand_op(x: torch.Tensor, sensitivity_maps: torch.Tensor, coil_dim: int = 1) -> torch.Tensor:
    """Expand a coil-combined image [..., H, W, 2] to multicoil with S_c * x
    (the JAX package's reading of the reference's undefined 3-argument
    ``utils.expand_op``)."""
    return cmul(x.unsqueeze(coil_dim), sensitivity_maps)


def _mag(x: torch.Tensor) -> torch.Tensor:
    """|x| of a [..., 2] real view: ``cabs``'s values, with a gradient of 0
    where x is 0 (as ``torch.abs`` of a complex tensor has it). ``cabs``, like
    the JAX package's, gives NaN there: a Noise2Recon consistency step whose
    noise mask drew nothing (the configs' noise std is 0) feeds the UNet zeros,
    its prediction is exactly 0 while the biases are, and sqrt's gradient at 0
    would make every parameter NaN."""
    m2 = cabs2(x)
    nonzero = m2 > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, m2, 1.0)), 0.0)


def _norm_mag(x: torch.Tensor) -> torch.Tensor:
    """Magnitude normalized by its max over the whole tensor (``amax``: tied
    maxima share the gradient, as in JAX); [..., 2] real views or real."""
    mag = _mag(x) if x.shape[-1] == 2 else x.abs()
    return mag / torch.clamp(mag.amax(), min=1e-12)


def base_loss_fn(name: str) -> Callable:
    name = str(name).lower()
    if name in ("l1", "mae"):
        return lambda t, p: (t - p).abs().mean()
    if name in ("l2", "mse"):
        return lambda t, p: ((t - p) ** 2).mean()
    if name == "ssim":
        return lambda t, p: ssim_loss(t[:, None], p[:, None], torch.ones(t.shape[0], device=t.device))
    raise ValueError(f"Unknown loss {name!r} (choose l1 / l2 / mse / ssim)")


def process_reconstruction_loss(
    out: ModelOutput,
    target: torch.Tensor,
    loss_type: str = "l1",
    regularization_factor: float = 1.0,
    loss_mask: Optional[torch.Tensor] = None,
    sensitivity_maps: Optional[torch.Tensor] = None,
    kspace_loss: bool = False,
    fft_centered: bool = False,
    fft_normalization: str = "backward",
) -> torch.Tensor:
    """The training loss of a model output, as the JAX package computes it.

    ``target``: [B, H, W, 2] real view or [B, H, W] real. With ``kspace_loss``
    target and prediction are expanded with the maps and transformed with
    ``fft2``, the prediction's k-space is gated by ``loss_mask`` ([B, H, W] or
    [B, 1, H, W]) and the base loss acts on raw k-space; otherwise on
    max-normalized magnitudes, and ``loss_mask`` is ignored."""
    loss_fn = base_loss_fn(loss_type)
    if kspace_loss:
        if loss_type.lower() == "ssim":
            raise ValueError("SSIM loss is not defined in k-space mode (matches reference behavior)")
        if sensitivity_maps is None:
            raise ValueError("kspace_loss=True requires sensitivity_maps")
        km = None
        if loss_mask is not None:
            km = loss_mask
            if km.ndim == 4:  # [B, 1, H, W] -> [B, H, W]
                km = km[:, 0]
            if km.ndim != 3:
                raise ValueError(f"loss_mask must be [B, H, W] or [B, 1, H, W], got {tuple(loss_mask.shape)}")
            km = km[:, None, :, :, None]  # broadcast over coil + complex dims
        t = fft2_rv(expand_op(target, sensitivity_maps), fft_centered, fft_normalization)

        def single(pred):
            p = fft2_rv(expand_op(pred, sensitivity_maps), fft_centered, fft_normalization)
            if km is not None:
                p = p * km
            return loss_fn(t, p)

    else:
        t = _norm_mag(target)

        def single(pred):
            return loss_fn(t, _norm_mag(pred))

    if out.intermediates is None:
        return single(out.prediction) * regularization_factor

    inter = out.intermediates
    if inter.ndim == out.prediction.ndim + 1:  # [T, B, H, W, 2] -> one cascade
        inter = inter[None]
    num_cascades, time_steps = inter.shape[0], inter.shape[1]
    weights_sum = float(np.sum(np.logspace(-1, 0, time_steps)))
    flat = inter.reshape((-1,) + tuple(inter.shape[2:]))
    losses = torch.stack([single(pred) for pred in flat])
    per_cascade = losses.reshape(num_cascades, time_steps).sum(dim=1) * (weights_sum / time_steps)
    return per_cascade.sum() / num_cascades * regularization_factor
