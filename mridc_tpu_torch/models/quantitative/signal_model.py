"""MEGRE signal model and its likelihood gradient (counterpart of
``mridc_tpu/models/quantitative/signal_model.py``).

``S(TE) = (S0 + i phi) exp(-TE s R2*) exp(-i TE s B0)`` with s = 1e-3, on
real views [..., 2]. The likelihood gradient's data term, per echo, is

    d_e = S^H F^-1 M (F S p_e - y_e) = N(p_e) - x0_e,
    N = S^H F^-1 M F S (K2's ``normal_op`` with mu = 0),
    x0_e = S^H F^-1 (M y_e) (K2's masked ``sens_reduce``):

:func:`megre_data_operands` folds the echoes into the batch (B*E rows, each
with its own maps and mask: K2 takes one map per row) and computes x0 once
per forward, :func:`megre_gradient` applies N to each cascade's echoes.
``normal_op`` is Hermitian, so the maps' gradient runs through K2 as well.
:func:`analytical_log_likelihood_gradient` keeps the JAX package's signature
and its composition (the mask applied once to the residual): the plain path.

The clamps and clips use ``torch.maximum``/``torch.minimum``: at a tie they
split the gradient as JAX's ``maximum`` and ``clip`` do, where ``clamp`` and
``relu`` would not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.kernels.k2_full_dc import normal_op, sens_reduce
from mridc_tpu_torch.ops.cplx import cmul, cmul_conj
from mridc_tpu_torch.ops.fft import fft2_rv, ifft2_rv

__all__ = ["megre_signal", "megre_signal_complex", "analytical_log_likelihood_gradient", "megre_data_operands",
           "megre_gradient", "rescale_by_max", "fit_megre_maps", "echo_rows", "echo_rows_mask", "first_echo_mask",
           "SCALING"]

SCALING = 1e-3
# exp/cosh/sinh argument saturation (the JAX package's _ARG_CLIP): every term
# stays finite in float32 and exact in any physically meaningful regime
_ARG_CLIP = 30.0


def _times(tes, like: torch.Tensor) -> torch.Tensor:
    """TEs [E] (ms) as float32 on ``like``'s device, scaled to seconds."""
    return torch.as_tensor(tes, dtype=torch.float32, device=like.device) * SCALING


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum, then minimum (half the gradient at a bound)."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def megre_signal(r2star, s0, b0, phi, tes, with_phase: bool = True) -> torch.Tensor:
    """Maps [B, H, W] -> echo signals [B, E, H, W, 2]."""
    t = _times(tes, r2star)[None, :, None, None]  # [1, E, 1, 1]
    decay = torch.exp(-t * r2star[:, None])
    if not with_phase:
        re = s0[:, None] * decay
        return torch.stack([re, re], dim=-1)
    cos = torch.cos(-t * b0[:, None])
    sin = torch.sin(-t * b0[:, None])
    re = s0[:, None] * decay * cos - phi[:, None] * decay * sin
    im = s0[:, None] * decay * sin + phi[:, None] * decay * cos
    return torch.nan_to_num(torch.stack([re, im], dim=-1))


def _cexp(z: torch.Tensor) -> torch.Tensor:
    ex = torch.exp(_clip(z[..., 0], -_ARG_CLIP, _ARG_CLIP))
    return torch.stack([ex * torch.cos(z[..., 1]), ex * torch.sin(z[..., 1])], dim=-1)


def _ccos(z: torch.Tensor) -> torch.Tensor:
    """cos(x)cosh(y) - i sin(x)sinh(y)."""
    y = _clip(z[..., 1], -_ARG_CLIP, _ARG_CLIP)
    return torch.stack([torch.cos(z[..., 0]) * torch.cosh(y), -torch.sin(z[..., 0]) * torch.sinh(y)], dim=-1)


def _csin(z: torch.Tensor) -> torch.Tensor:
    """sin(x)cosh(y) + i cos(x)sinh(y)."""
    y = _clip(z[..., 1], -_ARG_CLIP, _ARG_CLIP)
    return torch.stack([torch.sin(z[..., 0]) * torch.cosh(y), torch.cos(z[..., 0]) * torch.sinh(y)], dim=-1)


def _zero_nan_complex(z: torch.Tensor) -> torch.Tensor:
    """Zero the complex elements where either component is nan."""
    bad = torch.isnan(z).any(dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros((), dtype=z.dtype, device=z.device), z)


def megre_signal_complex(r2star, s0, b0, phi, tes) -> torch.Tensor:
    """The MEGRE model on complex maps (real views [B, H, W, 2] each) ->
    [B, E, H, W, 2]: every term complex, the echo ``(Re a - Im b) + i (Im a +
    Re b)``; with zero imaginary parts it is :func:`megre_signal`."""
    t = _times(tes, r2star)[None, :, None, None, None]  # [1, E, 1, 1, 1]
    first = _cexp(-t * r2star[:, None])
    second = _ccos(-t * b0[:, None])
    third = _csin(-t * b0[:, None])
    s0f = cmul(s0[:, None], first)
    phif = cmul(phi[:, None], first)
    a = _zero_nan_complex(cmul(s0f, second) - cmul(phif, third))
    b = _zero_nan_complex(cmul(s0f, third) + cmul(phif, second))
    return torch.stack([a[..., 0] - b[..., 1], a[..., 1] + b[..., 0]], dim=-1)


def _gradient_channels(diff_img, r2star, s0, b0, phi, tes) -> torch.Tensor:
    """The chain rule through the signal model: the data term ``diff_img``
    [B, E, H, W, 2] -> [B, 4, H, W] = [dR2*_re, dS0_re, dR2*_im, dS0_im],
    means over the echoes."""
    t = _times(tes, r2star)[None, :, None, None]
    decay = torch.exp(-t * r2star[:, None])
    cos = torch.cos(-t * b0[:, None])
    sin = torch.sin(-t * b0[:, None])
    s0_der = torch.stack([decay * cos, -decay * sin], dim=-1)
    r2_der = torch.stack(
        [-t * decay * (s0[:, None] * cos - phi[:, None] * sin),
         -t * decay * (-s0[:, None] * sin - phi[:, None] * cos)],
        dim=-1,
    )
    s0_grad = cmul(diff_img, s0_der).mean(dim=1)
    r2_grad = cmul(diff_img, r2_der).mean(dim=1)
    return torch.stack([r2_grad[..., 0], s0_grad[..., 0], r2_grad[..., 1], s0_grad[..., 1]], dim=1)


def analytical_log_likelihood_gradient(r2star, s0, b0, phi, tes, sens, masked_kspace, sampling_mask,
                                       fft_centered: bool = False, fft_normalization: str = "backward",
                                       spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 2) -> torch.Tensor:
    """The plain composition: ``masked_kspace`` [B, E, C, H, W, 2], ``sens``
    [B, C, H, W, 2], ``sampling_mask`` broadcastable to [B, E, C, H, W, 1]
    (or without the last axis) -> [B, 4, H, W]."""
    pred = megre_signal(r2star, s0, b0, phi, tes)
    sens_e = sens[:, None]
    pred_k = fft2_rv(cmul(pred[:, :, None], sens_e), fft_centered, fft_normalization, spatial_dims)
    if sampling_mask.ndim == masked_kspace.ndim - 1:
        sampling_mask = sampling_mask[..., None]
    diff = (pred_k - masked_kspace) * sampling_mask
    diff_img = cmul_conj(ifft2_rv(diff, fft_centered, fft_normalization, spatial_dims), sens_e).sum(dim=coil_dim)
    return _gradient_channels(diff_img, r2star, s0, b0, phi, tes)


def echo_rows_mask(sampling_mask: torch.Tensor, b: int, e: int, h: int, w: int) -> torch.Tensor:
    """A mask [B, 1, H, W] (or [B, H, W], or [B, E|1, 1, H, W, 1]) as one
    float32 row per echo: [B*E, 1, H, W], row b*E + e."""
    m = sampling_mask
    if m.ndim == 6:
        m = m[:, :, 0, :, :, 0]
    elif m.ndim == 3:
        m = m[:, None]
    return torch.broadcast_to(m.to(torch.float32), (b, e, h, w)).reshape(b * e, 1, h, w).contiguous()


def echo_rows(sens: torch.Tensor, e: int) -> torch.Tensor:
    """[B, C, H, W, 2] maps repeated to one row per echo: [B*E, C, H, W, 2],
    dense (at B=1 the reshape alone would be a view with a zero stride)."""
    return sens[:, None].expand(sens.shape[0], e, *sens.shape[1:]).reshape(sens.shape[0] * e,
                                                                         *sens.shape[1:]).contiguous()


def first_echo_mask(sampling_mask: torch.Tensor) -> torch.Tensor:
    """The mask of the reconstruction modules, [B, 1, H, W]: the mask as
    given, or echo 0's of a [B, E, 1, H, W, 1] one."""
    return sampling_mask if sampling_mask.ndim == 4 else sampling_mask[:, 0, 0, :, :, 0][:, None]


def megre_data_operands(y, sens, sampling_mask, fft_centered: bool = False,
                        fft_normalization: str = "backward", sens_be: Optional[torch.Tensor] = None):
    """The operands of :func:`megre_gradient`, once per forward: the maps
    and the mask repeated to one row per echo (they take no gradient) and
    ``x0 = S^H F^-1 (M y)`` on those rows (``sens_be``: the repeated maps,
    where the caller has them). ``y`` [B, E, C, H, W, 2] -> (sens [B*E, C, H,
    W, 2], mask [B*E, 1, H, W], x0 [B*E, H, W, 2])."""
    b, e, c, h, w, _ = y.shape
    sens_be = echo_rows(sens, e) if sens_be is None else sens_be
    mask_be = echo_rows_mask(sampling_mask, b, e, h, w)
    x0 = sens_reduce(y.reshape(b * e, c, h, w, 2), sens_be, mask_be, fft_centered, fft_normalization)
    return sens_be, mask_be, x0


def megre_gradient(r2star, s0, b0, phi, tes, sens_be, mask_be, x0, fft_centered: bool = False,
                   fft_normalization: str = "backward") -> torch.Tensor:
    """:func:`analytical_log_likelihood_gradient` on the operands of
    :func:`megre_data_operands`: the data term ``N(p_e) - x0_e`` on K2."""
    pred = megre_signal(r2star, s0, b0, phi, tes)
    b, e, h, w, _ = pred.shape
    diff_img = normal_op(pred.reshape(b * e, h, w, 2), sens_be, mask_be, 0.0, fft_centered, fft_normalization) - x0
    return _gradient_channels(diff_img.reshape(b, e, h, w, 2), r2star, s0, b0, phi, tes)


def rescale_by_max(data: torch.Tensor, slack: float = 1e-6):
    """Per-(batch, map) max-rescale over the last two axes: (scaled, gamma)."""
    gamma = torch.amax(torch.abs(data), dim=(-2, -1), keepdim=True) + slack
    return data / gamma, gamma


def fit_megre_maps(echo_images: torch.Tensor, tes) -> torch.Tensor:
    """Echo images [B, E, H, W, 2] -> maps [B, H, W, 4] = (R2*, S0, B0, phi),
    differentiable: the log-linear fit over TE of the magnitude (R2*, the
    amplitude), B0 from the least-squares slope of the pairwise wrapped phase
    differences, (S0, phi) from the B0-derotated mean phase."""
    t = _times(tes, echo_images)
    re, im = echo_images[..., 0], echo_images[..., 1]
    mag = torch.sqrt(re**2 + im**2)
    logm = torch.log(torch.maximum(mag, _const(mag, 1e-12)))

    t_mean = t.mean()
    t_ctr = (t - t_mean)[None, :, None, None]
    t_var = torch.maximum((t_ctr**2).sum(dim=1), _const(t, 1e-20))
    slope = (logm * t_ctr).sum(dim=1) / t_var
    r2star = -slope
    amp = torch.exp(_clip(logm.mean(dim=1) - slope * t_mean, -30.0, 30.0))

    zr, zi = re, im
    pr = zr[:, 1:] * zr[:, :-1] + zi[:, 1:] * zi[:, :-1]
    pi_ = zi[:, 1:] * zr[:, :-1] - zr[:, 1:] * zi[:, :-1]
    dphi = torch.atan2(pi_, pr)
    dt = (t[1:] - t[:-1])[None, :, None, None]
    b0 = -(dphi * dt).sum(dim=1) / torch.maximum((dt**2).sum(dim=1), _const(t, 1e-20))

    theta = torch.atan2(zi, zr) + t[None, :, None, None] * b0[:, None]
    ur = torch.cos(theta).sum(dim=1)
    ui = torch.sin(theta).sum(dim=1)
    theta0 = torch.atan2(ui, ur)
    s0 = amp * torch.cos(theta0)
    phi = amp * torch.sin(theta0)
    return torch.nan_to_num(torch.stack([r2star, s0, b0, phi], dim=-1))
