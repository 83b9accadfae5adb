"""K1: the psf1d likelihood gradient (``csrc/psf1d_dc.cu``) and its plain
version.

Stands for ``mridc_tpu/nn/dc.py:162-179`` ``log_likelihood_gradient_psf1d``:
``[eta, (sum_c conj(s_c) C_w (s_c eta) - z0) / sigma^2]`` as [B, H, W, 4].
"""

from __future__ import annotations

import torch

from mridc_tpu_torch.kernels.binding import launch
from mridc_tpu_torch.kernels.common import check_forward_only, check_operand, device_of
from mridc_tpu_torch.nn.dc import log_likelihood_gradient_psf1d

__all__ = ["psf1d_dc", "psf1d_dc_plain", "SYMBOLS"]

SYMBOLS = {torch.float32: "k1_psf1d_dc_f32", torch.bfloat16: "k1_psf1d_dc_bf16"}


def psf1d_dc_plain(eta, sens, mats, z0, sigma: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the kernel's oracle)."""
    return log_likelihood_gradient_psf1d(eta, sens, mats, z0, sigma=sigma)


def psf1d_dc(eta, sens, mats, z0, sigma: float = 1.0) -> torch.Tensor:
    """``eta`` [B, H, W, 2], ``sens`` [B, C, H, W, 2], ``mats`` [B, 3, W, W]
    (``psf1d_gauss_mats``), ``z0`` [B, H, W, 2], all of one dtype (float32 or
    bfloat16 on the card) -> [B, H, W, 4] in that dtype."""
    dev = device_of("psf1d_dc", eta, sens, mats, z0)
    if dev.type == "cpu":
        return psf1d_dc_plain(eta, sens, mats, z0, sigma)
    check_forward_only("psf1d_dc", (eta, sens, mats, z0))
    if sens.ndim != 5:
        raise ValueError(f"psf1d_dc: sens must be [B, C, H, W, 2], got {tuple(sens.shape)}")
    b, c, h, w, _ = sens.shape
    dts = (sens.dtype,) if sens.dtype in SYMBOLS else tuple(SYMBOLS)
    check_operand("psf1d_dc.sens", sens, (b, c, h, w, 2), dts)
    check_operand("psf1d_dc.eta", eta, (b, h, w, 2), dts)
    check_operand("psf1d_dc.mats", mats, (b, 3, w, w), dts)
    check_operand("psf1d_dc.z0", z0, (b, h, w, 2), dts)
    out = torch.empty((b, h, w, 4), dtype=sens.dtype, device=dev)
    launch(
        "psf1d_dc", SYMBOLS[sens.dtype], dev,
        eta.data_ptr(), sens.data_ptr(), mats.data_ptr(), z0.data_ptr(), out.data_ptr(),
        b, c, h, w, 1.0 / sigma**2,
    )
    return out
