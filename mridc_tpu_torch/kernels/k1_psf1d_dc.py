"""K1: the psf1d likelihood gradient (``csrc/psf1d_dc.cu``), forward and
backward, and their plain versions.

Stands for ``mridc_tpu/nn/dc.py:162-179`` ``log_likelihood_gradient_psf1d``:
``[eta, (A(eta) - z0) / sigma^2]`` as [B, H, W, 4] with
``A(eta) = sum_c conj(s_c) C_w (s_c eta)``. A is Hermitian, so the gradient
for an upstream g is ``d_eta = g[..., :2] + A(g[..., 2:]) / sigma^2`` and
``d_z0 = -g[..., 2:] / sigma^2``. The maps' gradient (learned sensitivity
maps) is ``ds_c = (u_c conj(g[..., 2:]) + conj(eta) A_w(s_c g[..., 2:])) /
sigma^2`` with ``u_c = A_w(s_c eta)`` (A_w the [W, W] operator along W): a
kernel of its own (``csrc/psf1d_sens.cu``) that writes d_eta in the same pass,
launched in place of the backward kernel when the maps take a gradient; the
forward then saves eta (image-sized). Both dtypes run both products on the
tensor cores with the operator held on chip across the coils (bf16 up to W =
352; float32 on 3xTF32 up to W = 320) and take the first version's kernel,
on the CUDA cores, at wider W.
The gradient with respect to the operator is not ported.

:func:`psf1d_normal` is the normal operator A alone (VarNet's psf1d q-term,
``mridc_tpu/models/recon/vn.py:63-77``): channels 2:4 of the same kernels with
z0 = 0 and sigma = 1.

While a model is exported, the forward launch is the custom op
``mridc_tpu_torch::k1_psf1d_dc`` (``kernels/common.py``): the kernel on CUDA
tensors, :func:`psf1d_dc_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from mridc_tpu_torch.kernels.binding import launch, query
from mridc_tpu_torch.kernels.common import check_operand, dense, device_of, refuse_grads
from mridc_tpu_torch.nn.dc import apply_psf1d, log_likelihood_gradient_psf1d
from mridc_tpu_torch.ops.cplx import cmul, cmul_conj

__all__ = ["psf1d_dc", "psf1d_dc_plain", "psf1d_dc_bwd", "psf1d_dc_bwd_plain", "psf1d_dc_sens_bwd",
           "psf1d_dc_sens_bwd_plain", "bf16_setup", "f32_setup", "sens_bf16_setup", "sens_f32_setup",
           "psf1d_normal", "SYMBOLS", "BWD_SYMBOLS", "SENS_SYMBOLS"]

SYMBOLS = {torch.float32: "k1_psf1d_dc_f32", torch.bfloat16: "k1_psf1d_dc_bf16"}
BWD_SYMBOLS = {torch.float32: "k1_psf1d_dc_bwd_f32", torch.bfloat16: "k1_psf1d_dc_bwd_bf16"}
SENS_SYMBOLS = {torch.float32: "k1_psf1d_sens_f32", torch.bfloat16: "k1_psf1d_sens_bf16"}


def psf1d_dc_plain(eta, sens, mats, z0, sigma: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the kernel's oracle)."""
    return log_likelihood_gradient_psf1d(eta, sens, mats, z0, sigma=sigma)


def psf1d_dc_bwd_plain(g, sens, mats, sigma: float = 1.0) -> torch.Tensor:
    """Plain version of the backward kernel: ``g`` [B, H, W, 4] ->
    ``g[..., :2] + A(g[..., 2:]) / sigma^2`` [B, H, W, 2]."""
    v = g[..., 2:]
    return g[..., :2] + log_likelihood_gradient_psf1d(v, sens, mats, torch.zeros_like(v), sigma=sigma)[..., 2:]


def psf1d_dc_sens_bwd_plain(g, eta, sens, mats, sigma: float = 1.0):
    """Plain version of the maps-gradient kernel: ``g`` [B, H, W, 4] ->
    (d_eta [B, H, W, 2], d_sens [B, C, H, W, 2])."""
    g2 = g[..., 2:]
    u = apply_psf1d(cmul(eta.unsqueeze(1), sens), mats)
    v = apply_psf1d(cmul(g2.unsqueeze(1), sens), mats)
    d_sens = (cmul_conj(u, g2.unsqueeze(1)) + cmul_conj(v, eta.unsqueeze(1))) / sigma**2
    return g[..., :2] + cmul_conj(v, sens).sum(dim=1) / sigma**2, d_sens


SETUP_KEYS = ("blocks", "smem_bytes", "blocks_per_sm", "threads", "tile_h", "tile_u")
ROUTES = ("on_chip", "wide")
_SETUPS: Dict[tuple, Dict[str, object]] = {}


def _setup(lib: str, symbol: str, b: int, h: int, w: int, device: torch.device, *flag: int) -> Dict[str, object]:
    """The launch setup that query ``symbol`` of library ``lib`` reports at
    [B, H, W] on ``device`` (cached); ``flag`` precedes the shape in the
    query's arguments."""
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (symbol, b, h, w, index, *flag)
    if key not in _SETUPS:
        info = (ctypes.c_int * (len(SETUP_KEYS) + 1))()
        query(lib, symbol, device, *flag, b, h, w, index, info)
        _SETUPS[key] = {**dict(zip(SETUP_KEYS, info)), "route": ROUTES[info[-1]]}
    return dict(_SETUPS[key])


def bf16_setup(b: int, h: int, w: int, device: torch.device, bwd: bool = False) -> Dict[str, object]:
    """The bf16 kernel's launch at [B, H, W] on ``device`` (cached): grid
    blocks, shared memory a block, blocks per SM, threads a block, the tile's
    rows h and columns u, and its route: ``on_chip`` (the operator's tile rows
    held in shared memory, W <= 480) or ``wide`` (the first version's kernel,
    any W)."""
    return _setup("psf1d_dc", "k1_psf1d_dc_bf16_setup", b, h, w, device, int(bwd))


def f32_setup(b: int, h: int, w: int, device: torch.device, bwd: bool = False) -> Dict[str, object]:
    """The float32 kernel's launch at [B, H, W] on ``device`` (cached), as
    :func:`bf16_setup`; its on-chip route takes W <= 416."""
    return _setup("psf1d_dc", "k1_psf1d_dc_f32_setup", b, h, w, device, int(bwd))


def sens_bf16_setup(b: int, h: int, w: int, device: torch.device) -> Dict[str, object]:
    """The bf16 maps-gradient kernel's launch at [B, H, W] on ``device``
    (cached), as :func:`bf16_setup`: ``on_chip`` (32 x 64 tiles with the
    operator's tile rows held in shared memory across the coils, W <= 352)
    or ``wide`` (the first version's kernel, any W)."""
    return _setup("psf1d_sens", "k1_psf1d_sens_bf16_setup", b, h, w, device)


def sens_f32_setup(b: int, h: int, w: int, device: torch.device) -> Dict[str, object]:
    """The float32 maps-gradient kernel's launch at [B, H, W] on ``device``
    (cached), as :func:`bf16_setup`: ``on_chip`` (16 x 32 tiles up to W =
    320, the operator's tile rows held in shared memory across the coils,
    products on 3xTF32) or ``wide`` (the first version's kernel, any W)."""
    return _setup("psf1d_sens", "k1_psf1d_sens_f32_setup", b, h, w, device)


def _shape(name, sens, dtype):
    if sens.ndim != 5:
        raise ValueError(f"{name}: sens must be [B, C, H, W, 2], got {tuple(sens.shape)}")
    return sens.shape[:4], ((dtype,) if dtype in SYMBOLS else tuple(SYMBOLS))


def _forward_kernel(eta, sens, mats, z0, sigma, dev) -> torch.Tensor:
    (b, c, h, w), dts = _shape("psf1d_dc", sens, sens.dtype)
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


def psf1d_dc_bwd(g, sens, mats, sigma: float = 1.0) -> torch.Tensor:
    """The backward kernel's wrapper: ``g`` [B, H, W, 4] -> d_eta [B, H, W, 2]
    (plain version for CPU tensors)."""
    dev = device_of("psf1d_dc_bwd", g, sens, mats)
    if dev.type == "cpu":
        return psf1d_dc_bwd_plain(g, sens, mats, sigma)
    (b, c, h, w), dts = _shape("psf1d_dc_bwd", sens, sens.dtype)
    g = dense("psf1d_dc_bwd", g.to(sens.dtype))
    check_operand("psf1d_dc_bwd.sens", sens, (b, c, h, w, 2), dts)
    check_operand("psf1d_dc_bwd.g", g, (b, h, w, 4), dts)
    check_operand("psf1d_dc_bwd.mats", mats, (b, 3, w, w), dts)
    out = torch.empty((b, h, w, 2), dtype=sens.dtype, device=dev)
    launch("psf1d_dc", BWD_SYMBOLS[sens.dtype], dev, g.data_ptr(), sens.data_ptr(), mats.data_ptr(), out.data_ptr(),
           b, c, h, w, 1.0 / sigma**2)
    return out


def psf1d_dc_sens_bwd(g, eta, sens, mats, sigma: float = 1.0):
    """The maps-gradient kernel's wrapper: ``g`` [B, H, W, 4] -> (d_eta
    [B, H, W, 2], d_sens [B, C, H, W, 2]) in the operands' dtype (plain
    version for CPU tensors)."""
    dev = device_of("psf1d_dc_sens_bwd", g, eta, sens, mats)
    if dev.type == "cpu":
        return psf1d_dc_sens_bwd_plain(g, eta, sens, mats, sigma)
    (b, c, h, w), dts = _shape("psf1d_dc_sens_bwd", sens, sens.dtype)
    g = dense("psf1d_dc_sens_bwd", g.to(sens.dtype))
    check_operand("psf1d_dc_sens_bwd.sens", sens, (b, c, h, w, 2), dts)
    check_operand("psf1d_dc_sens_bwd.g", g, (b, h, w, 4), dts)
    check_operand("psf1d_dc_sens_bwd.eta", eta, (b, h, w, 2), dts)
    check_operand("psf1d_dc_sens_bwd.mats", mats, (b, 3, w, w), dts)
    d_sens = torch.empty((b, c, h, w, 2), dtype=sens.dtype, device=dev)
    d_eta = torch.empty((b, h, w, 2), dtype=sens.dtype, device=dev)
    launch("psf1d_sens", SENS_SYMBOLS[sens.dtype], dev, g.data_ptr(), eta.data_ptr(), sens.data_ptr(),
           mats.data_ptr(), d_sens.data_ptr(), d_eta.data_ptr(), b, c, h, w, 1.0 / sigma**2)
    return d_eta, d_sens


@torch.library.custom_op("mridc_tpu_torch::k1_psf1d_dc", mutates_args=())
def psf1d_dc_op(eta: torch.Tensor, sens: torch.Tensor, mats: torch.Tensor, z0: torch.Tensor,
                sigma: float) -> torch.Tensor:
    """The forward launch as a custom op: the plain version (CPU)."""
    return psf1d_dc_plain(eta, sens, mats, z0, sigma)


@psf1d_dc_op.register_kernel("cuda")
def _(eta, sens, mats, z0, sigma):
    return _forward_kernel(eta, sens, mats, z0, sigma, eta.device)


@psf1d_dc_op.register_fake
def _(eta, sens, mats, z0, sigma):
    return sens.new_empty((*eta.shape[:3], 4))


class _Psf1dDC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eta, sens, mats, z0, sigma):
        ctx.save_for_backward(sens, mats, eta if ctx.needs_input_grad[1] else None)
        ctx.sigma = sigma
        if torch.compiler.is_exporting():
            return psf1d_dc_op(eta, sens, mats, z0, float(sigma))
        if eta.device.type == "cpu":
            return psf1d_dc_plain(eta, sens, mats, z0, sigma)
        return _forward_kernel(eta, sens, mats, z0, sigma, eta.device)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("psf1d_dc", ctx.needs_input_grad, {2: "mats"})
        sens, mats, eta = ctx.saved_tensors
        d_sens = None
        if ctx.needs_input_grad[1]:
            d_eta, d_sens = psf1d_dc_sens_bwd(g, eta, sens, mats, ctx.sigma)
            d_eta = d_eta if ctx.needs_input_grad[0] else None
        else:
            d_eta = psf1d_dc_bwd(g, sens, mats, ctx.sigma) if ctx.needs_input_grad[0] else None
        d_z0 = -g[..., 2:] / ctx.sigma**2 if ctx.needs_input_grad[3] else None
        return d_eta, d_sens, None, d_z0, None


def psf1d_dc(eta, sens, mats, z0, sigma: float = 1.0) -> torch.Tensor:
    """``eta`` [B, H, W, 2], ``sens`` [B, C, H, W, 2], ``mats`` [B, 3, W, W]
    (``psf1d_gauss_mats``), ``z0`` [B, H, W, 2], all of one dtype (float32 or
    bfloat16 on the card) -> [B, H, W, 4] in that dtype; differentiable in
    ``eta``, ``sens`` and ``z0``."""
    device_of("psf1d_dc", eta, sens, mats, z0)
    return _Psf1dDC.apply(eta, sens, mats, z0, sigma)


def psf1d_normal(u, sens, mats, zero) -> torch.Tensor:
    """``A(u) = sum_c conj(s_c) C_w (s_c u)`` [B, H, W, 2] in the operands'
    dtype: channels 2:4 of :func:`psf1d_dc` with ``z0 = zero`` (a zero
    [B, H, W, 2] of that dtype, which the caller allocates once) and sigma 1;
    differentiable in ``u`` (its gradient is A of the upstream, on K1's
    backward kernels)."""
    return psf1d_dc(u, sens, mats, zero, 1.0)[..., 2:]
