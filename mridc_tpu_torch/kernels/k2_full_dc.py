"""K2: the full-mask likelihood gradient and the SENSE expansion and reduction
as kernel stages around cuFFT (``csrc/full_dc.cu``), forward and backward, and
their plain versions.

Stands for ``mridc_tpu/nn/dc.py:81-101`` ``log_likelihood_gradient``,
``:44-56`` ``sens_expand`` and ``:59-71`` ``sens_reduce`` (the SENSE init, the
psf1d data term z0, the soft-DC tails and VarNet's full route). The centering
shifts are folded into the stages' indices, so no ``fftshift`` copy or
``torch.roll`` runs; the transforms are ``torch.fft`` on complex64:

    full_dc     = reduce(ifft2(residual(fft2(expand(eta, s)), y, m)), s, eta)
    sens_expand = apply_mask(fft2(expand(x, s)), m)   [FFT order; m optional]
    sens_reduce = reduce(ifft2(load(k, m)), s)

With ``sh = n // 2`` on a centered axis (0 otherwise), the ifftshift of a
transform's input reads index ``(i + sh) % n`` and the fftshift of its output
reads ``(i + n - sh) % n``. Between the forward and the inverse transform the
two shifts cancel for any n, so ``residual`` works in place on the FFT output.

k-space order: a centered k-space tensor is the FFT's output fftshifted. With
``fft_order=True``, :func:`sens_expand` returns and :func:`sens_reduce` takes
k-space in the FFT's own order (the centered tensor ifftshifted;
:func:`to_fft_order`), which saves the shift pass of each call; a caller that
mixes k-space tensors elementwise only (VarNet's cascades) holds them all in
that order. Otherwise :func:`sens_expand` fftshifts its output with the
``load`` stage (``fftshift=True``) when centered.

The eta -> grad map is ``S^H F^-1 M F S / sigma^2``, Hermitian in every mode,
so the backward of :func:`full_dc` for an upstream g [B, H, W, 4] is the same
chain with y = 0 on ``g[..., 2:]``, its reduce adding ``g[..., :2]``:

    d_eta = reduce_acc(ifft2(apply_mask(fft2(expand(g[..., 2:], s)))), s, g)

SENSE expansion and reduction are each other's adjoints up to the FFT's
normalisation: the adjoint of ``fft2`` under ``norm`` is ``ifft2`` under the
swapped one ("backward" <-> "forward", "ortho" itself), so

    d_x (sens_expand) = reduce(ifft2(load(g, m)), s)   [ifft2 adjoint-normalised]
    d_k (sens_reduce) = m * fft2(expand(g, s))          [fft2 adjoint-normalised]

With a mask, :func:`sens_expand` is the masked forward operator M F S of the
primal-dual models (XPDNet, LPDNet) and its backward the masked reduction:
each is one Function call, with no coil-sized ``torch.where``.

The normal operator of the conjugate-gradient data consistency
(``mridc_tpu/models/recon/resnet.py:67-71`` ``ehe``) is the same chain without
y, plus a learned multiple of its input:

    normal_op(x) = reduce(ifft2(apply_mask(fft2(expand(x, s)))), s) + mu * x

It is Hermitian too, so its backward is itself applied to the upstream g, and
mu's gradient is the real inner product of x and g. Its Function saves the maps
and the mask (the same tensors at every CG iteration) and, when mu or the
maps take a gradient, the image-sized x: no coil-sized tensor is kept per call.

The maps' gradient (learned sensitivity maps): for each Function it is one
or two products of a coil image with the conjugate of an image-sized tensor,
written by the ``sens_grad`` stage (plain: :func:`sens_grad_plain`), which
also forms the coil sum that ``reduce``/``reduce_acc`` write where the chain
needs one, so the backward reads each coil image once. With G = g[..., 2:]:

    full_dc      ds_c = (r_c conj(G) + q_c conj(eta)) / sigma^2, d_eta in the same pass
                 r_c = F^-1 M (F(s_c eta) - y)  (the forward's residual image,
                 recomputed), q_c = F^-1 M F(s_c G)  (d_eta's chain)
    normal_op    the same with y = 0, sigma 1 and G = g
    sens_expand  ds_c = t_c conj(x), t_c = F^H(M g_c)  (d_x's chain; its sum is d_x)
    sens_reduce  ds_c = p_c conj(g), p_c = F^-1(M k)    (recomputed)

Each recomputes its forward's coil image instead of saving it, so a
Function keeps no coil-sized tensor per call: it saves the image-sized input
(and y, an input that lives on anyway) only when the maps take a gradient.
When they do not, a call launches and saves what it did before.

Each stage has a wrapper (plain version for CPU tensors, kernel for CUDA
tensors) and a plain version written with the same index arithmetic as its
kernel; :func:`full_dc`, :func:`sens_expand` and :func:`sens_reduce` take the
JAX-identical ``nn/dc.py`` functions on the CPU and the stages on the card.
They are differentiable in ``eta``, the image, the k-space and the maps on
both; the gradients with respect to y and the mask are not ported.

While a model is exported, the forward stages are the custom ops
``mridc_tpu_torch::k2_expand``, ``k2_residual``, ``k2_load``, ``k2_reduce``
and ``k2_mask`` (``kernels/common.py``; residual and mask work in place on
the FFT's output, as their kernels do), and the Functions take the stages on
CPU tensors too, so that an exported program holds the card's chain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mridc_tpu_torch.kernels.binding import launch
from mridc_tpu_torch.kernels.common import check_operand, dense, device_of, plain_route, refuse_grads
from mridc_tpu_torch.nn import dc
from mridc_tpu_torch.ops.cplx import cmul, cmul_conj
from mridc_tpu_torch.ops.fft import _norm, fft2_rv, ifft2_rv

__all__ = [
    "full_dc", "full_dc_plain", "full_dc_bwd", "full_dc_bwd_plain", "sens_reduce", "sens_reduce_plain",
    "sens_reduce_bwd", "sens_reduce_bwd_plain", "sens_expand", "sens_expand_plain", "sens_expand_bwd",
    "sens_expand_bwd_plain", "to_fft_order", "from_fft_order", "normal_op", "normal_op_plain",
    "expand", "residual", "load", "reduce", "apply_mask", "reduce_acc", "sens_grad",
    "expand_plain", "residual_plain", "load_plain", "reduce_plain", "apply_mask_plain", "reduce_acc_plain",
    "sens_grad_plain", "full_dc_bwd_sens", "full_dc_bwd_sens_plain", "sens_expand_bwd_sens",
    "sens_expand_bwd_sens_plain", "sens_reduce_bwd_sens", "sens_reduce_bwd_sens_plain", "normal_op_bwd_sens",
    "normal_op_bwd_sens_plain",
]

_F32 = (torch.float32,)
_C64 = (torch.complex64,)


def _shifts(h: int, w: int, centered: bool, fftshift: bool = False):
    """Index offsets of the ifftshift (or, with ``fftshift``, the fftshift)
    over [H, W] on a centered axis pair; (0, 0) otherwise."""
    if not centered:
        return 0, 0
    return ((h - h // 2) % h, (w - w // 2) % w) if fftshift else (h // 2, w // 2)


def _adjoint_norm(normalization: str) -> str:
    """The normalisation whose inverse FFT is the adjoint of the FFT under
    ``normalization`` (and the other way round)."""
    return {"backward": "forward", "forward": "backward", "ortho": "ortho"}[_norm(normalization)]


def _gather(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """x[..., (i + sh) % H, (j + sw) % W] over the last two axes."""
    h, w = x.shape[-2], x.shape[-1]
    ih = (torch.arange(h, device=x.device) + sh) % h
    iw = (torch.arange(w, device=x.device) + sw) % w
    return x[..., ih, :][..., iw]


# ---- plain versions of the stages (same index arithmetic as the kernels) ----


def expand_plain(eta, sens, centered: bool) -> torch.Tensor:
    """[B, H, W, 2], [B, C, H, W, 2] -> complex64 [B, C, H, W]: ifftshift(s * eta)."""
    sh, sw = _shifts(eta.shape[1], eta.shape[2], centered)
    return _gather(torch.view_as_complex(cmul(eta.unsqueeze(1), sens).contiguous()), sh, sw)


def residual_plain(k, y, mask, centered: bool) -> torch.Tensor:
    """complex [B, C, H, W] FFT output -> m * (k - y) with m, y read at the shifted index."""
    b, _, h, w = k.shape
    sh, sw = _shifts(h, w, centered)
    m = _gather(torch.broadcast_to(mask, (b, 1, h, w)), sh, sw)
    return m * (k - _gather(torch.view_as_complex(y.contiguous()), sh, sw))


def apply_mask_plain(k, mask, centered: bool) -> torch.Tensor:
    """complex [B, C, H, W] FFT output -> m * k with m read at the shifted index."""
    b, _, h, w = k.shape
    sh, sw = _shifts(h, w, centered)
    return _gather(torch.broadcast_to(mask, (b, 1, h, w)), sh, sw) * k


def load_plain(y, mask: Optional[torch.Tensor], centered: bool, fftshift: bool = False) -> torch.Tensor:
    """[B, C, H, W, 2] -> complex [B, C, H, W]: ifftshift(m * y) (m optional;
    with ``fftshift``, the fftshift)."""
    b, _, h, w, _ = y.shape
    sh, sw = _shifts(h, w, centered, fftshift)
    q = _gather(torch.view_as_complex(y.contiguous()), sh, sw)
    return q if mask is None else _gather(torch.broadcast_to(mask, (b, 1, h, w)), sh, sw) * q


def reduce_plain(p, sens, eta: Optional[torch.Tensor], centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """complex [B, C, H, W] inverse-FFT output -> sum_c conj(s_c) fftshift(p_c) / sigma^2,
    as [eta, grad] [B, H, W, 4] or grad [B, H, W, 2]."""
    h, w = p.shape[-2], p.shape[-1]
    sh, sw = _shifts(h, w, centered)
    r = torch.view_as_real(_gather(p, (h - sh) % h, (w - sw) % w))
    grad = cmul_conj(r, sens).sum(dim=1) * (1.0 / sigma**2)
    return grad if eta is None else torch.cat([eta, grad], dim=-1)


def reduce_acc_plain(p, sens, g, centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """``g[..., :2]`` plus the reduce of ``p``: [B, H, W, 2]."""
    return g[..., :2] + reduce_plain(p, sens, None, centered, sigma)


def sens_grad_plain(a, b, centered: bool, scale: float = 1.0, a2=None, b2=None, sens=None, acc=None):
    """complex [B, C, H, W] inverse-FFT outputs ``a`` (and ``a2``) read at the
    fftshifted index, [B, H, W, 2] ``b`` (and ``b2``) -> ``ds = scale * (a b^* +
    a2 b2^*)`` [B, C, H, W, 2] and, with ``sens``, ``acc[..., :2] + scale *
    sum_c conj(s_c) a_c`` [B, H, W, 2] (else None)."""
    h, w = a.shape[-2], a.shape[-1]
    sh, sw = _shifts(h, w, centered)

    def image(p):
        return torch.view_as_real(_gather(p, (h - sh) % h, (w - sw) % w))

    ra = image(a)
    ds = cmul_conj(ra, b.unsqueeze(1))
    if a2 is not None:
        ds = ds + cmul_conj(image(a2), b2.unsqueeze(1))
    if sens is None:
        return ds * scale, None
    total = cmul_conj(ra, sens).sum(dim=1) * scale
    return ds * scale, total if acc is None else acc[..., :2] + total


def full_dc_plain(eta, y, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward",
                  spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the whole chain (the CPU path)."""
    return dc.log_likelihood_gradient(
        eta, y, sens, mask, sigma, fft_centered, fft_normalization, spatial_dims, coil_dim
    )


def full_dc_bwd_plain(g, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward") -> torch.Tensor:
    """Plain version of the backward chain: ``g`` [B, H, W, 4] ->
    ``g[..., :2] + S^H F^-1 M F S g[..., 2:] / sigma^2`` [B, H, W, 2]."""
    coil = dc.sens_expand(g[..., 2:], sens, fft_centered, fft_normalization)
    back = dc.sens_reduce(dc.expand_rv_mask(mask) * coil, sens, fft_centered, fft_normalization)
    return g[..., :2] + back / sigma**2


def full_dc_bwd_sens_plain(g, eta, y, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward"):
    """Plain version of the backward chain with the maps' gradient: ``g``
    [B, H, W, 4] -> (d_eta [B, H, W, 2], d_sens [B, C, H, W, 2])."""
    m = dc.expand_rv_mask(mask)
    g2 = g[..., 2:]
    r = ifft2_rv(m * (dc.sens_expand(eta, sens, fft_centered, fft_normalization) - y), fft_centered,
                 fft_normalization)
    q = ifft2_rv(m * dc.sens_expand(g2, sens, fft_centered, fft_normalization), fft_centered, fft_normalization)
    d_sens = (cmul_conj(r, g2.unsqueeze(1)) + cmul_conj(q, eta.unsqueeze(1))) / sigma**2
    return g[..., :2] + cmul_conj(q, sens).sum(dim=1) / sigma**2, d_sens


def _reorder_plain(kspace, centered: bool, fftshift: bool) -> torch.Tensor:
    """Real-view k-space [..., H, W, 2] ifftshifted (centered -> FFT order) or
    fftshifted (back), when centered."""
    if not centered:
        return kspace
    return (torch.fft.fftshift if fftshift else torch.fft.ifftshift)(kspace, dim=(-3, -2))


def sens_reduce_plain(kspace, sens, mask=None, fft_centered=False, fft_normalization="backward",
                      spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1, fft_order: bool = False
                      ) -> torch.Tensor:
    """Plain PyTorch version: ``sens_reduce(mask * kspace)`` (mask optional;
    ``fft_order``: kspace in FFT order, no mask)."""
    kspace = _reorder_plain(kspace, fft_centered and fft_order, True)
    if mask is not None:
        kspace = dc.expand_rv_mask(mask) * kspace
    return dc.sens_reduce(kspace, sens, fft_centered, fft_normalization, spatial_dims, coil_dim)


def sens_reduce_bwd_plain(g, sens, mask=None, fft_centered=False, fft_normalization="backward",
                          fft_order: bool = False) -> torch.Tensor:
    """Plain version of :func:`sens_reduce`'s backward: ``g`` [B, H, W, 2] ->
    d_k = m * F(s g) [B, C, H, W, 2] with the adjoint's normalisation."""
    k = dc.sens_expand(g, sens, fft_centered, _adjoint_norm(fft_normalization))
    if mask is not None:
        k = dc.expand_rv_mask(mask) * k
    return _reorder_plain(k, fft_centered and fft_order, False)


def sens_expand_plain(image, sens, fft_centered=False, fft_normalization="backward", fft_order: bool = False,
                      mask=None) -> torch.Tensor:
    """Plain PyTorch version: ``mask * sens_expand(image)`` with ``nn/dc.py``'s
    ``sens_expand`` ([B, H, W, 2] -> [B, C, H, W, 2]; mask optional), in FFT
    order with ``fft_order`` (no mask)."""
    k = dc.sens_expand(image, sens, fft_centered, fft_normalization)
    if mask is not None:
        k = dc.expand_rv_mask(mask) * k
    return _reorder_plain(k, fft_centered and fft_order, False)


def sens_expand_bwd_plain(g, sens, fft_centered=False, fft_normalization="backward", fft_order: bool = False,
                          mask=None) -> torch.Tensor:
    """Plain version of :func:`sens_expand`'s backward: ``g`` [B, C, H, W, 2]
    -> d_x = sum_c conj(s_c) F^H(m g_c) [B, H, W, 2] (mask optional)."""
    g = _reorder_plain(g, fft_centered and fft_order, True)
    if mask is not None:
        g = dc.expand_rv_mask(mask) * g
    return dc.sens_reduce(g, sens, fft_centered, _adjoint_norm(fft_normalization))


def sens_reduce_bwd_sens_plain(g, kspace, sens, mask=None, fft_centered=False, fft_normalization="backward",
                               fft_order: bool = False) -> torch.Tensor:
    """Plain version of :func:`sens_reduce`'s maps gradient: ``g`` [B, H, W, 2]
    -> ``p_c conj(g)`` [B, C, H, W, 2], p_c = F^-1(m k_c)."""
    kspace = _reorder_plain(kspace, fft_centered and fft_order, True)
    if mask is not None:
        kspace = dc.expand_rv_mask(mask) * kspace
    return cmul_conj(ifft2_rv(kspace, fft_centered, fft_normalization), g.unsqueeze(1))


def sens_expand_bwd_sens_plain(g, image, sens, fft_centered=False, fft_normalization="backward",
                               fft_order: bool = False, mask=None):
    """Plain version of :func:`sens_expand`'s backward with the maps' gradient:
    ``g`` [B, C, H, W, 2] -> (d_x [B, H, W, 2], d_sens = t_c conj(x)), t_c =
    F^H(m g_c)."""
    g = _reorder_plain(g, fft_centered and fft_order, True)
    if mask is not None:
        g = dc.expand_rv_mask(mask) * g
    t = ifft2_rv(g, fft_centered, _adjoint_norm(fft_normalization))
    return cmul_conj(t, sens).sum(dim=1), cmul_conj(t, image.unsqueeze(1))


# ---- stage wrappers: plain version on the CPU, kernel on the card ----


def _coil_dims(name, sens):
    if sens.ndim != 5 or sens.shape[-1] != 2:
        raise ValueError(f"{name}: sens must be [B, C, H, W, 2], got {tuple(sens.shape)}")
    return sens.shape[:4]


def _mask_operand(name, mask, b, h, w) -> torch.Tensor:
    m = torch.broadcast_to(mask, (b, 1, h, w)).to(torch.float32).contiguous()
    check_operand(name, m, (b, 1, h, w), _F32)
    return m


def _eta_stride(eta, b, h, w, name: str = "full_dc.expand.eta") -> int:
    """float2s from one pixel of ``eta`` to the next: 1 for a contiguous
    [B, H, W, 2], 2 for channels 0:2 or 2:4 of a contiguous [B, H, W, 4]."""
    if tuple(eta.shape) != (b, h, w, 2) or eta.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 {(b, h, w, 2)}, got {eta.dtype} {tuple(eta.shape)}")
    for es in (1, 2):
        if eta.stride() == (h * w * 2 * es, w * 2 * es, 2 * es, 1) and eta.data_ptr() % 8 == 0:
            return es
    raise ValueError(f"{name}: the kernel needs a contiguous [B, H, W, 2] or channels 2:4 (or 0:2) of a "
                     "contiguous [B, H, W, 4]")


def expand(eta, sens, centered: bool) -> torch.Tensor:
    """Stage (a): complex64 [B, C, H, W] = ifftshift(s * eta); ``eta`` may be
    channels 2:4 of a contiguous [B, H, W, 4] (the backward's g)."""
    dev = device_of("full_dc.expand", eta, sens)
    if torch.compiler.is_exporting():
        return expand_op(eta, sens, centered)
    if dev.type == "cpu":
        return expand_plain(eta, sens, centered)
    b, c, h, w = _coil_dims("full_dc.expand", sens)
    check_operand("full_dc.expand.sens", sens, (b, c, h, w, 2), _F32, align=8)
    es = _eta_stride(eta, b, h, w)
    x = torch.empty((b, c, h, w), dtype=torch.complex64, device=dev)
    launch("full_dc", "k2_expand", dev, eta.data_ptr(), sens.data_ptr(), x.data_ptr(), b, c, h, w,
           *_shifts(h, w, centered), es)
    return x


def residual(k, y, mask, centered: bool) -> torch.Tensor:
    """Stage (b): m * (k - y) on the forward FFT's output; on the card it
    overwrites ``k`` and returns it."""
    dev = device_of("full_dc.residual", k, y, mask)
    if torch.compiler.is_exporting():
        residual_op(k, y, mask, centered)
        return k
    if dev.type == "cpu":
        return residual_plain(k, y, mask, centered)
    b, c, h, w = k.shape
    check_operand("full_dc.residual.k", k, (b, c, h, w), _C64)
    check_operand("full_dc.residual.y", y, (b, c, h, w, 2), _F32)
    m = _mask_operand("full_dc.residual.mask", mask, b, h, w)
    launch("full_dc", "k2_residual", dev, k.data_ptr(), y.data_ptr(), m.data_ptr(), b, c, h, w,
           *_shifts(h, w, centered))
    return k


def apply_mask(k, mask, centered: bool) -> torch.Tensor:
    """Backward stage (mask): m * k on the forward FFT's output; on the card
    it overwrites ``k`` and returns it."""
    dev = device_of("full_dc.mask", k, mask)
    if torch.compiler.is_exporting():
        apply_mask_op(k, mask, centered)
        return k
    if dev.type == "cpu":
        return apply_mask_plain(k, mask, centered)
    b, c, h, w = k.shape
    check_operand("full_dc.mask.k", k, (b, c, h, w), _C64)
    m = _mask_operand("full_dc.mask.mask", mask, b, h, w)
    launch("full_dc", "k2_mask", dev, k.data_ptr(), m.data_ptr(), b, c, h, w, *_shifts(h, w, centered))
    return k


def load(y, mask: Optional[torch.Tensor], centered: bool, fftshift: bool = False) -> torch.Tensor:
    """Stage (load): complex64 [B, C, H, W] = ifftshift(m * y), m optional;
    with ``fftshift`` the fftshift (the FFT's output back to centered order)."""
    dev = device_of("full_dc.load", y, mask)
    if torch.compiler.is_exporting():
        return load_op(y, mask, centered, fftshift)
    if dev.type == "cpu":
        return load_plain(y, mask, centered, fftshift)
    b, c, h, w = _coil_dims("full_dc.load", y)
    check_operand("full_dc.load.y", y, (b, c, h, w, 2), _F32, align=8)
    m = None if mask is None else _mask_operand("full_dc.load.mask", mask, b, h, w)
    q = torch.empty((b, c, h, w), dtype=torch.complex64, device=dev)
    launch("full_dc", "k2_load", dev, y.data_ptr(), None if m is None else m.data_ptr(), q.data_ptr(),
           b, c, h, w, *_shifts(h, w, centered, fftshift))
    return q


def reduce(p, sens, eta: Optional[torch.Tensor], centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """Stage (c): sum_c conj(s_c) fftshift(p_c) / sigma^2, as [eta, grad] or grad."""
    dev = device_of("full_dc.reduce", p, sens, eta)
    if torch.compiler.is_exporting():
        return reduce_op(p, sens, eta, centered, float(sigma))
    if dev.type == "cpu":
        return reduce_plain(p, sens, eta, centered, sigma)
    b, c, h, w = _coil_dims("full_dc.reduce", sens)
    check_operand("full_dc.reduce.p", p, (b, c, h, w), _C64)
    check_operand("full_dc.reduce.sens", sens, (b, c, h, w, 2), _F32)
    if eta is not None:
        check_operand("full_dc.reduce.eta", eta, (b, h, w, 2), _F32)
    out = torch.empty((b, h, w, 2 if eta is None else 4), dtype=torch.float32, device=dev)
    launch("full_dc", "k2_reduce", dev, p.data_ptr(), sens.data_ptr(), None if eta is None else eta.data_ptr(),
           out.data_ptr(), b, c, h, w, *_shifts(h, w, centered), 1.0 / sigma**2)
    return out


def reduce_acc(p, sens, g, centered: bool, sigma: float = 1.0) -> torch.Tensor:
    """Backward stage (reduce_acc): ``g[..., :2] + sum_c conj(s_c)
    fftshift(p_c) / sigma^2``, [B, H, W, 2] float32, from ``g`` [B, H, W, 4]."""
    dev = device_of("full_dc.reduce_acc", p, sens, g)
    if dev.type == "cpu":
        return reduce_acc_plain(p, sens, g, centered, sigma)
    b, c, h, w = _coil_dims("full_dc.reduce_acc", sens)
    check_operand("full_dc.reduce_acc.p", p, (b, c, h, w), _C64)
    check_operand("full_dc.reduce_acc.sens", sens, (b, c, h, w, 2), _F32)
    check_operand("full_dc.reduce_acc.g", g, (b, h, w, 4), _F32)
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    launch("full_dc", "k2_reduce_acc", dev, p.data_ptr(), sens.data_ptr(), g.data_ptr(), out.data_ptr(),
           b, c, h, w, *_shifts(h, w, centered), 1.0 / sigma**2)
    return out


def sens_grad(a, b, centered: bool, scale: float = 1.0, a2=None, b2=None, sens=None, acc=None):
    """Stage (sens_grad): ``ds = scale * (a b^* [+ a2 b2^*])`` [B, C, H, W, 2]
    from inverse-FFT outputs read at the fftshifted index and, with ``sens``,
    the coil sum ``acc[..., :2] + scale * sum_c conj(s_c) a_c`` [B, H, W, 2]
    (else None), float32; ``b``, ``b2`` and ``acc`` may be channels of a
    contiguous [B, H, W, 4]."""
    dev = device_of("full_dc.sens_grad", a, b, a2, b2, sens, acc)
    if dev.type == "cpu":
        return sens_grad_plain(a, b, centered, scale, a2, b2, sens, acc)
    bb, c, h, w = a.shape
    check_operand("full_dc.sens_grad.a", a, (bb, c, h, w), _C64)
    bs = _eta_stride(b, bb, h, w, "full_dc.sens_grad.b")
    b2s = 1
    if a2 is not None:
        check_operand("full_dc.sens_grad.a2", a2, (bb, c, h, w), _C64)
        b2s = _eta_stride(b2, bb, h, w, "full_dc.sens_grad.b2")
    if sens is not None:
        check_operand("full_dc.sens_grad.sens", sens, (bb, c, h, w, 2), _F32, align=8)
    accs = 1
    if acc is not None:
        if sens is None:
            raise ValueError("full_dc.sens_grad: acc is added to the coil sum, which needs the maps")
        accs = _eta_stride(acc[..., :2], bb, h, w, "full_dc.sens_grad.acc")
    ds = torch.empty((bb, c, h, w, 2), dtype=torch.float32, device=dev)
    total = None if sens is None else torch.empty((bb, h, w, 2), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch("full_dc", "k2_sens_grad", dev, a.data_ptr(), b.data_ptr(), bs, ptr(a2), ptr(b2), b2s, ptr(sens),
           ptr(acc), accs, ds.data_ptr(), ptr(total), bb, c, h, w, *_shifts(h, w, centered), float(scale))
    return ds, total


# ---- the forward stages as custom ops (taken while a model is exported) ----


@torch.library.custom_op("mridc_tpu_torch::k2_expand", mutates_args=())
def expand_op(eta: torch.Tensor, sens: torch.Tensor, centered: bool) -> torch.Tensor:
    """:func:`expand` as a custom op: the plain version (CPU)."""
    return expand_plain(eta, sens, centered)


@torch.library.custom_op("mridc_tpu_torch::k2_residual", mutates_args=("k",))
def residual_op(k: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, centered: bool) -> None:
    """:func:`residual` as a custom op, in place on ``k``: the plain version (CPU)."""
    k.copy_(residual_plain(k, y, mask, centered))


@torch.library.custom_op("mridc_tpu_torch::k2_mask", mutates_args=("k",))
def apply_mask_op(k: torch.Tensor, mask: torch.Tensor, centered: bool) -> None:
    """:func:`apply_mask` as a custom op, in place on ``k``: the plain version (CPU)."""
    k.copy_(apply_mask_plain(k, mask, centered))


@torch.library.custom_op("mridc_tpu_torch::k2_load", mutates_args=())
def load_op(y: torch.Tensor, mask: Optional[torch.Tensor], centered: bool, fftshift: bool) -> torch.Tensor:
    """:func:`load` as a custom op: the plain version (CPU)."""
    return load_plain(y, mask, centered, fftshift)


@torch.library.custom_op("mridc_tpu_torch::k2_reduce", mutates_args=())
def reduce_op(p: torch.Tensor, sens: torch.Tensor, eta: Optional[torch.Tensor], centered: bool,
              sigma: float) -> torch.Tensor:
    """:func:`reduce` as a custom op: the plain version (CPU)."""
    return reduce_plain(p, sens, eta, centered, sigma)


# on the card each op is its stage's launch
expand_op.register_kernel("cuda")(expand)
load_op.register_kernel("cuda")(load)
reduce_op.register_kernel("cuda")(reduce)


@residual_op.register_kernel("cuda")
def _(k, y, mask, centered):
    residual(k, y, mask, centered)


@apply_mask_op.register_kernel("cuda")
def _(k, mask, centered):
    apply_mask(k, mask, centered)


@expand_op.register_fake
def _(eta, sens, centered):
    return sens.new_empty(sens.shape[:4], dtype=torch.complex64)


@residual_op.register_fake
def _(k, y, mask, centered):
    return None


@apply_mask_op.register_fake
def _(k, mask, centered):
    return None


@load_op.register_fake
def _(y, mask, centered, fftshift):
    return y.new_empty(y.shape[:4], dtype=torch.complex64)


@reduce_op.register_fake
def _(p, sens, eta, centered, sigma):
    return sens.new_empty((sens.shape[0], *sens.shape[2:4], 2 if eta is None else 4), dtype=torch.float32)


def _check_layout(name, spatial_dims, coil_dim):
    if tuple(spatial_dims) not in ((-2, -1), (2, 3)) or coil_dim != 1:
        raise ValueError(f"{name}: the kernels take [B, C, H, W, 2] with coils on axis 1")


def full_dc_bwd(g, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward") -> torch.Tensor:
    """The backward chain: ``g`` [B, H, W, 4] -> d_eta [B, H, W, 2] (plain
    version for CPU tensors, the stages around cuFFT on the card)."""
    dev = device_of("full_dc_bwd", g, sens, mask)
    if dev.type == "cpu":
        return full_dc_bwd_plain(g, sens, mask, sigma, fft_centered, fft_normalization)
    norm = _norm(fft_normalization)
    g = dense("full_dc_bwd", g)
    k = torch.fft.fft2(expand(g[..., 2:], sens, fft_centered), norm=norm)
    p = torch.fft.ifft2(apply_mask(k, mask, fft_centered), norm=norm)
    del k
    return reduce_acc(p, sens, g, fft_centered, sigma)


def full_dc_bwd_sens(g, eta, y, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward"):
    """The backward chain with the maps' gradient: ``g`` [B, H, W, 4] ->
    (d_eta [B, H, W, 2], d_sens [B, C, H, W, 2]); on the card the forward's
    residual image recomputed (expand, FFT, residual, inverse FFT), d_eta's
    chain (expand, FFT, mask, inverse FFT) and one sens_grad stage for both."""
    dev = device_of("full_dc_bwd_sens", g, eta, y, sens, mask)
    if dev.type == "cpu":
        return full_dc_bwd_sens_plain(g, eta, y, sens, mask, sigma, fft_centered, fft_normalization)
    norm = _norm(fft_normalization)
    g = dense("full_dc_bwd", g)
    k = torch.fft.fft2(expand(eta, sens, fft_centered), norm=norm)
    r = torch.fft.ifft2(residual(k, y, mask, fft_centered), norm=norm)
    k = torch.fft.fft2(expand(g[..., 2:], sens, fft_centered), norm=norm)
    q = torch.fft.ifft2(apply_mask(k, mask, fft_centered), norm=norm)
    del k
    d_sens, d_eta = sens_grad(q, eta, fft_centered, 1.0 / sigma**2, a2=r, b2=g[..., 2:], sens=sens, acc=g)
    return d_eta, d_sens


def _full_dc_kernels(eta, y, sens, mask, sigma, fft_centered, fft_normalization) -> torch.Tensor:
    norm = _norm(fft_normalization)
    k = torch.fft.fft2(expand(eta, sens, fft_centered), norm=norm)
    p = torch.fft.ifft2(residual(k, y, mask, fft_centered), norm=norm)
    del k
    return reduce(p, sens, eta, fft_centered, sigma)


class _FullDC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eta, y, sens, mask, sigma, fft_centered, fft_normalization, spatial_dims, coil_dim):
        if ctx.needs_input_grad[2]:  # the maps' gradient recomputes the residual image from eta and y
            ctx.save_for_backward(sens, mask, eta, y)
        else:
            ctx.save_for_backward(sens, mask)
        ctx.args = (sigma, fft_centered, fft_normalization)
        if plain_route(eta):
            return full_dc_plain(eta, y, sens, mask, sigma, fft_centered, fft_normalization, spatial_dims, coil_dim)
        return _full_dc_kernels(eta, y, sens, mask, sigma, fft_centered, fft_normalization)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("full_dc", ctx.needs_input_grad, {1: "y", 3: "mask"})
        if not ctx.needs_input_grad[2]:
            sens, mask = ctx.saved_tensors
            return full_dc_bwd(g, sens, mask, *ctx.args), None, None, None, None, None, None, None, None
        sens, mask, eta, y = ctx.saved_tensors
        d_eta, d_sens = full_dc_bwd_sens(g, eta, y, sens, mask, *ctx.args)
        return (d_eta if ctx.needs_input_grad[0] else None), None, d_sens, None, None, None, None, None, None


def full_dc(eta, y, sens, mask, sigma=1.0, fft_centered=False, fft_normalization="backward",
            spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1) -> torch.Tensor:
    """``eta`` [B, H, W, 2], ``y``/``sens`` [B, C, H, W, 2], ``mask``
    broadcastable to [B, 1, H, W] -> ``[eta, grad]`` [B, H, W, 4], float32;
    differentiable in ``eta`` and the maps."""
    dev = device_of("full_dc", eta, y, sens, mask)
    if dev.type != "cpu":
        _check_layout("full_dc", spatial_dims, coil_dim)
    return _FullDC.apply(eta, y, sens, mask, sigma, fft_centered, fft_normalization, tuple(spatial_dims), coil_dim)


def _kspace_in(name: str, kspace, mask, centered: bool, fft_order: bool) -> torch.Tensor:
    """Real-view k-space in the caller's order -> the complex64 FFT-order
    input of an inverse FFT, masked: the load stage where a shift or the mask
    needs it, the tensor itself (viewed as complex) where nothing does."""
    if fft_order or not (centered or mask is not None):
        return torch.view_as_complex(dense(name, kspace))
    return load(dense(name, kspace), mask, centered)


def _kspace_out(k: torch.Tensor, centered: bool, fft_order: bool) -> torch.Tensor:
    """A forward FFT's complex64 output -> real-view k-space in the caller's
    order (centered: fftshifted by the load stage)."""
    if centered and not fft_order:
        k = load(torch.view_as_real(k), None, True, fftshift=True)
    return torch.view_as_real(k)


def sens_expand_bwd(g, sens, fft_centered=False, fft_normalization="backward", fft_order: bool = False,
                    mask=None) -> torch.Tensor:
    """:func:`sens_expand`'s backward: ``g`` [B, C, H, W, 2] -> d_x [B, H, W, 2]
    (plain version for CPU tensors; load (masked when ``mask`` is given),
    inverse FFT and reduce on the card)."""
    dev = device_of("sens_expand_bwd", g, sens, mask)
    if dev.type == "cpu":
        return sens_expand_bwd_plain(g, sens, fft_centered, fft_normalization, fft_order, mask=mask)
    q = _kspace_in("sens_expand_bwd", g, mask, fft_centered, fft_order)
    return reduce(torch.fft.ifft2(q, norm=_adjoint_norm(fft_normalization)), sens, None, fft_centered)


def sens_reduce_bwd(g, sens, mask=None, fft_centered=False, fft_normalization="backward", fft_order: bool = False
                    ) -> torch.Tensor:
    """:func:`sens_reduce`'s backward: ``g`` [B, H, W, 2] -> d_k [B, C, H, W, 2]
    (plain version for CPU tensors; expand, FFT, mask and the shift back on
    the card)."""
    dev = device_of("sens_reduce_bwd", g, sens, mask)
    if dev.type == "cpu":
        return sens_reduce_bwd_plain(g, sens, mask, fft_centered, fft_normalization, fft_order)
    k = torch.fft.fft2(expand(dense("sens_reduce_bwd", g), sens, fft_centered),
                       norm=_adjoint_norm(fft_normalization))
    if mask is not None:
        k = apply_mask(k, mask, fft_centered)
    return _kspace_out(k, fft_centered, fft_order)


def sens_expand_bwd_sens(g, image, sens, fft_centered=False, fft_normalization="backward", fft_order: bool = False,
                         mask=None):
    """:func:`sens_expand`'s backward with the maps' gradient: ``g``
    [B, C, H, W, 2] -> (d_x [B, H, W, 2], d_sens [B, C, H, W, 2]); on the card
    d_x's chain with one sens_grad stage in place of its reduce."""
    dev = device_of("sens_expand_bwd_sens", g, image, sens, mask)
    if dev.type == "cpu":
        return sens_expand_bwd_sens_plain(g, image, sens, fft_centered, fft_normalization, fft_order, mask=mask)
    q = _kspace_in("sens_expand_bwd", g, mask, fft_centered, fft_order)
    t = torch.fft.ifft2(q, norm=_adjoint_norm(fft_normalization))
    d_sens, d_x = sens_grad(t, image, fft_centered, sens=sens)
    return d_x, d_sens


def sens_reduce_bwd_sens(g, kspace, sens, mask=None, fft_centered=False, fft_normalization="backward",
                         fft_order: bool = False) -> torch.Tensor:
    """:func:`sens_reduce`'s maps gradient: ``g`` [B, H, W, 2] -> d_sens
    [B, C, H, W, 2]; on the card the forward's coil images recomputed (load
    where needed, inverse FFT) and one sens_grad stage."""
    dev = device_of("sens_reduce_bwd_sens", g, kspace, sens, mask)
    if dev.type == "cpu":
        return sens_reduce_bwd_sens_plain(g, kspace, sens, mask, fft_centered, fft_normalization, fft_order)
    p = torch.fft.ifft2(_kspace_in("sens_reduce", kspace, mask, fft_centered, fft_order),
                        norm=_norm(fft_normalization))
    return sens_grad(p, dense("sens_reduce_bwd", g), fft_centered)[0]


class _SensExpand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, sens, mask, fft_centered, fft_normalization, fft_order):
        ctx.save_for_backward(sens, mask, image if ctx.needs_input_grad[1] else None)
        ctx.args = (fft_centered, fft_normalization, fft_order)
        if plain_route(image):
            return sens_expand_plain(image, sens, fft_centered, fft_normalization, fft_order, mask=mask)
        k = torch.fft.fft2(expand(image, sens, fft_centered), norm=_norm(fft_normalization))
        if mask is not None:
            k = apply_mask(k, mask, fft_centered)
        return _kspace_out(k, fft_centered, fft_order)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("sens_expand", ctx.needs_input_grad, {2: "mask"})
        sens, mask, image = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return sens_expand_bwd(g, sens, *ctx.args, mask=mask), None, None, None, None, None
        d_x, d_sens = sens_expand_bwd_sens(g, image, sens, *ctx.args, mask=mask)
        return (d_x if ctx.needs_input_grad[0] else None), d_sens, None, None, None, None


class _SensReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kspace, sens, mask, fft_centered, fft_normalization, fft_order):
        ctx.save_for_backward(sens, mask, kspace if ctx.needs_input_grad[1] else None)
        ctx.args = (fft_centered, fft_normalization, fft_order)
        if plain_route(kspace):
            return sens_reduce_plain(kspace, sens, mask, fft_centered, fft_normalization, fft_order=fft_order)
        p = torch.fft.ifft2(_kspace_in("sens_reduce", kspace, mask, fft_centered, fft_order),
                            norm=_norm(fft_normalization))
        return reduce(p, sens, None, fft_centered)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("sens_reduce", ctx.needs_input_grad, {2: "mask"})
        sens, mask, kspace = ctx.saved_tensors
        d_k = sens_reduce_bwd(g, sens, mask, *ctx.args) if ctx.needs_input_grad[0] else None
        d_sens = sens_reduce_bwd_sens(g, kspace, sens, mask, *ctx.args) if ctx.needs_input_grad[1] else None
        return d_k, d_sens, None, None, None, None


def _check_order(name, mask, fft_order):
    if fft_order and mask is not None:
        raise ValueError(f"{name}: fft_order takes no mask (apply it to the k-space in FFT order first)")


def sens_expand(image, sens, fft_centered=False, fft_normalization="backward", fft_order: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multicoil k-space of a coil-combined image ([B, H, W, 2] -> [B, C, H, W,
    2], in sens' dtype), centered when ``fft_centered`` unless ``fft_order``,
    times ``mask`` (broadcastable to [B, 1, H, W]) when one is given;
    differentiable in the image and the maps."""
    device_of("sens_expand", image, sens, mask)
    _check_order("sens_expand", mask, fft_order)
    return _SensExpand.apply(image.to(sens.dtype).contiguous(), sens, mask, fft_centered, fft_normalization,
                             fft_order)


def sens_reduce(kspace, sens, mask: Optional[torch.Tensor] = None, fft_centered=False,
                fft_normalization="backward", spatial_dims: Sequence[int] = (-2, -1),
                coil_dim: int = 1, fft_order: bool = False) -> torch.Tensor:
    """SENSE-combined image of ``mask * kspace`` ([B, C, H, W, 2] -> [B, H, W, 2]);
    ``fft_order``: kspace in FFT order (and no mask); differentiable in the
    k-space and the maps."""
    dev = device_of("sens_reduce", kspace, sens, mask)
    _check_order("sens_reduce", mask, fft_order)
    if dev.type == "cpu":
        if (tuple(spatial_dims), coil_dim) != ((-2, -1), 1):
            return sens_reduce_plain(kspace, sens, mask, fft_centered, fft_normalization, spatial_dims, coil_dim,
                                     fft_order)
    else:
        _check_layout("sens_reduce", spatial_dims, coil_dim)
    return _SensReduce.apply(kspace, sens, mask, fft_centered, fft_normalization, fft_order)


class _Reorder(torch.autograd.Function):
    """A permutation of centered k-space's [H, W] axes; its backward is the
    inverse permutation."""

    @staticmethod
    def forward(ctx, kspace, fftshift):
        ctx.fftshift = fftshift
        return _reorder(kspace, fftshift)

    @staticmethod
    def backward(ctx, g):
        return _reorder(g, not ctx.fftshift), None


def _reorder(kspace, fftshift: bool) -> torch.Tensor:
    if plain_route(kspace):
        return _reorder_plain(kspace, True, fftshift)
    return torch.view_as_real(load(dense("reorder", kspace), None, True, fftshift))


def to_fft_order(kspace, fft_centered: bool) -> torch.Tensor:
    """Centered real-view k-space [B, C, H, W, 2] -> FFT order (ifftshift; the
    load stage on the card), itself when not centered."""
    device_of("to_fft_order", kspace)
    return _Reorder.apply(kspace, False) if fft_centered else kspace


def from_fft_order(kspace, fft_centered: bool) -> torch.Tensor:
    """The inverse of :func:`to_fft_order` (fftshift)."""
    device_of("from_fft_order", kspace)
    return _Reorder.apply(kspace, True) if fft_centered else kspace


# ---- the normal operator of the conjugate-gradient DC ----


def normal_op_plain(x, sens, mask, mu, fft_centered=False, fft_normalization="backward") -> torch.Tensor:
    """Plain PyTorch version, the JAX package's ``ehe``: ``sum_c conj(s_c)
    F^-1(m F(s_c x)) + mu x`` with ``x`` [B, H, W, 2], ``mask`` broadcastable
    to [B, 1, H, W] and ``mu`` a float or a tensor broadcastable to ``x``."""
    m = mask[..., None]
    k = fft2_rv(cmul(x[:, None], sens), fft_centered, fft_normalization)
    img = ifft2_rv(k * m, fft_centered, fft_normalization)
    return cmul_conj(img, sens).sum(dim=1) + mu * x


def _normal_op_apply(x, sens, mask, mu, fft_centered, fft_normalization) -> torch.Tensor:
    """The operator on ``x``: the plain version for CPU tensors, the stages
    around cuFFT on the card (expand, mask, reduce; mu x added by one
    ``addcmul``)."""
    if plain_route(x):
        return normal_op_plain(x, sens, mask, mu, fft_centered, fft_normalization)
    norm = _norm(fft_normalization)
    k = torch.fft.fft2(expand(dense("normal_op", x), sens, fft_centered), norm=norm)
    p = torch.fft.ifft2(apply_mask(k, mask, fft_centered), norm=norm)
    del k
    return torch.addcmul(reduce(p, sens, None, fft_centered), mu, x)


def normal_op_bwd_sens_plain(g, x, sens, mask, mu, fft_centered=False, fft_normalization="backward"):
    """Plain version of :func:`normal_op`'s backward with the maps' gradient:
    ``g`` [B, H, W, 2] -> (d_x, d_sens = r_c conj(g) + q_c conj(x)) with
    r_c = F^-1 M F(s_c x) and q_c = F^-1 M F(s_c g)."""
    m = mask[..., None]

    def coil_images(v):
        return ifft2_rv(m * fft2_rv(cmul(v[:, None], sens), fft_centered, fft_normalization), fft_centered,
                        fft_normalization)

    r, q = coil_images(x), coil_images(g)
    d_sens = cmul_conj(r, g.unsqueeze(1)) + cmul_conj(q, x.unsqueeze(1))
    return cmul_conj(q, sens).sum(dim=1) + mu * g, d_sens


def normal_op_bwd_sens(g, x, sens, mask, mu, fft_centered=False, fft_normalization="backward"):
    """:func:`normal_op`'s backward with the maps' gradient: (d_x, d_sens); on
    the card the forward's coil images recomputed (expand, FFT, mask,
    inverse FFT), the same for g, one sens_grad stage for both, and mu g
    added by one ``addcmul``."""
    dev = device_of("normal_op_bwd_sens", g, x, sens, mask)
    if dev.type == "cpu":
        return normal_op_bwd_sens_plain(g, x, sens, mask, mu, fft_centered, fft_normalization)
    norm = _norm(fft_normalization)
    g = dense("normal_op", g)

    def coil_images(v):
        k = torch.fft.fft2(expand(v, sens, fft_centered), norm=norm)
        return torch.fft.ifft2(apply_mask(k, mask, fft_centered), norm=norm)

    x = dense("normal_op", x)
    d_sens, total = sens_grad(coil_images(g), x, fft_centered, a2=coil_images(x), b2=g, sens=sens)
    return torch.addcmul(total, mu, g), d_sens


class _NormalOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sens, mask, mu, fft_centered, fft_normalization):
        keep_x = ctx.needs_input_grad[1] or ctx.needs_input_grad[3]
        ctx.save_for_backward(sens, mask, mu, x if keep_x else None)
        ctx.args = (fft_centered, fft_normalization)
        return _normal_op_apply(x, sens, mask, mu, fft_centered, fft_normalization)

    @staticmethod
    def backward(ctx, g):
        refuse_grads("normal_op", ctx.needs_input_grad, {2: "mask"})
        sens, mask, mu, x = ctx.saved_tensors
        d_sens = None
        if ctx.needs_input_grad[1]:
            d_x, d_sens = normal_op_bwd_sens(g, x, sens, mask, mu, *ctx.args)
            d_x = d_x if ctx.needs_input_grad[0] else None
        else:
            d_x = _normal_op_apply(g, sens, mask, mu, *ctx.args) if ctx.needs_input_grad[0] else None
        d_mu = (x * g).sum().reshape(mu.shape) if ctx.needs_input_grad[3] else None
        return d_x, d_sens, None, d_mu, None, None


def normal_op(x, sens, mask, mu, fft_centered=False, fft_normalization="backward") -> torch.Tensor:
    """``A(x) = sum_c conj(s_c) IFFT2(m FFT2(s_c x)) + mu x`` ([B, H, W, 2] ->
    [B, H, W, 2], float32; ``mask`` broadcastable to [B, 1, H, W], ``mu`` a
    float or a float32 tensor broadcastable to x, e.g. a (1,) parameter);
    differentiable in x, mu and the maps."""
    dev = device_of("normal_op", x, sens, mask)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    return _NormalOp.apply(x, sens, mask, mu, fft_centered, fft_normalization)
