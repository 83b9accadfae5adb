"""K1-bf16 (the psf1d DC of the flagship bf16 step) on the CPU: the kernel's
arithmetic, emulated in torch, against its limits.

The kernel runs only on the card (``chip_smoke.py`` holds it against its plain
version there, forward and backward). What can be checked here is where it
rounds and how it sums:
- x = s_c * eta formed in float32 from the bf16 operands and rounded once to
  bf16 (planes xr, xi); Ci = (Cr+Ci) - Cr rebuilt from the delivered planes
  and rounded to bf16 again;
- four products of bf16 values (exact in float32), re += xr Cr - xi Ci and
  im += xr Ci + xi Cr, summed in float32 over 16-deep steps of v, then
  conj(s_c) times each coil's sum added in float32 in coil order, and the
  output rounded once to bf16.

Each emulation is held against ``rounded_once(psf1d_dc_plain)`` (the plain
version in float32 on the same bf16 operands, rounded once at the end) and
against ``mridc_tpu.nn.dc.log_likelihood_gradient_psf1d`` in float32, at the
limit chip_smoke.py holds the kernel to (K1_BF16: rtol 1e-2, atol 1e-2 x the
largest magnitude). Run with ``-s`` to see the headroom under each limit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
from mridc_tpu_torch.nn.dc import psf1d_gauss_mats

jdc = importlib.import_module("mridc_tpu.nn.dc")

K1_BF16 = (1e-2, 1e-2)  # chip_smoke.py: rtol, atol as a share of the largest magnitude
SIGMA = 0.7
KSTEP = 16  # the MMA's depth
BF = torch.bfloat16


def _operands(b, c, h, w, seed):
    """eta, sens (unit RSS), mats (Gauss form, centered ortho), z0 and an
    upstream g [B, H, W, 4], all rounded to bf16 (float32 tensors holding bf16
    values); a 1D mask of every 4th column plus the centre at the flagship
    width, random columns otherwise."""
    rng = np.random.default_rng(seed)
    sens = rng.standard_normal((b, c, h, w, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    eta, z0 = (rng.standard_normal((b, h, w, 2)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    if w == 320:
        mask = np.zeros((b, w), np.float32)
        mask[:, ::4] = 1.0
        mask[:, w // 2 - 16 : w // 2 + 16] = 1.0
    else:
        mask = (rng.random((b, w)) < 0.4).astype(np.float32)
    mats = psf1d_gauss_mats(torch.from_numpy(mask), True, "ortho")
    return [torch.as_tensor(a).to(BF).float() for a in (eta, sens, mats, z0, g)]


def _bf(x):
    return x.to(BF).float()


def emulate(eta, sens, mats):
    """A(eta) [B, H, W, 2] as the kernel sums it, before the epilogue: per coil
    the x planes rounded once, 16-deep steps of exact products summed in
    float32 into the re and im accumulators, then conj(s_c) times the coil's
    sum added in coil order."""
    b, c, h, w, _ = sens.shape
    cr = mats[:, 0]
    ci = _bf(mats[:, 1] - cr)  # rebuilt from the delivered Cr and Cr+Ci
    er, ei = eta[..., 0], eta[..., 1]
    gr = torch.zeros(b, h, w)
    gi = torch.zeros(b, h, w)

    def step(x, op, v0):
        return torch.einsum("bhv,buv->bhu", x[..., v0 : v0 + KSTEP], op[..., v0 : v0 + KSTEP])

    for k in range(c):
        sr, si = sens[:, k, ..., 0], sens[:, k, ..., 1]
        xr, xi = _bf(er * sr - ei * si), _bf(er * si + ei * sr)
        re = torch.zeros(b, h, w)
        im = torch.zeros(b, h, w)
        for v0 in range(0, w, KSTEP):
            re = re + step(xr, cr, v0)
            re = re + step(xi, -ci, v0)
            im = im + step(xr, ci, v0)
            im = im + step(xi, cr, v0)
        gr = gr + (sr * re + si * im)
        gi = gi + (sr * im - si * re)
    return torch.stack([gr, gi], dim=-1)


def emulate_forward(eta, sens, mats, z0):
    a = emulate(eta, sens, mats)
    return _bf(torch.cat([eta, (a - z0) / SIGMA**2], dim=-1))


def emulate_backward(g, sens, mats):
    a = emulate(g[..., 2:], sens, mats)
    return _bf(g[..., :2] + a / SIGMA**2)


def _headroom(got, want):
    """(max |got - want| - rtol |want|) over atol: below 1 passes the limit."""
    rtol, atol_rel = K1_BF16
    atol = atol_rel * float(want.abs().max())
    excess = float(((got - want).abs() - rtol * want.abs()).max())
    return excess / atol, float((got - want).abs().max()), atol


def _check(name, got, want):
    share, err, atol = _headroom(got.double(), want.double())
    print(f"{name}: max abs err {err:.4g}, atol {atol:.4g}; worst excess over rtol uses {share:.3f} of atol")
    assert share < 1.0, name


SHAPES = {"flagship_b1": (1, 15, 320, 320), "odd": (2, 3, 37, 45)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_k1_bf16_arithmetic_meets_its_limits(shape, direction):
    """The emulated kernel, forward or backward, against the plain version
    rounded once and against the JAX package in float32, at K1_BF16."""
    eta, sens, mats, z0, g = _operands(*SHAPES[shape], seed=sum(SHAPES[shape]))
    tag = f"{direction} [{shape}]"
    if direction == "forward":
        got = emulate_forward(eta, sens, mats, z0)
        plain = k1.psf1d_dc_plain(eta, sens, mats, z0, SIGMA)
        jax_out = jdc.log_likelihood_gradient_psf1d(*(jnp.asarray(t.numpy()) for t in (eta, sens, mats, z0)),
                                                    sigma=SIGMA)
        ref = torch.from_numpy(np.array(jax_out))
    else:
        got = emulate_backward(g, sens, mats)
        plain = k1.psf1d_dc_bwd_plain(g, sens, mats, SIGMA)
        v = g[..., 2:].numpy()
        jax_a = jdc.log_likelihood_gradient_psf1d(jnp.asarray(v), *(jnp.asarray(t.numpy()) for t in (sens, mats)),
                                                  jnp.zeros_like(v), sigma=SIGMA)[..., 2:]
        ref = g[..., :2] + torch.from_numpy(np.array(jax_a))
    _check(f"{tag} vs rounded_once(plain)", got, _bf(plain))
    _check(f"{tag} vs mridc_tpu float32", got, ref)


def test_k1_bf16_check_catches_a_plane_mix_up():
    """The check is not vacuous: the emulation reading the operator's third
    plane (Ci-Cr) where the kernel reads its second (Cr+Ci), an indexing slip
    the kernel could make, lies outside the limit."""
    eta, sens, mats, z0, _ = _operands(*SHAPES["odd"], seed=7)
    swapped = torch.stack([mats[:, 0], mats[:, 2], mats[:, 1]], dim=1)
    want = _bf(k1.psf1d_dc_plain(eta, sens, mats, z0, SIGMA)).double()
    assert _headroom(emulate_forward(eta, sens, mats, z0).double(), want)[0] < 1.0
    assert _headroom(emulate_forward(eta, sens, swapped, z0).double(), want)[0] > 1.0
