"""K1-bf16 and K1-f32 (the psf1d DC of the flagship bf16 and float32 steps)
on the CPU: each kernel's arithmetic, emulated in torch, against its limits.

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

K1's bf16 maps gradient (``csrc/psf1d_sens.cu``, its on-chip route) rounds
x = s_c * eta and y = s_c * g[..., 2:] once each, takes both products the
same way, writes ds_c per coil rounded once and sums d_eta in float32 in coil
order: emulated and held at the same limit against the plain version rounded
once and ``jax.vjp`` of the JAX package.

Each emulation is held against ``rounded_once(psf1d_dc_plain)`` (the plain
version in float32 on the same bf16 operands, rounded once at the end) and
against ``mridc_tpu.nn.dc.log_likelihood_gradient_psf1d`` in float32, at the
limit chip_smoke.py holds the kernel to (K1_BF16: rtol 1e-2, atol 1e-2 x the
largest magnitude). Run with ``-s`` to see the headroom under each limit.

K1-f32 takes the Gauss three-product form on 3xTF32: each operand split into
hi = tf32(x) and lo = tf32(x - hi), where tf32 keeps 10 mantissa bits by
truncation (the kernel clears hi's 13 low bits, and the tensor core reads only
the top 19 bits of lo), each product taken as hi*lo + lo*hi + hi*hi summed in
float32 over 8-deep steps of v; the warps of a row group take the steps in K
phases (step index mod KP), each phase adds conj(s_c) times its coil's
partial products in coil order, and the phases' sums are added in phase
order. Held against the plain version and the JAX package in float32 at
chip_smoke.py's F32 limit (rtol 1e-4, atol 1e-4 x the largest magnitude).

K1's float32 maps gradient (``csrc/psf1d_sens.cu``, its on-chip route) takes
the same Gauss form and 3xTF32 splits for both products, x = s_c * eta and
y = s_c * g[..., 2:] formed in float32, over every 8-deep step of v in order;
its coils are split across 8 warps (warp w takes coils w, w + 8, ...), each
warp sums conj(s_c) v_c for d_eta in its coils' order and the warps' sums
are added in warp order. Emulated and held at F32 against the plain version
and ``jax.vjp`` of the JAX package.
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(b, c, h, w, seed, rounded=True):
    """eta, sens (unit RSS), mats (Gauss form, centered ortho), z0 and an
    upstream g [B, H, W, 4], all rounded to bf16 (float32 tensors holding bf16
    values) unless ``rounded`` is False; a 1D mask of every 4th column plus the
    centre at the flagship width, random columns otherwise."""
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
    return [torch.as_tensor(a).to(BF).float() if rounded else torch.as_tensor(a) for a in (eta, sens, mats, z0, g)]


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


# w640: a width no on-chip tile holds, the wide route's (32 x 64 tiles, the
# operator staged in 32-deep chunks: the same rounding points and 16-deep steps)
SHAPES = {"flagship_b1": (1, 15, 320, 320), "odd": (2, 3, 37, 45), "w640": (1, 4, 24, 640)}


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


def _bf16_on_chip_bytes(tn: int, w: int) -> int:
    """Shared memory of the bf16 on-chip tile of 64 rows by ``tn`` columns at
    width ``w`` (``csrc/psf1d_dc.cu``, ``tc::Layout``)."""
    tk, lx, stages, pairs, tm = 32, 40, 2, 4, 64
    kp = -(-w // tk) * tk
    lk, le = kp + 8, 2 * tn + 16
    per_pair = stages * 16 * tk * 2 + 2 * 2 * 16 * lx + 16 * le
    return 2 * (2 * tn * lk + tm * kp * 2 + pairs * per_pair)


@pytest.mark.parametrize("w", [320, 396, 480, 481, 640, 1024])
def test_k1_bf16_route_by_width(w):
    """Every W has a bf16 route: 64 x 64 tiles up to 320, 64 x 32 up to 480
    (their operator rows in shared memory), the wide route above; the
    wrapper refuses no width."""
    fits = [tn for tn in (64, 32) if _bf16_on_chip_bytes(tn, w) <= 232448]
    want = 64 if w <= 320 else 32 if w <= 480 else None
    assert (fits[0] if fits else None) == want
    assert not hasattr(k1, "_check_width")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [640, 1024])
def test_k1_bf16_wide_route_setup_on_the_card(w):
    """The launcher's setup query reports the wide route and a grid at W =
    640 and 1024, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the setup query runs on the card")
    for bwd in (False, True):
        setup = k1.bf16_setup(2, 48, w, torch.device("cuda"), bwd)
        assert setup["route"] == "wide" and setup["blocks"] == 2 * 2 * -(-w // 64), setup


def test_k1_bf16_check_catches_a_plane_mix_up():
    """The check is not vacuous: the emulation reading the operator's third
    plane (Ci-Cr) where the kernel reads its second (Cr+Ci), an indexing slip
    the kernel could make, lies outside the limit."""
    eta, sens, mats, z0, _ = _operands(*SHAPES["odd"], seed=7)
    swapped = torch.stack([mats[:, 0], mats[:, 2], mats[:, 1]], dim=1)
    want = _bf(k1.psf1d_dc_plain(eta, sens, mats, z0, SIGMA)).double()
    assert _headroom(emulate_forward(eta, sens, mats, z0).double(), want)[0] < 1.0
    assert _headroom(emulate_forward(eta, sens, swapped, z0).double(), want)[0] > 1.0


# ---- K1's bf16 maps gradient (csrc/psf1d_sens.cu, the on-chip route) ----------


def emulate_sens(g, eta, sens, mats, swap_uv=False):
    """(d_eta, d_sens) as the bf16 maps-gradient kernel's on-chip route
    computes them: per coil x = s_c eta and y = s_c g[..., 2:] formed in
    float32 from the bf16 operands and rounded once; Ci = (Cr+Ci) - Cr rebuilt
    and rounded again; four products each for u_c = C x and v_c = C y, of bf16
    values (exact in float32), summed in float32 over 16-deep steps of v;
    ds_c = (u_c conj(G) + v_c conj(eta)) / sigma^2 rounded once; d_eta =
    g[..., :2] + (sum of conj(s_c) v_c in float32 in coil order) / sigma^2
    rounded once. ``swap_uv`` is a mutation the limit must catch: u_c and v_c
    swapped in the epilogue."""
    b, c, h, w, _ = sens.shape
    cr = mats[:, 0]
    ci = _bf(mats[:, 1] - cr)
    er, ei = eta[..., 0], eta[..., 1]
    gr, gi = g[..., 2], g[..., 3]
    inv = 1.0 / SIGMA**2

    def step(x, op, v0):
        return torch.einsum("bhv,buv->bhu", x[..., v0 : v0 + KSTEP], op[..., v0 : v0 + KSTEP])

    def product(xr, xi):
        re = torch.zeros(b, h, w)
        im = torch.zeros(b, h, w)
        for v0 in range(0, w, KSTEP):
            re = re + step(xr, cr, v0)
            re = re + step(xi, -ci, v0)
            im = im + step(xr, ci, v0)
            im = im + step(xi, cr, v0)
        return re, im

    de_r = torch.zeros(b, h, w)
    de_i = torch.zeros(b, h, w)
    ds = []
    for k in range(c):
        sr, si = sens[:, k, ..., 0], sens[:, k, ..., 1]
        ur, ui = product(_bf(er * sr - ei * si), _bf(er * si + ei * sr))
        vr, vi = product(_bf(gr * sr - gi * si), _bf(gr * si + gi * sr))
        if swap_uv:
            ur, ui, vr, vi = vr, vi, ur, ui
        ds.append(torch.stack([(ur * gr + ui * gi + vr * er + vi * ei) * inv,
                               (ui * gr - ur * gi + vi * er - vr * ei) * inv], dim=-1))
        de_r = de_r + (sr * vr + si * vi)
        de_i = de_i + (sr * vi - si * vr)
    d_eta = g[..., :2] + torch.stack([de_r, de_i], dim=-1) * inv
    return _bf(d_eta), _bf(torch.stack(ds, dim=1))


def _jax_sens_vjp(g, eta, sens, mats, z0):
    """jax.vjp of ``mridc_tpu.nn.dc.log_likelihood_gradient_psf1d`` in (eta,
    sens) at the upstream g, in float32."""
    import jax

    fn = lambda e, s: jdc.log_likelihood_gradient_psf1d(e, s, jnp.asarray(mats.numpy()), jnp.asarray(z0.numpy()),
                                                        sigma=SIGMA)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(eta.numpy()), jnp.asarray(sens.numpy()))
    return tuple(torch.from_numpy(np.array(t)) for t in vjp(jnp.asarray(g.numpy())))


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_sens_bf16_arithmetic_meets_its_limits(shape):
    """The emulated maps-gradient kernel (x and y rounded once to bf16, both
    products on bf16 MMAs) against the plain version rounded once and against
    ``jax.vjp`` of the JAX package in float32, d_eta and d_sens each at
    K1_BF16. (At w640 the kernel takes the wide route, whose x and y stay in
    float32; the on-chip rounding is held to the limit at that width too.)"""
    eta, sens, mats, z0, g = _operands(*SHAPES[shape], seed=sum(SHAPES[shape]) + 1)
    got = emulate_sens(g, eta, sens, mats)
    plain = k1.psf1d_dc_sens_bwd_plain(g, eta, sens, mats, SIGMA)
    ref = _jax_sens_vjp(g, eta, sens, mats, z0)
    for i, part in enumerate(("d_eta", "d_sens")):
        _check(f"sens {part} [{shape}] vs rounded_once(plain)", got[i], _bf(plain[i]))
        _check(f"sens {part} [{shape}] vs mridc_tpu float32", got[i], ref[i])


def test_k1_sens_bf16_check_catches_swapped_products():
    """The limit is not vacuous: the emulation with u_c and v_c swapped in
    the epilogue (an indexing slip between the two accumulator sets) lies
    outside it, where the emulation as the kernel computes lies inside."""
    eta, sens, mats, _, g = _operands(*SHAPES["odd"], seed=8)
    want = _bf(k1.psf1d_dc_sens_bwd_plain(g, eta, sens, mats, SIGMA)[1]).double()
    assert _headroom(emulate_sens(g, eta, sens, mats)[1].double(), want)[0] < 1.0
    assert _headroom(emulate_sens(g, eta, sens, mats, swap_uv=True)[1].double(), want)[0] > 1.0


def _sens_bf16_on_chip_bytes(w: int) -> int:
    """Shared memory of the bf16 maps-gradient tile of 32 rows by 64 columns
    at width ``w`` (``csrc/psf1d_sens.cu``, ``tc::Layout``): the operator's
    two planes [2][64][kp + 8], eta's and G's rows [32][2 kp + 16] each, and
    per row group of 16 its s_c ring, its x/y planes and s_c at the tile's
    columns."""
    tk, lx, stages, groups, tm, tn = 32, 40, 3, 2, 32, 64
    kp = -(-w // tk) * tk
    per_group = stages * 16 * tk * 2 + 2 * 4 * 16 * lx + 16 * (2 * tn + 16)
    return 2 * (2 * tn * (kp + 8) + 2 * tm * (2 * kp + 16) + groups * per_group)


@pytest.mark.parametrize("w", [45, 320, 352, 353, 384, 640])
def test_k1_sens_bf16_route_by_width(w):
    """The bf16 maps gradient holds the operator's tile rows on chip up to
    W = 352 and takes the wide route (the first version's kernel, any W)
    above; the wrapper refuses no width."""
    on_chip = _sens_bf16_on_chip_bytes(w) <= 232448
    assert on_chip == (w <= 352)
    assert not hasattr(k1, "_check_width")


# ---- K1-f32 -----------------------------------------------------------------

K1_F32 = (1e-4, 1e-4)  # chip_smoke.py's F32: rtol, atol as a share of the largest magnitude
KW = 8  # the m16n8k8 MMA's depth


def _tf32(x):
    """TF32 by truncation: the 13 low bits of the float32 pattern cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _k_phases(w):
    """The kernel's K phases at width W: 32 x 32 tiles (4 phases of its 8
    warps) up to W = 320, 16 x 32 tiles (8 phases) above."""
    return 4 if (w + 31) // 32 * 32 <= 320 else 8


def emulate_f32(eta, sens, mats, swap_b=False, swap_a=False):
    """A(eta) [B, H, W, 2] as K1-f32 sums it: Gauss planes A (xr + xi, xi, xr)
    and B (Cr, Cr + Ci, Ci - Cr), 3xTF32 products in 8-deep steps, each K
    phase's coil sum in coil order, the phases added in order. Mutations the
    limit must catch, each an indexing slip the kernel could make: ``swap_b``
    reads the B planes as (Cr + Ci, Cr, Ci - Cr), ``swap_a`` the A planes as
    (xr + xi, xr, xi)."""
    b, c, h, w, _ = sens.shape
    nk, kp = -(-w // KW), _k_phases(w)
    pad = nk * KW - w
    sr, si = sens[..., 0], sens[..., 1]
    er, ei = eta[:, None, ..., 0], eta[:, None, ..., 1]
    xr, xi = er * sr - ei * si, er * si + ei * sr  # [B, C, H, W], float32
    a_planes = [torch.nn.functional.pad(x, (0, pad)) for x in ((xr + xi, xr, xi) if swap_a else (xr + xi, xi, xr))]
    b_planes = [torch.nn.functional.pad(mats[:, p], (0, pad)) for p in ((1, 0, 2) if swap_b else (0, 1, 2))]
    a_split = [_split(x) for x in a_planes]
    b_split = [_split(x) for x in b_planes]
    total_r = torch.zeros(b, h, w)
    total_i = torch.zeros(b, h, w)
    for phase in range(kp):
        re, im = _gauss_3xtf32(a_split, b_split, range(phase, nk, kp))
        gr = torch.zeros(b, h, w)
        gi = torch.zeros(b, h, w)
        for k in range(c):  # coil order
            gr = gr + (sr[:, k] * re[:, k] + si[:, k] * im[:, k])
            gi = gi + (sr[:, k] * im[:, k] - si[:, k] * re[:, k])
        total_r, total_i = total_r + gr, total_i + gi
    return torch.stack([total_r, total_i], dim=-1)


def _gauss_3xtf32(a_split, b_split, steps, drop_lo_hi=False):
    """(re, im) [B, C, H, W] of the Gauss form's three products over the
    8-deep steps of v in ``steps``, in order: per plane p and step, hi*lo,
    lo*hi and hi*hi (mma3's order) of A plane p's split (a_split[p], [B, C,
    H, Wp]) and B plane p's (b_split[p], [B, W, Wp]) each added in float32;
    re = k1 - k2, im = k1 + k3. ``drop_lo_hi`` leaves out the lo*hi term (a
    mutation the limit must catch)."""
    acc = [0.0, 0.0, 0.0]
    for j in steps:
        sl = slice(j * KW, (j + 1) * KW)
        for p in range(3):
            (ahi, alo), (bhi, blo) = a_split[p], b_split[p]
            terms = ((ahi, blo), (ahi, bhi)) if drop_lo_hi else ((ahi, blo), (alo, bhi), (ahi, bhi))
            for ta, tb in terms:
                acc[p] = acc[p] + torch.einsum("bchk,buk->bchu", ta[..., sl], tb[..., sl])
    return acc[0] - acc[1], acc[0] + acc[2]


def _inv_sigma2():
    return torch.tensor(1.0 / SIGMA**2, dtype=torch.float32)  # the kernel's float argument


def emulate_f32_forward(eta, sens, mats, z0, **mutation):
    return torch.cat([eta, (emulate_f32(eta, sens, mats, **mutation) - z0) * _inv_sigma2()], dim=-1)


def emulate_f32_backward(g, sens, mats, **mutation):
    return g[..., :2] + emulate_f32(g[..., 2:].contiguous(), sens, mats, **mutation) * _inv_sigma2()


def _f32_headroom(got, want):
    rtol, atol_rel = K1_F32
    atol = atol_rel * float(want.abs().max())
    return float(((got - want).abs() - rtol * want.abs()).max()) / atol, float((got - want).abs().max()), atol


def _f32_check(name, got, want):
    share, err, atol = _f32_headroom(got.double(), want.double())
    print(f"{name}: max abs err {err:.4g}, atol {atol:.4g}; worst excess over rtol uses {share:.3f} of atol")
    assert share < 1.0, name


F32_SHAPES = {**SHAPES, "w368": (1, 2, 8, 368)}  # 368: 16-row tiles, 8 K phases


@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_k1_f32_arithmetic_meets_its_limits(shape, direction):
    """The emulated K1-f32, forward or backward, against the plain version and
    against the JAX package in float32, at K1_F32."""
    eta, sens, mats, z0, g = _operands(*F32_SHAPES[shape], seed=sum(F32_SHAPES[shape]), rounded=False)
    tag = f"f32 {direction} [{shape}]"
    if direction == "forward":
        got = emulate_f32_forward(eta, sens, mats, z0)
        plain = k1.psf1d_dc_plain(eta, sens, mats, z0, SIGMA)
        ref = torch.from_numpy(np.array(jdc.log_likelihood_gradient_psf1d(
            *(jnp.asarray(t.numpy()) for t in (eta, sens, mats, z0)), sigma=SIGMA)))
    else:
        got = emulate_f32_backward(g, sens, mats)
        plain = k1.psf1d_dc_bwd_plain(g, sens, mats, SIGMA)
        v = g[..., 2:].numpy()
        jax_a = jdc.log_likelihood_gradient_psf1d(jnp.asarray(v), *(jnp.asarray(t.numpy()) for t in (sens, mats)),
                                                  jnp.zeros_like(v), sigma=SIGMA)[..., 2:]
        ref = g[..., :2] + torch.from_numpy(np.array(jax_a))
    _f32_check(f"{tag} vs plain", got, plain)
    _f32_check(f"{tag} vs mridc_tpu float32", got, ref)


@pytest.mark.parametrize("mutation", ["swap_b", "swap_a"])
def test_k1_f32_check_catches_a_mutation(mutation):
    """The limit is not vacuous: the emulation with two B planes or two A
    planes swapped lies outside it where the emulation as the kernel computes
    lies inside. (At the "odd" shape's random mask; bench.py's mask is nearly
    symmetric, so Ci ~ 0 there and Cr + Ci ~ Cr.)"""
    eta, sens, mats, z0, _ = _operands(*SHAPES["odd"], seed=7, rounded=False)
    want = k1.psf1d_dc_plain(eta, sens, mats, z0, SIGMA).double()
    assert _f32_headroom(emulate_f32_forward(eta, sens, mats, z0).double(), want)[0] < 1.0
    assert _f32_headroom(emulate_f32_forward(eta, sens, mats, z0, **{mutation: True}).double(), want)[0] > 1.0


# ---- K1's float32 maps gradient (csrc/psf1d_sens.cu, the on-chip route) -------

WARPS = 8  # the kernel's warps: warp w takes coils w, w + 8, ...


def emulate_sens_f32(g, eta, sens, mats, swap_uv=False, drop_lo_hi=False):
    """(d_eta, d_sens) as the float32 maps-gradient kernel's on-chip route
    computes them: x = s_c eta and y = s_c g[..., 2:] in float32, their Gauss
    planes (re + im, im, re) and the operator's (Cr, Cr + Ci, Ci - Cr) split
    into truncated TF32 hi and lo, u_c = C x and v_c = C y each as 3xTF32 over
    every 8-deep step of v in order; ds_c = (u_c conj(G) + v_c conj(eta)) /
    sigma^2; d_eta = g[..., :2] + (the warps' sums of conj(s_c) v_c, each over
    its coils w, w + 8, ... in order, added in warp order) / sigma^2.
    Mutations the limit must catch: ``swap_uv`` (u_c and v_c swapped in the
    epilogue) and ``drop_lo_hi`` (the lo*hi term of every product left out)."""
    b, c, h, w, _ = sens.shape
    nk = -(-w // KW)
    pad = nk * KW - w
    sr, si = sens[..., 0], sens[..., 1]  # [B, C, H, W]
    b_split = [_split(torch.nn.functional.pad(mats[:, p], (0, pad))) for p in range(3)]

    def product(z):  # C (s_c z) for z [B, H, W, 2]: (re, im) [B, C, H, W]
        zr, zi = z[:, None, ..., 0], z[:, None, ..., 1]
        xr, xi = zr * sr - zi * si, zr * si + zi * sr
        a_split = [_split(torch.nn.functional.pad(x, (0, pad))) for x in (xr + xi, xi, xr)]
        return _gauss_3xtf32(a_split, b_split, range(nk), drop_lo_hi)

    g2 = g[..., 2:].contiguous()
    (ur, ui), (vr, vi) = product(eta), product(g2)
    if swap_uv:
        ur, ui, vr, vi = vr, vi, ur, ui
    inv = _inv_sigma2()
    er, ei = eta[:, None, ..., 0], eta[:, None, ..., 1]
    gr, gi = g2[:, None, ..., 0], g2[:, None, ..., 1]
    d_sens = torch.stack([(ur * gr + ui * gi + vr * er + vi * ei) * inv,
                          (ui * gr - ur * gi + vi * er - vr * ei) * inv], dim=-1)
    term_r, term_i = sr * vr + si * vi, sr * vi - si * vr
    total_r = torch.zeros(b, h, w)
    total_i = torch.zeros(b, h, w)
    for warp in range(WARPS):
        part_r = torch.zeros(b, h, w)
        part_i = torch.zeros(b, h, w)
        for k in range(warp, c, WARPS):
            part_r, part_i = part_r + term_r[:, k], part_i + term_i[:, k]
        total_r, total_i = total_r + part_r, total_i + part_i
    return g[..., :2] + torch.stack([total_r, total_i], dim=-1) * inv, d_sens


# SHAPES, then one width on each side of the on-chip route's end (W = 320:
# 9 coils so that warp 0 takes two; 321: the wide route)
F32_SENS_SHAPES = {**SHAPES, "w320": (1, 9, 8, 320), "w321": (1, 2, 8, 321)}


@pytest.mark.parametrize("shape", F32_SENS_SHAPES)
def test_k1_sens_f32_arithmetic_meets_its_limits(shape):
    """The emulated float32 maps-gradient kernel against the plain version
    and against ``jax.vjp`` of the JAX package in float32, d_eta and d_sens
    each at K1_F32. (At w640 and w321 the kernel takes the wide route, which
    sums in float32 on the CUDA cores; the on-chip arithmetic is held to the
    limit at those widths too.)"""
    eta, sens, mats, z0, g = _operands(*F32_SENS_SHAPES[shape], seed=sum(F32_SENS_SHAPES[shape]) + 2, rounded=False)
    got = emulate_sens_f32(g, eta, sens, mats)
    plain = k1.psf1d_dc_sens_bwd_plain(g, eta, sens, mats, SIGMA)
    ref = _jax_sens_vjp(g, eta, sens, mats, z0)
    for i, part in enumerate(("d_eta", "d_sens")):
        _f32_check(f"sens f32 {part} [{shape}] vs plain", got[i], plain[i])
        _f32_check(f"sens f32 {part} [{shape}] vs mridc_tpu float32", got[i], ref[i])


@pytest.mark.parametrize("mutation", ["swap_uv", "drop_lo_hi"])
def test_k1_sens_f32_check_catches_a_mutation(mutation):
    """The limit is not vacuous: the emulation with u_c and v_c swapped in
    the epilogue, or with the lo*hi term of the 3xTF32 products left out,
    lies outside it (d_sens against the plain version), where the emulation
    as the kernel computes lies inside."""
    eta, sens, mats, _, g = _operands(*SHAPES["odd"], seed=9, rounded=False)
    want = k1.psf1d_dc_sens_bwd_plain(g, eta, sens, mats, SIGMA)[1].double()
    assert _f32_headroom(emulate_sens_f32(g, eta, sens, mats)[1].double(), want)[0] < 1.0
    assert _f32_headroom(emulate_sens_f32(g, eta, sens, mats, **{mutation: True})[1].double(), want)[0] > 1.0


def _sens_f32_on_chip_bytes(w: int) -> int:
    """Shared memory of the float32 maps-gradient tile of 16 rows by 32
    columns at width ``w`` (``csrc/psf1d_sens.cu``, ``tf32::Layout``): eta's
    and G's rows [16][2 kp] each, the operator's three planes [3][32][kp] and
    each of 8 warps' ring of 3 raw s_c chunks [16][2 x 8], in floats, kp = W
    rounded up to 32; at least the warps' d_eta sums [8][32][32]."""
    tm, tn, stages = 16, 32, 3
    kp = -(-w // 32) * 32
    floats = 2 * tm * 2 * kp + 3 * tn * kp + WARPS * stages * 16 * 2 * KW
    return 4 * max(floats, WARPS * tn * 32)


@pytest.mark.parametrize("w", [45, 320, 321, 352, 448, 449, 640])
def test_k1_sens_f32_route_by_width(w):
    """The float32 maps gradient holds the operator's tile rows on chip in
    16 x 32 tiles up to W = 320 and takes the wide route (the first
    version's kernel, any W) above; the wrapper refuses no width."""
    on_chip = _sens_f32_on_chip_bytes(w) <= 232448
    assert on_chip == (w <= 320)
    assert _sens_f32_on_chip_bytes(320) == 229376  # the on-chip setup's smem_bytes at J1 (8x15x320x320)
    assert not hasattr(k1, "_check_width")
