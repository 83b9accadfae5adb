"""K3 (the IndRNN cell) on the CPU: the port's cell against flax at the widths
``projects/`` uses, and the accuracy arguments of two kernels, emulated in
torch.

The kernels run only on the card (``chip_smoke.py`` holds them against their
plain versions there). What can be checked here is their arithmetic:
- the float32 forward keeps float32 accuracy: each operand split into a TF32
  hi part (float32 rounded to 10 mantissa bits, to nearest with ties away from
  zero, as ``cvt.rna.tf32.f32`` does) and a TF32 lo part (the remainder,
  rounded the same way), and each product taken as hi*hi + hi*lo + lo*hi;
- the bf16 backward's sums over pixels meet its limits: products of bf16
  values (exact in float32) summed in float32, 16 pixels per MMA step, into a
  partial per block that keeps every tile it walks, then the partials in block
  order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu_torch.kernels import k3_indrnn as k3
from mridc_tpu_torch.nn import rnn_cells as tcells
from mridc_tpu_torch.utils.params import hwio_to_oihw

jcells = importlib.import_module("mridc_tpu.nn.rnn_cells")

# the kernel's limit against its plain version (chip_smoke.py)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4


def _nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cin,f", [(64, 64), (64, 128), (128, 128)])
def test_indrnn_cell_matches_flax_at_project_widths(cin, f):
    """The IndRNN cell at the recurrent widths of projects/ (64 and 128
    filters), over 2 x 7 x 9 pixels, a count that no kernel tile divides.
    Tolerance as in test_torch_port_cells.py: rtol 1e-5 / atol 1e-6 of the
    output's largest magnitude (float32 sums in different orders)."""
    b, h, w = 2, 7, 9
    x, hid = _nhwc((b, h, w, cin), 2), np.abs(_nhwc((b, h, w, f), 3))
    jmod = jcells.make_cell("IndRNN", f, 1, 1, True)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(hid))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 10.0, params)  # well away from relu's kink
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(hid)))

    tmod = tcells.make_cell("IndRNN", cin, f, 1, 1, True)
    with torch.no_grad():
        tmod.ih.weight.copy_(torch.from_numpy(hwio_to_oihw(np.array(params["Conv_0"]["kernel"]))))
        tmod.ih.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
        tmod.hh.copy_(torch.from_numpy(np.transpose(np.array(params["hh"]), (0, 3, 1, 2))))
    to_port = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731  (channels_last NCHW view)
    got = tmod(to_port(x), to_port(hid)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (b, h, w, f)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())))


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``): add half of the 13 dropped bits' range to
    the magnitude and drop them."""
    bits = a.contiguous().view(torch.int32)
    sign = bits & -(2**31)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(a: torch.Tensor):
    hi = to_tf32(a)
    return hi, to_tf32(a - hi)


def test_tf32_rounding_is_rna():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = to_tf32(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())  # 13 low mantissa bits dropped
    assert bool(((x - hi).abs() <= x.abs() * 2.0**-11).all())  # within half a TF32 ulp
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 1 + 2.0**-12])
    want = torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2 * 2.0**-10, 1.0])
    assert torch.equal(to_tf32(tie), want)  # halfway cases go away from zero
    hi, lo = split(x)
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0**-21).all())  # hi + lo keeps ~21 bits


@pytest.mark.parametrize("ci", [64, 128])
def test_3xtf32_product_keeps_float32_accuracy(ci):
    """hi*hi + hi*lo + lo*hi, each product of TF32 operands summed in float32,
    matches the float64 product within the kernel's tolerance; one TF32 product
    (hi*hi alone) does not, so the test can tell the two apart."""
    gen = torch.Generator().manual_seed(ci)
    x = torch.randn(4096, ci, generator=gen)
    w = torch.randn(64, ci, generator=gen) / ci**0.5
    want = x.double() @ w.double().T
    (xh, xl), (wh, wl) = split(x), split(w)
    got = xh @ wl.T + xl @ wh.T + xh @ wh.T
    atol = KERNEL_ATOL * float(want.abs().max())
    assert torch.allclose(got.double(), want, rtol=KERNEL_RTOL, atol=atol)
    assert not torch.allclose((xh @ wh.T).double(), want, rtol=KERNEL_RTOL, atol=atol)


# the bf16 backward kernel's limits against its plain version (chip_smoke.py
# phase 9): dx and dh against float32 rounded once, the sums against float64
BWD_BF16_LIMITS = {"dx": (1e-2, 1e-3), "dh": (1e-2, 1e-3), "dW": (1e-3, 1e-4), "db": (1e-3, 1e-4),
                   "du": (1e-3, 1e-4)}


def _bf16_bwd_operands(ci, f, seed):
    """(g, x, h, h', W, u) as bf16 NCHW tensors over 2 x 64 x 64 pixels (128
    tiles of 64), h' = relu of a normal draw: about half its entries 0."""
    rng = np.random.default_rng(seed)
    px = (2, 64, 64)
    draws = (rng.standard_normal((*px, f)), rng.standard_normal((*px, ci)), np.abs(rng.standard_normal((*px, f))),
             np.maximum(rng.standard_normal((*px, f)), 0.0))
    g, x, h, hn = (torch.from_numpy(a.astype(np.float32)).permute(0, 3, 1, 2).to(torch.bfloat16) for a in draws)
    w = torch.from_numpy((rng.standard_normal((f, ci, 1, 1)) / np.sqrt(ci)).astype(np.float32)).to(torch.bfloat16)
    u = torch.from_numpy(rng.uniform(0.0, 1.0, (1, f, 1, 1)).astype(np.float32)).to(torch.bfloat16)
    return g, x, h, hn, w, u


def emulate_bwd_bf16(g, x, h, hn, w, u, blocks=8, tp=64, kstep=16, acc_dtype=torch.float32):
    """The bf16 kernel's arithmetic: g' = g [h' > 0], dx = g' W and dh = u g'
    summed in float32 and rounded once; block k walks the tiles k, k + blocks,
    ... and adds each 16-pixel step's products (exact, summed in float32) to
    its partial of dW, db and du; the partials are summed in block order.
    ``acc_dtype`` rounds each partial after every step (bf16: a kernel that
    accumulated in its storage type)."""
    f, ci = w.shape[0], w.shape[1]
    flat = lambda t: t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).float()  # noqa: E731
    g, x, h, hn = flat(g), flat(x), flat(h), flat(hn)
    wf, uf = w.reshape(f, ci).float(), u.reshape(f).float()
    gp = torch.where(hn > 0, g, torch.zeros(()))
    dx, dh = (gp @ wf).to(torch.bfloat16), (uf * gp).to(torch.bfloat16)
    p = gp.shape[0]
    tiles = -(-p // tp)
    total = [torch.zeros(f, ci), torch.zeros(f), torch.zeros(f)]
    for blk in range(blocks):
        part = [torch.zeros(f, ci, dtype=acc_dtype), torch.zeros(f, dtype=acc_dtype), torch.zeros(f, dtype=acc_dtype)]
        for t in range(blk, tiles, blocks):
            for k0 in range(t * tp, min((t + 1) * tp, p), kstep):
                gk, xk, hk = gp[k0 : k0 + kstep], x[k0 : k0 + kstep], h[k0 : k0 + kstep]
                for i, step in enumerate((gk.T @ xk, gk.sum(0), (hk * gk).sum(0))):
                    part[i] = (part[i].float() + step).to(acc_dtype)
        total = [a + b.float() for a, b in zip(total, part)]
    return dx, dh, *total


def _close_at(name, got, want):
    rtol, atol = BWD_BF16_LIMITS[name]
    got, want = got.double(), want.double()
    return bool(torch.allclose(got, want, rtol=rtol, atol=atol * float(want.abs().max())))


@pytest.mark.parametrize("cin,f", [(64, 64), (64, 128)])
def test_bf16_backward_arithmetic_meets_its_limits(cin, f):
    """The emulated kernel against the plain version (dx, dh: float32 on the
    bf16 operands, rounded once; dW, db, du: float64) within phase 9's limits;
    the same sums accumulated in bf16 miss the dW limit, so the test can tell
    the two apart."""
    ops = _bf16_bwd_operands(cin, f, seed=cin + f)
    plain32 = k3.indrnn_bwd_plain(*(a.float() for a in ops))
    plain64 = k3.indrnn_bwd_plain(*(a.double() for a in ops))
    want = [plain32[0].permute(0, 2, 3, 1).reshape(-1, cin).to(torch.bfloat16),
            plain32[1].permute(0, 2, 3, 1).reshape(-1, f).to(torch.bfloat16), *plain64[2:]]
    got = emulate_bwd_bf16(*ops)
    for name, a, b in zip(BWD_BF16_LIMITS, got, want):
        assert _close_at(name, a, b), name
    assert float((ops[3] == 0).float().mean()) > 0.3, "the relu mask must cut some pixels"
    assert not _close_at("dW", emulate_bwd_bf16(*ops, acc_dtype=torch.bfloat16)[2], want[2])
