"""Port parity: K4, the edge pad and the bias-and-activation epilogue around
every ``ConvNonlinear`` conv (``mridc_tpu_torch/kernels/k4_conv_epilogue.py``),
on the CPU, where each Function runs its plain versions.

- ``edge_pad`` against ``jnp.pad(mode="edge")`` and its ``jax.vjp``: the
  forward bit for bit in float32 and bfloat16, the gradient at rtol 1e-6 /
  atol 1e-6 x max in float32 (the halo's sums in another order) and within
  1e-2 x max in bfloat16 (JAX's bf16 transpose may round
  its sums at other places); pads 1 and 2, odd sizes, both layouts the kernel
  takes;
- ``bias_act`` inside ``ConvNonlinear`` against flax's
  (``mridc_tpu/nn/layers.py:261``) forward and ``jax.vjp`` for relu, leaky
  relu and none, on inputs whose pre-activation is exactly zero at some
  pixels, which pins the gradient at a tie (rtol 2e-3 / atol 2e-4 x max);
- float64 ``gradcheck`` of both Functions;
- the plain fold of the pad's gradient against an emulation of the kernel's
  order, bit for bit, and the epilogue's bf16 rounding points;
- the layouts the kernels take, the codes of the activations and the blocks
  of the epilogue's backward.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mridc_tpu_torch.kernels import k4_conv_epilogue as k4
from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.utils.params import hwio_to_oihw

jlayers = importlib.import_module("mridc_tpu.nn.layers")

RTOL, ATOL = 2e-3, 2e-4
SHAPES = [(2, 3, 7, 5), (1, 4, 1, 6), (2, 2, 2, 3)]  # odd sizes, one row, two rows
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops (gradcheck perturbs one element at a time); one intra-op
    thread keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x_nhwc: np.ndarray, dtype: torch.dtype, channels_last: bool) -> torch.Tensor:
    t = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    return t if channels_last else t.contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ---- edge_pad against jnp.pad(mode="edge") ----


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "contiguous"])
def test_edge_pad_and_its_vjp_match_jnp_pad(shape, pad, dtype, channels_last):
    tdt, jdt = DTYPES[dtype]
    b, c, h, w = shape
    rng = np.random.default_rng(pad * 10 + h)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h + 2 * pad, w + 2 * pad, c)).astype(np.float32)
    widths = ((0, 0), (pad, pad), (pad, pad), (0, 0))
    want, vjp = jax.vjp(lambda a: jnp.pad(a, widths, mode="edge"), jnp.asarray(x).astype(jdt))
    (want_dx,) = vjp(jnp.asarray(g).astype(jdt))

    xt = _nchw(x, tdt, channels_last).requires_grad_(True)
    got = k4.edge_pad(xt, pad)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.dtype == tdt and got.is_contiguous(memory_format=fmt)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))
    got.backward(_nchw(g, tdt, channels_last))
    want_dx = np.asarray(want_dx, np.float32)
    if dtype == "float32":  # up to 25 terms summed in another order: a few ulps of the largest sum
        np.testing.assert_allclose(_nhwc(xt.grad), want_dx, rtol=1e-6, atol=1e-6 * float(np.abs(want_dx).max()))
    else:
        np.testing.assert_allclose(_nhwc(xt.grad), want_dx, rtol=0, atol=1e-2 * float(np.abs(want_dx).max()))


@pytest.mark.parametrize("pad", [1, 2])
def test_replicate_pad_is_k4s_pad(pad, monkeypatch):
    """``nn/layers.py:replicate_pad`` runs K4's pad (on the CPU its plain
    version) and equals ``F.pad``'s replicate mode."""
    calls = []
    orig = k4.edge_pad_plain
    monkeypatch.setattr(k4, "edge_pad_plain", lambda x, p: calls.append(p) or orig(x, p))
    x = torch.randn(2, 3, 6, 5, generator=torch.Generator().manual_seed(pad))
    assert torch.equal(tlayers.replicate_pad(x, pad), F.pad(x, (pad,) * 4, mode="replicate"))
    assert calls == [pad]


# ---- bias_act inside ConvNonlinear against flax's ----


def _tied_input(seed, c):
    """[1, 9, 11, c] with a zero 5 x 5 block: a 3 x 3 conv gives exact zeros
    inside it, and channels with a zero bias keep them as pre-activations."""
    x = np.random.default_rng(seed).standard_normal((1, 9, 11, c)).astype(np.float32)
    x[:, 2:7, 3:8] = 0.0
    return x


@pytest.mark.parametrize("nonlinear", ["relu", "leakyrelu", None])
@pytest.mark.parametrize("use_bias", [True, False])
def test_conv_nonlinear_forward_and_vjp_match_flax_at_ties(nonlinear, use_bias):
    cin, cout = 3, 5
    x = _tied_input(1, cin)
    jmod = jlayers.ConvNonlinear(cout, 3, 1, use_bias, nonlinear)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if use_bias:  # channels 0 and 1 without bias: exact zeros stay exact
        bias = np.random.default_rng(2).standard_normal(cout).astype(np.float32)
        bias[:2] = 0.0
        params = {"Conv_0": {**params["Conv_0"], "bias": jnp.asarray(bias)}}
    g = np.random.default_rng(3).standard_normal((1, 9, 11, cout)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a), params, jnp.asarray(x))
    want_p, want_dx = vjp(jnp.asarray(g))
    want = np.asarray(want)
    assert (want[:, 3:6, 4:7, :2] == 0).all()  # the ties

    tmod = tlayers.ConvNonlinear(cin, cout, 3, 1, use_bias, nonlinear)
    with torch.no_grad():
        tmod.conv_layer.weight.copy_(torch.from_numpy(hwio_to_oihw(np.array(params["Conv_0"]["kernel"]))))
        if use_bias:
            tmod.conv_layer.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
    xt = _nchw(x, torch.float32, True).requires_grad_(True)
    out = tmod(xt)
    out.backward(_nchw(g, torch.float32, True))

    def close(got, ref):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(ref).max())))

    close(_nhwc(out), want)
    close(_nhwc(xt.grad), want_dx)
    close(tmod.conv_layer.weight.grad.numpy(), hwio_to_oihw(np.asarray(want_p["Conv_0"]["kernel"])))
    if use_bias:
        close(tmod.conv_layer.bias.grad.numpy(), want_p["Conv_0"]["bias"])


@pytest.mark.parametrize("nonlinear,mask_at_zero", [("relu", 0.0), ("leakyrelu", 1.0)])
def test_bias_act_gradient_at_a_tie_is_jaxs(nonlinear, mask_at_zero):
    """relu passes no gradient at an exact zero (``jax.nn.relu``), leaky relu
    passes all of it (``jax.nn.leaky_relu``: ``where(x >= 0, ...)``)."""
    y = torch.tensor([-1.0, 0.0, 2.0]).reshape(1, 3, 1, 1).requires_grad_(True)
    b = torch.zeros(3, requires_grad=True)
    k4.bias_act(y, b, nonlinear).backward(torch.ones(1, 3, 1, 1))
    want_neg = 0.0 if nonlinear == "relu" else k4.LEAKY_SLOPE
    assert y.grad.flatten().tolist() == pytest.approx([want_neg, mask_at_zero, 1.0])
    jfn = {"relu": jax.nn.relu, "leakyrelu": jax.nn.leaky_relu}[nonlinear]
    assert float(jax.grad(jfn)(0.0)) == mask_at_zero
    assert torch.equal(b.grad, y.grad.flatten())


def test_conv_nonlinear_without_bias_or_activation_runs_no_epilogue(monkeypatch):
    calls = []
    monkeypatch.setattr(k4, "bias_act_plain", lambda *a: calls.append(a))
    layer = tlayers.ConvNonlinear(4, 2, 3, 1, False, None)
    out = layer(torch.randn(1, 4, 6, 6).contiguous(memory_format=torch.channels_last))
    assert calls == [] and out.shape == (1, 2, 6, 6)


@pytest.mark.parametrize("nonlinear", ["relu", "leakyrelu", None])
def test_conv_nonlinear_float32_forward_is_bit_for_bit_the_conv_with_its_bias(nonlinear):
    """On a channels_last float32 input (the RIM's), the conv without its bias
    plus K4's epilogue equals the conv with its bias and the activation."""
    layer = tlayers.ConvNonlinear(4, 6, 5, 1, True, nonlinear)
    with torch.no_grad():
        layer.conv_layer.bias.normal_(generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 11, 9, generator=torch.Generator().manual_seed(1))
    x = x.contiguous(memory_format=torch.channels_last)
    want = tlayers.activation(layer.conv_layer(tlayers.replicate_pad(x, 2)), nonlinear)
    assert torch.equal(layer(x), want)


def test_bias_act_bf16_rounds_the_sum_once_then_applies_the_activation():
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(2, 8, 5, 7, generator=gen).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(8, generator=gen).to(torch.bfloat16)
    s = (y.float() + b.float().reshape(1, -1, 1, 1)).to(torch.bfloat16)
    assert torch.equal(k4.bias_act_plain(y, b, 0), s)
    assert torch.equal(k4.bias_act_plain(y, b, 1), torch.clamp(s.float(), min=0).to(torch.bfloat16))
    leaky = torch.where(s.float() > 0, s.float(), s.float() * 0.01).to(torch.bfloat16)
    assert torch.equal(k4.bias_act_plain(y, b, 2), leaky)
    # the backward's leaky product is rounded once, in float32
    g = torch.randn(2, 8, 5, 7, generator=gen).to(torch.bfloat16)
    out = k4.bias_act_plain(y, b, 2)
    gy, db = k4.bias_act_bwd_plain(g, out, 2, True)
    assert torch.equal(gy, torch.where(out.float() >= 0, g.float(), g.float() * 0.01).to(torch.bfloat16))
    assert db.dtype == torch.float32 and torch.equal(db, gy.float().sum((0, 2, 3)))


# ---- gradcheck ----


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("pad", [0, 1, 2])
@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "contiguous"])
def test_edge_pad_gradcheck(shape, pad, channels_last):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(pad), dtype=torch.float64)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    assert torch.autograd.gradcheck(lambda t: k4.edge_pad(t, pad), (x.requires_grad_(True),))


@pytest.mark.parametrize("nonlinear", ["relu", "leakyrelu", None])
@pytest.mark.parametrize("use_bias", [True, False])
def test_bias_act_gradcheck(nonlinear, use_bias):
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(2, 4, 3, 5, generator=gen, dtype=torch.float64).contiguous(memory_format=torch.channels_last)
    b = torch.randn(4, generator=gen, dtype=torch.float64).requires_grad_(True) if use_bias else None
    inputs = (y.requires_grad_(True),) + ((b,) if use_bias else ())
    assert torch.autograd.gradcheck(lambda a, *c: k4.bias_act(a, c[0] if c else None, nonlinear), inputs)


# ---- the pad's gradient: the plain fold in the kernel's order ----


def _kernel_order_fold(g: np.ndarray, pad: int) -> np.ndarray:
    """``csrc/conv_epilogue.cu``'s edge_pad_bwd_kernel, one pixel at a time:
    from zero, over the output rows copied from row i, then over the columns
    copied from column j, in float32."""
    n, c, hp, wp = g.shape
    h, w = hp - 2 * pad, wp - 2 * pad
    out = np.empty((n, c, h, w), np.float32)
    for i in range(h):
        r0, r1 = (0 if i == 0 else i + pad), (h - 1 + 2 * pad if i == h - 1 else i + pad)
        for j in range(w):
            c0, c1 = (0 if j == 0 else j + pad), (w - 1 + 2 * pad if j == w - 1 else j + pad)
            acc = np.zeros((n, c), np.float32)
            for oi in range(r0, r1 + 1):
                for oj in range(c0, c1 + 1):
                    acc = (acc + g[:, :, oi, oj]).astype(np.float32)
            out[:, :, i, j] = acc
    return out


@pytest.mark.parametrize("h,w", [(7, 5), (1, 6), (2, 1), (1, 1)])
@pytest.mark.parametrize("pad", [1, 2, 3])
def test_plain_fold_is_the_kernels_order_bit_for_bit(h, w, pad):
    rng = np.random.default_rng(h * 7 + w + pad)
    # magnitudes over eight decades, so that another order rounds otherwise
    g = (rng.standard_normal((2, 3, h + 2 * pad, w + 2 * pad))
         * 10.0 ** rng.integers(-4, 4, (2, 3, h + 2 * pad, w + 2 * pad))).astype(np.float32)
    want = _kernel_order_fold(g, pad)
    got = k4.edge_pad_bwd_plain(torch.from_numpy(g), pad).numpy()
    np.testing.assert_array_equal(got, want)
    if h > 1 and w > 1:  # the order matters here: column-major sums round otherwise at some corner
        flipped = _kernel_order_fold(g.transpose(0, 1, 3, 2).copy(), pad).transpose(0, 1, 3, 2)
        assert not np.array_equal(flipped, want)


def test_plain_fold_rounds_bf16_once():
    g = torch.randn(2, 3, 9, 8, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    want = torch.from_numpy(_kernel_order_fold(g.float().numpy(), 2)).to(torch.bfloat16)
    assert torch.equal(k4.edge_pad_bwd_plain(g, 2), want)


# ---- layouts, codes, blocks ----


def test_pad_view_takes_channels_last_and_contiguous_and_refuses_others():
    x = torch.zeros(2, 3, 5, 7)
    assert k4._pad_view("t", x)[1:] == (6, 5, 7, 1)
    assert k4._pad_view("t", x.contiguous(memory_format=torch.channels_last))[1:] == (2, 5, 7, 3)
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        k4._pad_view("t", x[:, :, :, 1:])
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        k4._pad_view("t", torch.zeros(3, 5, 7))


def test_activation_codes_and_backward_blocks():
    assert [k4.act_code(n) for n in (None, "none", "ReLU", "leakyrelu")] == [0, 0, 1, 2]
    with pytest.raises(ValueError, match="nonlinearity"):
        k4.act_code("gelu")
    assert k4.bwd_blocks(1) == 1 and k4.bwd_blocks(256 * 7 + 1) == 8
    assert k4.bwd_blocks(24 * 320 * 320) == k4.BWD_BLOCKS


def test_entry_points_are_registered_in_the_build():
    from mridc_tpu_torch.kernels import binding

    syms = set(binding.SOURCES["conv_epilogue"])
    for table in (k4.PAD_SYMBOLS, k4.PAD_BWD_SYMBOLS, k4.ACT_SYMBOLS, k4.ACT_BWD_SYMBOLS):
        assert set(table.values()) <= syms
    assert len(syms) == 8
