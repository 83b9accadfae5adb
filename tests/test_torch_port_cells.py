"""Port parity: convolutions and recurrent cells against the flax modules on the
CPU, with the flax weights carried into the port (HWIO -> OIHW).

Activations are NHWC on the JAX side and NCHW channels_last on the port side.
Tolerance rtol 1e-5 / atol 1e-6 of the output's largest magnitude (float32
convolutions summed in different orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.nn import rnn_cells as tcells
from mridc_tpu_torch.utils.params import hwio_to_oihw

jlayers = importlib.import_module("mridc_tpu.nn.layers")
jcells = importlib.import_module("mridc_tpu.nn.rnn_cells")

RTOL, ATOL = 1e-5, 1e-6
B, H, W = 2, 11, 13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _nhwc(c, seed):
    return np.random.default_rng(seed).standard_normal((B, H, W, c)).astype(np.float32)


def _to_port(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # channels_last NCHW view


def _from_port(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load_conv(conv, p):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(hwio_to_oihw(np.array(p["kernel"]))))
        if "bias" in p:
            conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))


@pytest.mark.parametrize("k,d,padding", [(5, 1, "SAME"), (3, 2, "SAME"), (1, 1, "SAME"), (3, 1, "VALID")])
@pytest.mark.parametrize("use_bias", [True, False])
def test_conv_matches_flax(k, d, padding, use_bias):
    x = _nhwc(4, 0)
    jmod = jlayers.Conv(6, (k, k), kernel_dilation=(d, d), padding=padding, use_bias=use_bias)
    params = jmod.init(jax.random.PRNGKey(k + d), jnp.asarray(x))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tlayers.Conv(4, 6, k, d, padding, use_bias, pointwise_matmul=True, lane_fold=False)
    _load_conv(tmod, params)
    _close(_from_port(tmod(_to_port(x))), want)


@pytest.mark.parametrize("k,d", [(5, 1), (3, 2)])
@pytest.mark.parametrize("nonlinear", ["relu", "leakyrelu", None])
def test_conv_nonlinear_replicate_pad_matches_flax(k, d, nonlinear):
    x = _nhwc(4, 1)
    jmod = jlayers.ConvNonlinear(6, k, d, True, nonlinear)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tlayers.ConvNonlinear(4, 6, k, d, True, nonlinear)
    _load_conv(tmod.conv_layer, params["Conv_0"])
    got = _from_port(tmod(_to_port(x)))
    _close(got, want)
    # the halo repeats the border: a zero-padded conv differs at the edges
    zero_pad = torch.nn.functional.conv2d(
        _to_port(x), tmod.conv_layer.weight, tmod.conv_layer.bias, padding=tmod.pad, dilation=d
    )
    assert not np.allclose(_from_port(tlayers.activation(zero_pad, nonlinear)), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("pad", [1, 2, 4])
@pytest.mark.parametrize("channels_last", [True, False])
def test_replicate_pad_equals_torch_replicate_mode(pad, channels_last):
    x = torch.from_numpy(_nhwc(3, 6)).permute(0, 3, 1, 2)
    if not channels_last:
        x = x.contiguous()
    got = tlayers.replicate_pad(x, pad)
    assert torch.equal(got, torch.nn.functional.pad(x, (pad,) * 4, mode="replicate"))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)


def test_conv_nonlinear_rejects_unknown_nonlinearity():
    with pytest.raises(ValueError, match="nonlinearity"):
        tlayers.ConvNonlinear(2, 2, 3, 1, True, "gelu")(torch.zeros(1, 2, 4, 4))


@pytest.mark.parametrize("layer,scale,jax_init", [
    ("Conv", 1.0, jax.nn.initializers.lecun_normal),
    ("ConvNonlinear", 2.0, jax.nn.initializers.kaiming_normal),
])
def test_init_is_flax_truncated_normal(layer, scale, jax_init):
    """Each layer's reset draws flax's fan-in truncated normal: no entry past 2s
    (s = sqrt(scale / fan_in) / 0.87962566), a std within 1% of
    sqrt(scale / fan_in), a zero bias; a flax draw of the same [3, 3, 64, 128]
    kernel passes the same checks, and torch's untruncated kaiming_normal_
    fails the first."""
    cin, cout, k = 64, 128, 3
    fan_in = cin * k * k
    std = np.sqrt(scale / fan_in)
    s = std / tlayers.TRUNC_STD

    def passes(w):
        w = np.asarray(w, np.float64)
        return bool(np.abs(w).max() <= 2 * s * (1 + 1e-6)) and abs(w.std() / std - 1) < 0.01

    mod = tlayers.Conv(cin, cout, k) if layer == "Conv" else tlayers.ConvNonlinear(cin, cout, k)
    conv = mod if layer == "Conv" else mod.conv_layer
    mod.reset_parameters(torch.Generator().manual_seed(0))
    assert passes(conv.weight.detach().numpy())
    assert not bool(conv.bias.detach().any())
    assert passes(jax_init()(jax.random.PRNGKey(0), (k, k, cin, cout)))
    untruncated = torch.nn.init.kaiming_normal_(torch.empty(cout, cin, k, k), a=np.sqrt(2 / scale - 1),
                                                generator=torch.Generator().manual_seed(0))
    assert not passes(untruncated.numpy())


def test_compute_dtype_casts_at_call():
    conv = tlayers.Conv(2, 3, 3, dtype="bfloat16")
    assert conv.weight.dtype == torch.float32
    assert conv(torch.zeros(1, 2, 5, 5)).dtype == torch.bfloat16
    assert tlayers.as_torch_dtype("bfloat16") is torch.bfloat16 and tlayers.as_torch_dtype(None) is None
    with pytest.raises(ValueError):
        tlayers.as_torch_dtype("int8")


@pytest.mark.parametrize("kind", ["IndRNN", "GRU", "MGU"])
@pytest.mark.parametrize("k,d", [(1, 1), (3, 2)])
def test_cells_match_flax(kind, k, d):
    cin, f = 6, 8
    x, h = _nhwc(cin, 2), np.abs(_nhwc(f, 3))
    jmod = jcells.make_cell(kind, f, k, d, True)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(h))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 10.0, params)  # well away from relu's kink
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(h))

    tmod = tcells.make_cell(kind, cin, f, k, d, True)
    _load_conv(tmod.ih, params["Conv_0"])
    if kind == "IndRNN":
        with torch.no_grad():
            tmod.hh.copy_(torch.from_numpy(np.transpose(params["hh"], (0, 3, 1, 2))))
    else:
        _load_conv(tmod.hh, params["Conv_1"])
    got = _from_port(tmod(_to_port(x), _to_port(h)))
    _close(got, want)


def test_indrnn_larger_input_kernel_runs_plain_only_on_the_cpu(monkeypatch):
    """A 3x3 IndRNN cell runs K3 on its gathered patch channels: on CPU
    tensors each launch of its plan takes the plain version (checked against
    flax above), and on a device that is neither the CPU nor a card it raises,
    as every kernel wrapper does."""
    from mridc_tpu_torch.kernels import k3_indrnn as k3

    calls = []
    orig = k3.indrnn_plain
    monkeypatch.setattr(k3, "indrnn_plain", lambda *a, **kw: calls.append(a[2].shape) or orig(*a, **kw))
    cell = tcells.make_cell("IndRNN", 6, 8, 3, 1, True)
    cell(torch.randn(1, 6, 5, 5), torch.rand(1, 8, 5, 5))
    assert calls == [(8, 54, 1, 1)] and k3.plan(torch.float32, 6, 8, 3).launches == (1, 1)
    cell = cell.to("meta")
    x, h = torch.empty(1, 6, 5, 5, device="meta"), torch.empty(1, 8, 5, 5, device="meta")
    with pytest.raises(ValueError, match="meta"):
        cell(x, h)


def test_indrnn_bf16_cell_casts_like_flax():
    x, h = _nhwc(8, 4), np.abs(_nhwc(8, 5))
    jmod = jcells.IndRNNCell(8, dtype="bfloat16")
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(h).astype(jnp.bfloat16))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(h).astype(jnp.bfloat16))
    tmod = tcells.make_cell("IndRNN", 8, 8, 1, 1, True, dtype="bfloat16")
    _load_conv(tmod.ih, params["Conv_0"])
    with torch.no_grad():
        tmod.hh.copy_(torch.from_numpy(np.transpose(np.array(params["hh"]), (0, 3, 1, 2))))
    got = tmod(_to_port(x), _to_port(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # bfloat16 keeps 8 significant bits: both sides round the product, the bias
    # add and the recurrence, in different orders — a few bf16 ulps apart
    np.testing.assert_allclose(_from_port(got.float()), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


def test_make_cell_rejects_unknown_kind():
    with pytest.raises(ValueError, match="recurrent layer"):
        tcells.make_cell("LSTM", 2, 2, 1, 1, True)
    with pytest.raises(ValueError, match="lane_fold"):
        tcells.make_cell("GRU", 2, 2, 1, 1, True, lane_fold=True)
