"""Port parity: the CIRIM inference forward of mridc_tpu_torch against
mridc_tpu's on the CPU, with the same weights.

Weights are drawn with numpy in the flax tree layout of each config (shapes
from ``jax.eval_shape``, so no init is compiled) and carried into the port
through ``cirim_params_from_jax``; the configs spread over the four
``remat_mode`` scope layouts. Tolerance rtol 2e-3 / atol 2e-4, the one
``tests/test_torch_parity.py`` holds the JAX package to against torch: the
sums over cascades x steps run in different orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.utils.torch_import import import_cirim_params
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.nn.rim import RIMBlock
from mridc_tpu_torch.utils.params import cirim_params_from_jax, rim_block_params_from_jax

jrim = importlib.import_module("mridc_tpu.nn.rim")

RTOL, ATOL = 2e-3, 2e-4
B, C, CASCADES, T, F = 2, 3, 2, 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    cfg = {
        "model_name": "CIRIM",
        "num_cascades": CASCADES,
        "time_steps": T,
        "recurrent_layer": "IndRNN",
        "conv_filters": [F, F, 2],
        "conv_kernels": [5, 3, 3],
        "conv_dilations": [1, 2, 1],
        "recurrent_filters": [F, F, 0],
        "recurrent_kernels": [1, 1, 0],
        "recurrent_dilations": [1, 1, 0],
        "fft_centered": True,
        "fft_normalization": "ortho",
    }
    cfg.update(kw)
    return cfg


def _data(h, w, seed=0):
    """bench.py's recipe at a small size: unit-RSS sensitivities, 1D column mask."""
    rng = np.random.default_rng(seed)
    shape = (B, C, h, w)
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = np.zeros((B, 1, h, w), np.float32)
    mask[..., ::4] = 1.0
    mask[..., w // 2 - 3 : w // 2 + 3] = 1.0
    y = y * mask
    rv = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)  # noqa: E731
    return rv(y), rv(sens), mask


def _random_tree(shapes, seed):
    """Numpy leaves shaped like the flax tree, scaled like its initializers."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[1:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(1.0 / fan_in)).astype(np.float32)
        if name == "hh":
            return rng.uniform(0.0, 0.5, s.shape).astype(np.float32)
        if name == "dc_weight":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_forward(cfg, params, y, sens, mask, init_pred=None):
    model = jax_build_model(cfg)
    args = [jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask)]
    if init_pred is not None:
        args.append(jnp.asarray(init_pred))
    out = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(params, *args)
    inter = None if out.intermediates is None else np.asarray(out.intermediates)
    return np.asarray(out.prediction), inter


def _jax_params(cfg, y, sens, mask, seed):
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask))
    return _random_tree(shapes["params"], seed)


def _port_forward(cfg, state, y, sens, mask, init_pred=None):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = model(t(y), t(sens), t(mask), t(init_pred))
    inter = None if out.intermediates is None else out.intermediates.numpy()
    return out.prediction.numpy(), inter


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


CASES = {
    "full": dict(size=(24, 24), cfg={"dc_mode": "full", "remat_mode": "step+cascade"}),
    "psf1d": dict(size=(24, 24), cfg={"dc_mode": "psf1d", "remat_mode": "none", "stack_intermediates": False}),
    "full_soft_dc_odd": dict(size=(24, 21), cfg={"dc_mode": "full", "no_dc": False, "remat_mode": "step"}),
    "psf1d_restart_odd": dict(
        size=(24, 21), cfg={"dc_mode": "psf1d", "keep_prediction": False, "remat_mode": "cascade"}
    ),
    "full_init_pred": dict(size=(24, 24), cfg={"dc_mode": "full", "compute_dtype": None}, init_pred=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cirim_forward_matches_jax(case):
    spec = CASES[case]
    cfg = _cfg(**spec["cfg"])
    y, sens, mask = _data(*spec["size"])
    init_pred = None
    if spec.get("init_pred"):
        init_pred = np.random.default_rng(9).standard_normal((B, *spec["size"], 2)).astype(np.float32)
    params = _jax_params(cfg, y, sens, mask, seed=len(case))
    want, want_inter = _jax_forward(cfg, params, y, sens, mask, init_pred)
    got, got_inter = _port_forward(cfg, cirim_params_from_jax(params), y, sens, mask, init_pred)
    assert got.shape == want.shape == (B, *spec["size"], 2)
    assert np.isfinite(got).all()
    _close(got, want)
    if cfg.get("stack_intermediates", True):
        assert got_inter.shape == want_inter.shape == (CASCADES, T, B, *spec["size"], 2)
        _close(got_inter, want_inter)
    else:
        assert got_inter is None and want_inter is None


@pytest.mark.parametrize("remat_mode", ["step+cascade", "cascade", "step", "none"])
def test_cirim_params_from_jax_reads_every_remat_layout(remat_mode):
    cfg = _cfg(remat_mode=remat_mode, no_dc=False)
    y, sens, mask = _data(16, 16)
    params = _jax_params(cfg, y, sens, mask, seed=3)
    state = cirim_params_from_jax({"params": params})
    port = build_model(cfg, device="cpu")
    assert sorted(state) == sorted(port.state_dict())
    port.load_state_dict(state)
    step = params[next(iter(params))]["RIMBlock_0"]
    step = step[next(k for k in step if k.endswith("RIMStep_0"))]
    np.testing.assert_array_equal(
        state["cirim.1.layers.0.convs.conv_layer.weight"].numpy(),
        np.transpose(step["ConvNonlinear_0"]["Conv_0"]["kernel"][1], (3, 2, 0, 1)),
    )
    np.testing.assert_array_equal(state["cirim.0.layers.1.rnn.hh"].numpy().ravel(), step["IndRNNCell_1"]["hh"][0].ravel())


def test_chip_smoke_weights_have_the_flax_layout():
    """chip_smoke.py draws its weights without JAX, in the flax tree layout;
    that layout must be the one mridc_tpu's CIRIM really has."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    cfg = chip_smoke.flagship_cfg(num_cascades=2, time_steps=2, conv_filters=[F, F, 2], recurrent_filters=[F, F, 0])
    y, sens, mask = _data(16, 16)
    want = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), *map(jnp.asarray, (y, sens, mask)))
    for gain in (None, chip_smoke.MAIN_GAIN, 1.0):
        got = chip_smoke.jax_layout_tree(cfg, seed=0, gain=gain)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a, b: a.shape == b.shape, got, want))


def test_state_dict_round_trips_through_the_jax_importer():
    cfg = _cfg(dc_mode="psf1d")
    y, sens, mask = _data(24, 24, seed=1)
    port = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    state = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    params = import_cirim_params(state, CASCADES)
    want, _ = _jax_forward(cfg, params, y, sens, mask)
    got, _ = _port_forward(cfg, port.state_dict(), y, sens, mask)
    _close(got, want)
    again = cirim_params_from_jax(params)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy())


def test_rim_block_return_hx_matches_jax():
    y, sens, mask = _data(16, 16, seed=2)
    kw = dict(
        conv_filters=(F, F, 2), recurrent_filters=(F, F, 0), time_steps=T, fft_centered=True,
        fft_normalization="ortho",
    )
    jblock = jrim.RIMBlock(**kw)
    jargs = (jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask))
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), *jargs)
    params = _random_tree(shapes["params"], seed=4)
    hx0 = tuple(np.random.default_rng(i).uniform(0, 1, (B, 16, 16, F)).astype(np.float32) for i in range(2))
    want = jax.jit(lambda p, hx: jblock.apply({"params": p}, *jargs, hx=hx, return_hx=True))(params, hx0)

    tblock = RIMBlock(**kw)
    tblock.load_state_dict(rim_block_params_from_jax(params))
    with torch.no_grad():
        got = tblock(*(torch.from_numpy(a) for a in (y, sens, mask)), hx=tuple(map(torch.from_numpy, hx0)),
                     return_hx=True)
    etas, eta, hx = got
    assert etas.shape == (T, B, 16, 16, 2) and [h.shape for h in hx] == [(B, 16, 16, F)] * 2
    _close(etas.numpy(), np.asarray(want[0]))
    _close(eta.numpy(), np.asarray(want[1]))
    for g, w in zip(hx, want[2]):
        _close(g.numpy(), np.asarray(w))


def test_soft_dc_tail_trains_like_jax_grad():
    """The soft-DC tail (no_dc=False) in train mode: its SENSE expansion and
    reduction are autograd Functions with a hand-written backward (the
    adjoints, on K2's stages on the card, their plain versions here). With
    stack_intermediates off the loss reads the last cascade's tail output, so
    the backward runs through the tail; the loss and every gradient equal
    jax.grad's (psf1d dc_mode, remat step+cascade)."""
    from mridc_tpu.train.losses import process_reconstruction_loss as jloss
    from mridc_tpu_torch.train.losses import process_reconstruction_loss

    cfg = _cfg(dc_mode="psf1d", no_dc=False, remat_mode="step+cascade", stack_intermediates=False)
    y, sens, mask = _data(16, 13, seed=3)
    target = np.random.default_rng(4).standard_normal((B, 16, 13, 2)).astype(np.float32)
    params = _jax_params(cfg, y, sens, mask, seed=6)
    model = jax_build_model(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(out, jnp.asarray(target), "l1")

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = cirim_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(cirim_params_from_jax(params))
    out = port(*(torch.from_numpy(a) for a in (y, sens, mask)), train=True)
    loss = process_reconstruction_loss(out, torch.from_numpy(target), "l1")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    last = f"cirim.{CASCADES - 1}.dc_weight"
    assert float(want[last].abs().max()) > 0 and port.get_parameter(last).grad is not None
    for k, p in port.named_parameters():
        if p.grad is None:
            # cascades chain detached, so only the last one reaches the loss:
            # jax.grad gives exact zeros to the others
            assert not k.startswith(f"cirim.{CASCADES - 1}.") and float(want[k].abs().max()) == 0, k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL * max(1.0, float(want[k].abs().max())))
