"""Port parity: the MEGRE signal model, qCIRIM and the quantitative trainer of
mridc_tpu_torch against mridc_tpu's on the CPU (qVN, the quantitative data
path and the launch: ``test_torch_port_qvn.py``).

Inputs are made from a seed with numpy at 3 coils, 2-3 echoes and 16x16 (17x13
for the FFT paths): piecewise-constant phantom maps (tied maxima: the abs-max
normalisations and the R2* clamp at their ties) through the MEGRE model to
k-space. Weights are drawn with numpy in the flax tree's shapes and carried
into the port (``qcirim_params_from_jax``). Forward and loss: rtol 2e-3 /
atol 2e-4 of the largest magnitude (``tests/test_torch_parity.py:131``);
gradients elementwise at rtol 2e-3 / atol 1e-3 of each parameter's largest
magnitude (``test_torch_port_zoo2.py``'s rule); bf16 compute at rtol 3e-2 /
atol 3e-2 and relative l2 5e-2 (Z2's bf16 limits). Each JAX model is built
once per module and its inputs, not its shapes, vary between cases.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.quantitative import signal_model as jsm
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.kernels import k3_indrnn as k3
from mridc_tpu_torch.kernels import k4_conv_epilogue as k4
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.models.quantitative import signal_model as tsm
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train import task_trainers as ttt
from mridc_tpu_torch.utils.params import qcirim_params_from_jax, zoo2_params_from_jax, zoo2_params_to_jax

import test_torch_port_zoo2 as z2

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-3, 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
BF16_RTOL, BF16_ATOL, BF16_REL_L2 = 3e-2, 3e-2, 5e-2
B, E, C, H, W = 2, 3, 3, 16, 16
TES = np.array([3.0, 11.5, 20.0, 28.5], np.float32)
QCIRIM = {"model_name": "qCIRIM", "quantitative_module_num_cascades": 2, "quantitative_module_time_steps": 2,
          "quantitative_module_conv_filters": [6, 6, 4], "quantitative_module_recurrent_filters": [6, 6, 0],
          "TEs": list(map(float, TES[:E]))}
RECON = {"use_reconstruction_module": True, "reconstruction_module_num_cascades": 2,
         "reconstruction_module_time_steps": 2, "reconstruction_module_conv_filters": [4, 4, 2],
         "reconstruction_module_recurrent_filters": [4, 4, 0]}
CONVENTIONS = {"u-backward": (False, "backward"), "c-ortho": (True, "ortho")}
_close, _rel_l2 = z2._close, z2._rel_l2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def phantom_maps(rng, b, h, w):
    """Piecewise-constant maps [B, H, W, 4] (R2* in 1/s, S0, B0 in rad/s,
    phi): two tissue values per map, so that maxima tie."""
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((b, h, w, 4), np.float32)
    for i in range(b):
        blob = ((yy - rng.uniform(4, h - 4)) ** 2 + (xx - rng.uniform(4, w - 4)) ** 2) < (h / 4) ** 2
        out[i, ..., 0] = np.where(blob, 40.0, 20.0)
        out[i, ..., 1] = np.where(blob, 1.0, 0.6)
        out[i, ..., 2] = 20.0 * (xx / w - 0.5) + np.where(blob, 5.0, 0.0)
        out[i, ..., 3] = np.where(blob, 0.05, -0.05)
    return out


def qdata(b=B, e=E, c=C, h=H, w=W, seed=0, soft=False):
    """(y [B, E, C, H, W, 2] masked k-space of phantom maps, unit-RSS maps, a
    random 2D mask [B, 1, H, W] (soft: values in (0.3, 1]), maps_init near
    the maps, the maps, TEs [E]); uncentered backward FFT."""
    rng = np.random.default_rng(seed)
    maps = phantom_maps(rng, b, h, w)
    tes = TES[:e]
    sens = (rng.standard_normal((b, c, h, w)) + 1j * rng.standard_normal((b, c, h, w))).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    sig = np.asarray(jsm.megre_signal(*(jnp.asarray(maps[..., i]) for i in range(4)), tes))
    echo = sig[..., 0] + 1j * sig[..., 1]
    k = np.fft.fft2(echo[:, :, None] * sens[:, None], axes=(-2, -1))
    mask = (rng.random((b, 1, h, w)) < 0.5).astype(np.float32)
    if soft:
        mask = (mask * rng.uniform(0.3, 1.0, mask.shape)).astype(np.float32)
    y = k * mask[:, None]
    rv = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)  # noqa: E731
    maps_init = (maps * (1 + 0.1 * rng.standard_normal(maps.shape))).astype(np.float32)
    return rv(y), rv(sens), mask, maps_init, maps, tes


def _leaf(rng):
    """flax's initialisers' scales: kernels normal with variance 1 / fan-in,
    IndRNN's ``hh`` small, other leaves small."""
    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return leaf


@functools.lru_cache(maxsize=None)
def _jax_model(key):
    return jax_build_model(json.loads(key))


def _jm(cfg):
    return _jax_model(json.dumps(cfg, sort_keys=True))


def jax_vars(cfg, inputs, seed=0):
    shapes = jax.eval_shape(_jm(cfg).init, jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(seed)), dict(shapes))


@functools.lru_cache(maxsize=None)
def _jax_apply(key, train):
    return jax.jit(functools.partial(_jax_model(key).apply, train=train))


def jax_out(cfg, v, inputs, train=False):
    return _jax_apply(json.dumps(cfg, sort_keys=True), train)(v, *inputs)


def port(cfg, v):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(v, cfg))
    return model


def _inputs(d):
    y, sens, mask, maps_init, _, tes = d
    return y, sens, mask, maps_init, tes


# ---- the signal model against mridc_tpu ----


def _maps(seed, b=B, h=17, w=13):
    return phantom_maps(np.random.default_rng(seed), b, h, w)


@pytest.mark.parametrize("with_phase", [True, False])
def test_megre_signal_matches_jax(with_phase):
    m = _maps(1)
    want = jsm.megre_signal(*(jnp.asarray(m[..., i]) for i in range(4)), TES, with_phase)
    _close(tsm.megre_signal(*_t(*(m[..., i] for i in range(4))), TES, with_phase), want)


def test_megre_signal_complex_matches_jax_and_its_clips():
    """Complex maps whose imaginary B0 and real R2* arguments pass the +-30
    clips at some pixels: values and gradients (the clips split them at a
    tie as jnp.clip does)."""
    rng = np.random.default_rng(2)
    m = np.stack([_maps(2), 0.2 * _maps(3)], -1)  # [B, H, W, 4, 2]
    m[..., 2, 1] *= rng.choice([1.0, 400.0], m.shape[:3])
    m[..., 0, 0] *= rng.choice([1.0, -60.0], m.shape[:3])
    args = [m[..., i, :] for i in range(4)]
    want, vjp = jax.vjp(lambda *a: jsm.megre_signal_complex(*a, TES), *map(jnp.asarray, args))
    g = rng.standard_normal(np.shape(want)).astype(np.float32)
    ts = [a.requires_grad_(True) for a in _t(*args)]
    got = tsm.megre_signal_complex(*ts, TES)
    _close(got, want)
    got.backward(torch.from_numpy(g))
    for t_, w_ in zip(ts, vjp(jnp.asarray(g))):
        _close(t_.grad, w_)


@pytest.mark.parametrize("conv", list(CONVENTIONS))
def test_analytical_gradient_matches_jax(conv):
    """The plain composition at maps away from the data's, at 17x13 (odd FFT
    sizes)."""
    y, sens, mask, maps, _, tes = qdata(h=17, w=13, seed=3)
    c, n = CONVENTIONS[conv]
    m6 = mask[:, None, ..., None]
    want = jsm.analytical_log_likelihood_gradient(*(jnp.asarray(maps[..., i]) for i in range(4)), tes, sens, y, m6,
                                                  c, n)
    got = tsm.analytical_log_likelihood_gradient(*_t(*(maps[..., i] for i in range(4))), tes, *_t(sens, y, m6), c, n)
    _close(got, want)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
@pytest.mark.parametrize("conv", list(CONVENTIONS))
def test_normal_op_form_is_the_analytical_gradient(conv, soft):
    """``normal_op(p_e, S, M, 0) - x0`` on one row per echo against the JAX
    composition: a soft mask pins the mask applied once (M, not M^2), and the
    maps' vjp runs through ``normal_op``'s backward."""
    y, sens, mask, maps, _, tes = qdata(h=17, w=13, seed=4, soft=soft)
    c, n = CONVENTIONS[conv]

    def jfn(*m):
        return jsm.analytical_log_likelihood_gradient(*m, tes, sens, y, mask[:, None, ..., None], c, n)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(maps[..., i]) for i in range(4)))
    ops = tsm.megre_data_operands(*_t(y, sens, mask), c, n)
    assert ops[0].shape == (B * E, C, 17, 13, 2) and ops[1].shape == (B * E, 1, 17, 13)
    ts = [a.requires_grad_(True) for a in _t(*(maps[..., i] for i in range(4)))]
    got = tsm.megre_gradient(*ts, tes, *ops, c, n)
    _close(got, want)
    g = np.random.default_rng(5).standard_normal(np.shape(want)).astype(np.float32)
    got.backward(torch.from_numpy(g))
    for t_, w_ in zip(ts, vjp(jnp.asarray(g))):
        _close(t_.grad, w_)


@pytest.mark.parametrize("b", [1, 2])
def test_echo_rows_are_dense(b):
    """The maps and the mask repeated to one row per echo are dense tensors
    (the kernels take no other), row b*E + e holding batch b's."""
    y, sens, mask, _, _, _ = qdata(b=b, seed=5)
    s, m, _ = tsm.megre_data_operands(*_t(y, sens, mask))
    assert s.is_contiguous() and m.is_contiguous()
    assert torch.equal(s[E * (b - 1) + 1], torch.from_numpy(sens[b - 1]))
    assert torch.equal(m[E * (b - 1) + 2, 0], torch.from_numpy(mask[b - 1, 0]))


def test_fit_megre_maps_matches_jax_and_its_gradient():
    y, sens, mask, _, maps, tes = qdata(seed=6)
    sig = np.asarray(jsm.megre_signal(*(jnp.asarray(maps[..., i]) for i in range(4)), tes))
    want, vjp = jax.vjp(lambda s: jsm.fit_megre_maps(s, tes), jnp.asarray(sig))
    (x,) = _t(sig)
    x.requires_grad_(True)
    got = tsm.fit_megre_maps(x, tes)
    _close(got, want)
    g = np.random.default_rng(7).standard_normal(np.shape(want)).astype(np.float32)
    got.backward(torch.from_numpy(g))
    _close(x.grad, vjp(jnp.asarray(g))[0])


def test_rescale_by_max_matches_jax_at_tied_maxima():
    m = np.moveaxis(_maps(8), -1, 1)  # [B, 4, H, W]: maxima tie over whole regions
    (want, wg), vjp = jax.vjp(jsm.rescale_by_max, jnp.asarray(m))
    (x,) = _t(m)
    x.requires_grad_(True)
    got, gamma = tsm.rescale_by_max(x)
    _close(got, want)
    _close(gamma, wg)
    g = np.random.default_rng(9).standard_normal(m.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    _close(x.grad, vjp((jnp.asarray(g), jnp.zeros_like(wg)))[0])


# ---- qCIRIM against mridc_tpu ----


def _loss_parts(out_pred, out_inter, gamma, maps_target, mask_brain, jax_side, recon=None, target=None):
    """The trainer's loss on a model output: ``quantitative_loss_fn`` on the
    un-normalised intermediates, plus the reconstruction loss."""
    fn, rfn = (jtt.quantitative_loss_fn, jtt.quantitative_recon_loss_fn) if jax_side else \
        (ttt.quantitative_loss_fn, ttt.quantitative_recon_loss_fn)
    loss, _ = fn(maps_target, out_inter * gamma, mask_brain, jnp.ones(4) if jax_side else torch.ones(4), "l1")
    if recon is not None:
        loss = loss + rfn(target, recon, "l1")
    return loss


def _jax_loss_and_grads(cfg, v, inputs, maps_target, mask_brain, target=None):
    gamma = jnp.asarray((150.0, 150.0, 600.0, 150.0))

    def loss_fn(p):
        out = _jm(cfg).apply({"params": p}, *inputs, train=True)
        return _loss_parts(out.prediction, out.intermediates, gamma, maps_target, mask_brain, True,
                           out.recon_intermediates, target)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return float(loss), zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}, cfg)


def _port_loss(model, inputs, maps_target, mask_brain, target=None):
    out = model(*_t(*inputs), train=True)
    gamma = torch.tensor(model.gamma)
    return _loss_parts(out.prediction, out.intermediates, gamma, *_t(maps_target, mask_brain), False,
                       out.recon_intermediates, None if target is None else torch.from_numpy(target))


def _check_grads(got_model, want):
    got = {k: p.grad for k, p in got_model.named_parameters()}
    assert sorted(got) == sorted(want) and len(got) > 0
    for k in got:
        _close(got[k], want[k].numpy(), GRAD_RTOL, GRAD_ATOL)


@pytest.fixture(scope="module")
def qcirim_case():
    d = qdata(seed=10)
    inputs = _inputs(d)
    v = jax_vars(QCIRIM, inputs, seed=11)
    head = np.ones((B, H, W), np.float32)
    head[:, :2] = 0
    return d, inputs, v, head


def test_qcirim_forward_matches_jax(qcirim_case):
    d, inputs, v, _ = qcirim_case
    want = jax_out(QCIRIM, v, inputs)
    with torch.no_grad():
        got = port(QCIRIM, v)(*_t(*inputs))
    _close(got.prediction, want.prediction)
    _close(got.intermediates, want.intermediates)
    assert got.recon_intermediates is None


def test_qcirim_loss_and_gradients_match_jax_grad(qcirim_case):
    """Remat "step" (the default) against ``jax.grad`` on the trainer's loss,
    at phantom maps whose maxima tie (the losses' abs-max normalisations)."""
    d, inputs, v, head = qcirim_case
    want_loss, want = _jax_loss_and_grads(QCIRIM, v, inputs, d[4], head)
    m = port(QCIRIM, v)
    loss = _port_loss(m, inputs, d[4], head)
    loss.backward()
    _close(float(loss.detach()), want_loss)
    _check_grads(m, want)


def test_qcirim_remat_none_matches_remat_step(qcirim_case):
    """``remat_mode: none`` (flax's ``Scan_QRIMStep_0`` scope) gives remat
    "step"'s values and gradients; an unknown mode is refused."""
    d, inputs, v, head = qcirim_case
    step = port(QCIRIM, v)
    scan = {"params": {k: ({"Scan_QRIMStep_0": b["ScanCheckpoint_QRIMStep_0"]} if k.startswith("qRIMBlock") else b)
                       for k, b in v["params"].items()}}
    none = port({**QCIRIM, "remat_mode": "none"}, scan)
    losses = []
    for m in (step, none):
        loss = _port_loss(m, inputs, d[4], head)
        loss.backward()
        losses.append(float(loss))
    assert losses[0] == losses[1]
    for (k, a), (_, b) in zip(step.named_parameters(), none.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7, msg=k)
    with pytest.raises(ValueError, match="remat_mode"):
        build_model({**QCIRIM, "remat_mode": "cascade"}, device="cpu")


def test_qcirim_bf16_compute_matches_jax(qcirim_case):
    d, inputs, v, _ = qcirim_case
    cfg = {**QCIRIM, "compute_dtype": "bfloat16"}
    want = np.asarray(jax_out(cfg, v, inputs).prediction)
    m = port(cfg, v)
    assert m.qrim[0].layers[0].rnn.ih.compute_dtype == torch.bfloat16
    with torch.no_grad():
        got = m(*_t(*inputs)).prediction
    assert got.dtype == torch.float32
    _close(got, want, BF16_RTOL, BF16_ATOL)
    assert _rel_l2(got, want) < BF16_REL_L2


@pytest.fixture(scope="module")
def recon_case():
    cfg = {**QCIRIM, **RECON, "quantitative_module_num_cascades": 1}
    d = qdata(b=1, e=2, seed=12)
    inputs = _inputs(d)
    cfg["TEs"] = list(map(float, d[5]))
    v = jax_vars(cfg, inputs, seed=13)
    rng = np.random.default_rng(14)
    target = rng.standard_normal((1, 2, H, W, 2)).astype(np.float32)
    return cfg, d, inputs, v, target


def test_qcirim_reconstruction_module_matches_jax(recon_case):
    """Each echo's own RIMBlocks (flax's ``RIMBlock_{e * R + c}``, distinct
    weights), the chaining, y replaced by F(S pred) and the maps re-fitted:
    the forward, the reconstruction stack [E, R, T, B, H, W, 2], and the loss
    with the per-echo reconstruction term and its gradients."""
    cfg, d, inputs, v, target = recon_case
    assert sorted(k for k in v["params"] if k.startswith("RIMBlock")) == [f"RIMBlock_{i}" for i in range(4)]
    want = jax_out(cfg, v, inputs)
    m = port(cfg, v)
    assert len(m.recon) == 4 and not torch.equal(m.recon[0].layers[0].rnn.hh, m.recon[2].layers[0].rnn.hh)
    with torch.no_grad():
        got = m(*_t(*inputs))
    _close(got.prediction, want.prediction)
    assert got.recon_intermediates.shape == (2, 2, 2, 1, H, W, 2)
    _close(got.recon_intermediates, want.recon_intermediates)
    head = np.ones((1, H, W), np.float32)
    want_loss, want_g = _jax_loss_and_grads(cfg, v, inputs, d[4], head, target)
    loss = _port_loss(m, inputs, d[4], head, target)
    loss.backward()
    _close(float(loss.detach()), want_loss)
    _check_grads(m, want_g)


def test_reconstruction_module_refuses_another_echo_count(recon_case):
    cfg, d, inputs, v, _ = recon_case
    with pytest.raises(ValueError, match="echoes"):
        port(cfg, v)(*_t(np.concatenate([inputs[0]] * 2, 1), *inputs[1:4], TES))


# ---- losses ----


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    target = np.abs(phantom_maps(rng, B, H, W))
    preds = (target[None, None] * (1 + 0.2 * rng.standard_normal((2, 3, B, H, W, 4)))).astype(np.float32)
    head = (rng.random((B, H, W)) < 0.8).astype(np.float32)
    return target, preds, head


@pytest.mark.parametrize("kind", ["l1", "mse", "ssim"])
def test_quantitative_loss_matches_jax(kind):
    """Values, per-map terms and gradients (jax.grad) in each loss family,
    at tied maxima, with factors from the reference YAML's list form."""
    target, preds, head = _loss_inputs(15)
    factors = [{"R2star": 3.0}, {"S0": 1.0}, {"B0": 0.5}, {"phi": 2.0}]
    jf, tf = jtt.parse_loss_regularization_factors(factors), ttt.parse_loss_regularization_factors(factors)
    (want, want_per), vjp = jax.vjp(lambda p: jtt.quantitative_loss_fn(target, p, head, jf, kind), jnp.asarray(preds))
    (x,) = _t(preds)
    x.requires_grad_(True)
    got, per = ttt.quantitative_loss_fn(*_t(target), x, *_t(head), tf, kind)
    _close(got, want)
    _close(per, want_per)
    got.backward()
    _close(x.grad, vjp((jnp.ones(()), jnp.zeros(4)))[0])


@pytest.mark.parametrize("kind", ["l1", "mse"])
def test_quantitative_recon_loss_matches_jax(kind):
    rng = np.random.default_rng(16)
    target = rng.standard_normal((B, 2, H, W, 2)).astype(np.float32)
    ri = rng.standard_normal((2, 2, 3, B, H, W, 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda r: jtt.quantitative_recon_loss_fn(target, r, kind), jnp.asarray(ri))
    (x,) = _t(ri)
    x.requires_grad_(True)
    got = ttt.quantitative_recon_loss_fn(torch.from_numpy(target), x, kind)
    _close(got, want)
    got.backward()
    _close(x.grad, vjp(jnp.ones(()))[0])
    with pytest.raises(ValueError, match="l1/mse"):
        ttt.quantitative_recon_loss_fn(torch.from_numpy(target), x, "ssim")


@pytest.mark.parametrize("factors", [None, {"R2star": 3.0, "B0": 0.5}, [1.0, 2.0, 3.0, 4.0],
                                     [{"R2star": 3.0}, {"S0": 1.5}], 2.5],
                         ids=["none", "dict", "list", "yaml-list", "scalar"])
def test_parse_loss_regularization_factors_matches_jax(factors):
    got = ttt.parse_loss_regularization_factors(factors)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtt.parse_loss_regularization_factors(factors)))


# ---- the trainer against mridc_tpu's ----


@pytest.fixture(scope="module")
def trainer_case():
    cfg = {**QCIRIM, "quantitative_module_num_cascades": 1}
    d = qdata(b=1, seed=17)
    head = np.ones((1, H, W), np.float32)
    batch = {"kspace": d[0], "sensitivity_maps": d[1], "mask": d[2], "maps_init": d[3], "maps_target": d[4],
             "mask_brain": head, "TEs": d[5]}
    v = jax_vars(cfg, _inputs(d), seed=18)
    return cfg, batch, v


def test_quantitative_trainer_steps_and_validate_match_jax(trainer_case):
    """Three Adam steps of ``QuantitativeTrainer`` against the JAX trainer
    (losses, gradient norms, the weights after), then ``validate()``."""
    cfg, batch, v = trainer_case
    optim = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0}
    jt = jtt.QuantitativeTrainer(_jm(cfg), optim_cfg=optim, loss_type="l1",
                                 loss_regularization_factors=[{"R2star": 2.0}])
    jt.init_state(jax.random.PRNGKey(0), batch)
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]))
    tt = ttt.QuantitativeTrainer(port(cfg, v), optim_cfg=optim, loss_type="l1",
                                 loss_regularization_factors=[{"R2star": 2.0}], device="cpu")
    for _ in range(3):
        want, got = jt.training_batch(batch), tt.training_batch(batch)
        _close(float(got["loss"]), float(want["loss"]))
        _close(float(got["grad_norm"]), float(want["grad_norm"]))
        assert float(got["recon_loss"]) == 0.0
    params = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jt.state.params)}, cfg)
    for k, p in tt.model.named_parameters():
        _close(p, params[k].numpy())
    want_val, got_val = jt.validate([batch]), tt.validate([batch])
    assert sorted(got_val) == sorted(want_val) == ["val_NMSE_B0", "val_NMSE_R2star", "val_NMSE_S0", "val_NMSE_phi",
                                                   "val_loss"]
    for k in want_val:
        _close(got_val[k], want_val[k])


def test_val_loss_carries_the_reconstruction_term(recon_case):
    """With the reconstruction module and a target, ``val_loss`` adds the
    per-echo reconstruction loss of the inference forward, as the JAX
    trainer's does (both terms are held against mridc_tpu above)."""
    cfg, d, inputs, v, target = recon_case
    batch = {"kspace": d[0], "sensitivity_maps": d[1], "mask": d[2], "maps_init": d[3], "maps_target": d[4],
             "mask_brain": np.ones((1, H, W), np.float32), "TEs": d[5], "target": target}
    tt = ttt.QuantitativeTrainer(port(cfg, v), optim_cfg={"name": "adam", "lr": 1e-3}, device="cpu")
    with_recon = tt.validate([batch])["val_loss"]
    without = tt.validate([{k: x for k, x in batch.items() if k != "target"}])["val_loss"]
    want = jax_out(cfg, v, inputs)
    quant, _ = jtt.quantitative_loss_fn(d[4], want.prediction[None, None], batch["mask_brain"], jnp.ones(4), "l1")
    _close(without, quant)
    _close(with_recon, quant + jtt.quantitative_recon_loss_fn(target, want.recon_intermediates, "l1"))
    assert with_recon > without


# ---- weights both ways, archives ----


@pytest.mark.parametrize("case", ["plain", "remat-none", "recon"])
def test_params_carry_every_leaf_both_ways(case, qcirim_case, recon_case):
    if case == "recon":
        cfg, _, _, v, _ = recon_case
    else:
        _, _, v, _ = qcirim_case
        cfg = QCIRIM
        if case == "remat-none":
            cfg = {**QCIRIM, "remat_mode": "none"}
            v = {"params": {k: ({"Scan_QRIMStep_0": b["ScanCheckpoint_QRIMStep_0"]} if k.startswith("qRIMBlock")
                                else b) for k, b in v["params"].items()}}
    state = qcirim_params_from_jax(v, cfg)
    back = zoo2_params_to_jax(state, cfg)
    flat = lambda t: {"/".join(p.key for p in path): np.asarray(a)  # noqa: E731
                      for path, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(v["params"]), flat(back["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert sorted(state) == sorted(build_model(cfg, device="cpu").state_dict())


def test_archives_restore_across_the_packages(tmp_path, recon_case):
    """The port writes qCIRIM's ``.mridc`` as flax msgpack, which mridc_tpu
    restores, and restores the archive mridc_tpu writes."""
    cfg, _, inputs, v, _ = recon_case
    m = port(cfg, v)
    path = checkpoints.save_archive(tmp_path / "port.mridc", cfg, m.state_dict())
    _, params, _ = jckpt.restore_model(path)
    with torch.no_grad():
        got = m(*_t(*inputs)).prediction
    _close(got, jax_out(cfg, {"params": params}, inputs).prediction)
    jpath = jckpt.save_archive(tmp_path / "jax.mridc", cfg, jax.tree_util.tree_map(np.asarray, v["params"]))
    restored, _, _ = checkpoints.restore_model(jpath, device="cpu")
    for (k, a), (_, b) in zip(restored.state_dict().items(), m.state_dict().items()):
        assert torch.equal(a, b), k


# ---- the registry, the launch tables and phase Q's configs ----


def test_quantitative_models_build_in_the_port():
    from mridc_tpu_torch.models import PENDING_MODELS, available_models

    for name in ("QCIRIM", "QRIM", "QVN", "QVARNET"):
        assert name in available_models() and name not in PENDING_MODELS
    assert type(build_model({"model_name": "qRIM"}, device="cpu")).__name__ == "qCIRIM"


def _chip_smoke():
    return z2._chip_smoke()


def _counting(monkeypatch):
    """Count the K2 and K3 launches that the CPU path's plain calls stand for
    (each Function and stage calls its plain version where the card launches)."""
    counts = {}

    def count(mod, name, symbols):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    def load(needed, fft_order):
        return ["k2_load"] if needed and not fft_order else []

    def dt(x):
        return "bf16" if x.dtype == torch.bfloat16 else "f32"

    count(k2, "sens_expand_plain", lambda x, s, c=False, n="backward", fft_order=False, mask=None:
          ["k2_expand", *(["k2_mask"] if mask is not None else []), *load(c, fft_order)])
    count(k2, "sens_expand_bwd_plain", lambda g, s, c=False, n="backward", fft_order=False, mask=None:
          [*load(c or mask is not None, fft_order), "k2_reduce"])
    count(k2, "sens_reduce_plain", lambda k, s, m=None, c=False, *a, fft_order=False, **kw:
          [*load(c or m is not None, fft_order), "k2_reduce"])
    count(k2, "sens_reduce_bwd_plain", lambda g, s, m=None, c=False, n="backward", fft_order=False:
          ["k2_expand", *(["k2_mask"] if m is not None else []), *load(c, fft_order)])
    count(k2, "normal_op_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce"])
    count(k2, "full_dc_plain", lambda *a, **kw: ["k2_expand", "k2_residual", "k2_reduce"])
    count(k2, "full_dc_bwd_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce_acc"])
    count(k3, "indrnn_plain", lambda x, *a, **kw: [f"k3_indrnn_{dt(x)}"])
    count(k3, "indrnn_bwd_plain", lambda g, x, *a, **kw: [f"k3_indrnn_bwd_{dt(x)}"])
    count(k4, "edge_pad_plain", lambda x, *a, **kw: [k4.PAD_SYMBOLS[x.dtype]])
    count(k4, "edge_pad_bwd_plain", lambda g, *a, **kw: [k4.PAD_BWD_SYMBOLS[g.dtype]])
    count(k4, "bias_act_plain", lambda y, *a, **kw: [k4.ACT_SYMBOLS[y.dtype]])
    count(k4, "bias_act_bwd_plain",
          lambda g, out, act, want_db: [k4.ACT_BWD_SYMBOLS[g.dtype]] if act or want_db else [])
    return counts


def test_chip_smoke_q_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.Q_PER_FORWARD and Q_PER_STEP derive the K2 and K3 launches
    of phase Q's forwards and steps (4 echoes, the configs' depths); counted
    on the CPU path with the widths cut to 8 filters and 4 channels."""
    cs = _chip_smoke()
    counts = _counting(monkeypatch)
    d = qdata(b=1, e=4, c=2, seed=19)
    batch = {"kspace": d[0], "sensitivity_maps": d[1], "mask": d[2], "maps_init": d[3], "maps_target": d[4],
             "mask_brain": np.ones((1, H, W), np.float32), "TEs": d[5],
             "target": np.random.default_rng(20).standard_normal((1, 4, H, W, 2)).astype(np.float32)}
    cut = {"quantitative_module_conv_filters": [8, 8, 4], "quantitative_module_recurrent_filters": [8, 8, 0],
           "quantitative_module_channels": 4, "reconstruction_module_conv_filters": [8, 8, 2],
           "reconstruction_module_recurrent_filters": [8, 8, 0]}

    def model(cfg_name, overrides):
        cfg = {**cs.Q_CFGS[cfg_name], **overrides}
        return build_model({**cfg, **{k: x for k, x in cut.items() if k.startswith("quantitative") or
                                      overrides.get("use_reconstruction_module")}}, device="cpu")

    for run, (cfg_name, overrides, _) in cs.Q_SERVE.items():
        counts.clear()
        with torch.no_grad():
            model(cfg_name, overrides)(*_t(*_inputs(d)))
        assert counts == cs.Q_PER_FORWARD[run], run
    for run, (cfg_name, overrides, _, table) in cs.Q_TRAIN.items():
        if run.endswith("_b4"):
            continue  # the B=1 run's counts (the tables do not depend on the batch)
        trainer = ttt.QuantitativeTrainer(model(cfg_name, overrides), optim_cfg=cs.TRAIN_OPTIM, device="cpu")
        trainer.init_state(batch)
        counts.clear()
        trainer.training_batch(batch)
        assert counts == cs.Q_PER_STEP[table], run


def _yaml(name):
    from mridc_tpu.train import config as jconfig

    return jconfig.load_config(ROOT / f"projects/quantitative/conf/{name}.yaml")


@pytest.mark.parametrize("name,attr", [("base_qcirim_train", "QCIRIM_TRAIN_CFG"), ("base_qcirim_run", "QCIRIM_RUN_CFG"),
                                       ("base_qvn_train", "QVN_TRAIN_CFG")])
def test_chip_smoke_q_configs_are_the_yamls(name, attr):
    """Phase Q's literal configs (the model keys of ``Q_CFGS`` and the whole
    run configs) equal the YAMLs."""
    cs = _chip_smoke()
    cfg = getattr(cs, attr)
    assert cfg == _yaml(name)
    q = cs.Q_CFGS["qcirim" if "qcirim" in name else "qvn"]
    assert {k: cfg["model"][k] for k in q} == q
