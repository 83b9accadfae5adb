"""Port parity: RecurrentVarNet, MultiDomainNet, CS and PICS of mridc_tpu_torch
against mridc_tpu's on the CPU, with their parts (Conv2dGRU, RecurrentInit,
MultiDomainConv, StandardizationLayer, the FISTA solvers and the Haar
transform), the weight carry both ways, ``.mridc`` archives across the two
packages, and the launch tables chip_smoke.py asserts for these models (the
launch path: ``test_torch_port_zoo3_launch.py``).

Inputs are made from a seed with numpy at 4 coils, 16x16, and at 17x13 (the
Haar padding of the wavelet prox, MultiDomainNet's reflect pad, the GRU's
edge pads); weights are drawn with numpy in the flax tree's shapes and
carried into the port through ``zoo2_params_from_jax``. Forward and loss:
rtol 2e-3 / atol 2e-4 of the largest magnitude
(``tests/test_torch_parity.py:131``); gradients elementwise at rtol 2e-3 /
atol 1e-3 of each parameter's largest magnitude (``test_torch_port_zoo2.py``'s
rule); bf16 compute at rtol 3e-2 / atol 3e-2 of the largest magnitude and
relative l2 5e-2 (Z2's bf16 limits). The Haar transform: bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.base import ModelOutput as JOut
from mridc_tpu.models.recon import rvn as jrvn
from mridc_tpu.nn import cs_solvers as jcs
from mridc_tpu.nn import multidomain as jmd
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch import launch
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.kernels import k4_conv_epilogue as k4
from mridc_tpu_torch.models import PENDING_MODELS, available_models, build_model
from mridc_tpu_torch.models.recon import rvn as trvn
from mridc_tpu_torch.nn import cs_solvers as tcs
from mridc_tpu_torch.nn import multidomain as tmd
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils import params as tparams
from mridc_tpu_torch.utils.params import (multidomainnet_params_from_jax, rvn_params_from_jax, zoo2_params_from_jax,
                                          zoo2_params_to_jax)

import test_torch_port_zoo2 as z2

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-3, 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
BF16_RTOL, BF16_ATOL, BF16_REL_L2 = 3e-2, 3e-2, 5e-2
B, C, H, W = 2, 4, 16, 16
CONVENTIONS = {"u-backward": (False, "backward"), "c-ortho": (True, "ortho")}
RVN = {"model_name": "RVN", "recurrent_hidden_channels": 4, "recurrent_num_layers": 3, "num_steps": 8,
       "initializer_channels": [3, 5, 6], "initializer_dilations": [1, 2, 1]}
MDN = {"model_name": "MultiDomainNet", "num_filters": 4, "num_pool_layers": 2}
YAMLS = [f"reconstruction/conf/base_{m}_{k}.yaml" for m in ("rvn", "multidomainnet", "cs", "pics")
         for k in ("train", "run")] + [f"unselfsupervised/conf/base_{m}_run.yaml" for m in ("cs", "pics")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_close, _t, _data = z2._close, z2._t, z2._data


def _cfg(base, conv="u-backward", **kw):
    centered, norm = CONVENTIONS[conv]
    return {**base, "fft_centered": centered, "fft_normalization": norm, **kw}


def _jax_vars(cfg, y, sens, mask, seed=0):
    """``test_torch_port_zoo2``'s numpy leaves, with RVN's learning rates near
    1 (its DC step) instead of small."""
    v = z2._jax_vars(cfg, y, sens, mask, seed)
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if p[-1].key == "learning_rate" else a, v)


def _jax_predict(cfg, v, *inputs):
    return np.asarray(jax.jit(jax_build_model(cfg).apply)(v, *inputs).prediction)


def _port(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(variables, cfg))
    return model


def _module_state(mod, pairs_fn, v):
    """A port module's state from a flax module's variables by its pairs."""
    leaves = {"/".join(p.key for p in path): np.asarray(a)
              for path, a in jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    state = {pk: torch.from_numpy(np.ascontiguousarray(tparams._FROM[kind](leaves.pop(f))))
             for _, f, pk, kind in pairs_fn(mod, "", "")}
    assert not leaves
    return state


def _nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- the parts against mridc_tpu ----


@pytest.mark.parametrize("with_state", [False, True])
def test_conv2d_gru_matches_jax(with_state):
    x = _nhwc((2, 13, 11, 2), 1)
    state = _nhwc((2, 13, 11, 4, 3), 2) if with_state else None
    jmod = jrvn.Conv2dGRU(hidden_channels=4, out_channels=2, num_layers=3)
    v = jax.tree_util.tree_map_with_path(z2._leaf(np.random.default_rng(3)),
                                         dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, state)))
    want_out, want_state = jmod.apply(v, x, state)
    mod = trvn.Conv2dGRU(2, 4, 2, 3)
    mod.load_state_dict(_module_state(mod, tparams._gru_pairs, v))
    tstate = None if state is None else [torch.from_numpy(state[..., i]).permute(0, 3, 1, 2) for i in range(3)]
    with torch.no_grad():
        out, new = mod(torch.from_numpy(x).permute(0, 3, 1, 2), tstate)
    _close(out.permute(0, 2, 3, 1), want_out)
    _close(torch.stack([s.permute(0, 2, 3, 1) for s in new], -1), want_state)


@pytest.mark.parametrize("multiscale", [1, 2])
def test_recurrent_init_matches_jax(multiscale):
    x = _nhwc((2, 13, 11, 2), 4)
    jmod = jrvn.RecurrentInit(4, channels=(3, 5, 6), dilations=(1, 2, 4), depth=3, multiscale_depth=multiscale)
    v = jax.tree_util.tree_map_with_path(z2._leaf(np.random.default_rng(5)),
                                         dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)))
    mod = trvn.RecurrentInit(2, 4, (3, 5, 6), (1, 2, 4), 3, multiscale)
    mod.load_state_dict(_module_state(mod, tparams._recurrent_init_pairs, v))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(torch.stack([s.permute(0, 2, 3, 1) for s in got], -1), jmod.apply(v, x))


def test_gru_gates_are_orthogonal_and_the_rest_lecun_normal():
    """flax's initialisers: orthogonal gate kernels (the (in, out) matrix's
    columns orthonormal), zero biases, a learning rate of one."""
    model = build_model(_cfg(RVN), device="cpu", generator=torch.Generator().manual_seed(0))
    gru = model.block_list[0].regularizer
    for gate in (gru.update_gates[1], gru.reset_gates[0], gru.out_gates[2]):
        m = gate.weight.detach().reshape(gate.weight.shape[0], -1)
        torch.testing.assert_close(m @ m.T, torch.eye(m.shape[0]), atol=1e-5, rtol=0)
        assert not gate.bias.any()
    assert torch.equal(model.block_list[3].learning_rate.detach(), torch.ones(1))
    w = gru.conv_blocks[1].weight.detach()
    assert abs(float(w.std()) - (1 / w[0].numel()) ** 0.5) < 0.2 * (1 / w[0].numel()) ** 0.5


@pytest.mark.parametrize("transpose", [False, True])
def test_multidomain_conv_matches_jax(transpose):
    x = _nhwc((2, 9, 7, 6), 6)
    jmod = jmd.MultiDomainConv(8, transpose, fft_centered=True, fft_normalization="ortho")
    v = jax.tree_util.tree_map_with_path(z2._leaf(np.random.default_rng(7)),
                                         dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)))
    mod = tmd.MultiDomainConv(6, 8, transpose, True, "ortho")
    mod.load_state_dict(_module_state(mod, tparams._mdconv_pairs, v))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    _close(got.permute(0, 2, 3, 1), jmod.apply(v, x))


def test_standardization_layer_matches_jax():
    y, sens, _, _ = _data(b=B, c=C, h=17, w=13, seed=8)
    want = jmd.StandardizationLayer(1).apply({}, y, sens)
    got = tmd.StandardizationLayer(1)(*_t(y, sens))
    assert got.shape == (B, C, 17, 13, 4)
    _close(got, want)
    with pytest.raises(ValueError, match="no gradient"):
        tmd.StandardizationLayer(1)(torch.from_numpy(y).requires_grad_(True), torch.from_numpy(sens))


def test_haar_transform_is_bit_identical():
    x = _nhwc((2, 3, 16, 24), 9)
    ll_j, bands_j = jcs.haar_dwt2(jnp.asarray(x), 3)
    ll_t, bands_t = tcs.haar_dwt2(torch.from_numpy(x), 3)
    assert np.array_equal(ll_t.numpy(), np.asarray(ll_j))
    for bj, bt in zip(bands_j, bands_t):
        for a, b in zip(bj, bt):
            assert np.array_equal(b.numpy(), np.asarray(a))
    assert np.array_equal(tcs.haar_idwt2(ll_t, bands_t).numpy(), np.asarray(jcs.haar_idwt2(ll_j, bands_j)))


def _soft_mask(mask, seed):
    return (mask * np.random.default_rng(seed).uniform(0.3, 1.0, mask.shape)).astype(np.float32)


@pytest.mark.parametrize("iters", [5, 60])
@pytest.mark.parametrize("mask_kind", ["binary", "soft"])
@pytest.mark.parametrize("solver", ["l1_wavelet", "tv"])
def test_fista_solvers_match_jax(solver, mask_kind, iters):
    """The soft mask pins the mask applied twice (E^H E = S^H F^-1 M^2 F S)."""
    y, sens, mask, _ = _data(b=B, c=C, h=H, w=W, seed=10)
    if mask_kind == "soft":
        mask = _soft_mask(mask, 11)
        y = y * mask[..., None]
    jfn, tfn = {"l1_wavelet": (jcs.fista_l1_wavelet, tcs.fista_l1_wavelet),
                "tv": (jcs.fista_tv, tcs.fista_tv)}[solver]
    kw = dict(reg_wt=0.05, num_iters=iters, fft_centered=True, fft_normalization="ortho")
    want = np.asarray(jax.jit(lambda a, b, c: jfn(a, b, c, **kw))(y, sens, mask))
    got = tfn(*_t(y, sens, mask), **kw)
    assert got.shape == (B, H, W, 2)
    _close(got, want)


# ---- the models against mridc_tpu ----


RVN_CASES = {
    "sense": _cfg(RVN),
    "sense-c-ortho": _cfg(RVN, "c-ortho"),
    "input_image": _cfg(RVN, initializer_initialization="input_image"),
    "zero_filled": _cfg(RVN, initializer_initialization="zero_filled"),
    "shared-multiscale": _cfg(RVN, "c-ortho", no_parameter_sharing=False, initializer_multiscale=2),
    "no-initializer-odd": _cfg(RVN, learned_initializer=False),
}


@pytest.mark.parametrize("case", list(RVN_CASES))
def test_rvn_forward_matches_jax(case):
    cfg = RVN_CASES[case]
    h, w = (17, 13) if case.endswith("odd") or case == "input_image" else (H, W)
    y, sens, mask, _ = _data(b=B, c=C, h=h, w=w, seed=12)
    init = np.random.default_rng(13).standard_normal((B, h, w, 2)).astype(np.float32)
    v = _jax_vars(cfg, y, sens, mask, seed=1)
    want = _jax_predict(cfg, v, y, sens, mask, init)
    with torch.no_grad():
        got = _port(cfg, v)(*_t(y, sens, mask, init)).prediction
    assert got.shape == (B, h, w, 2) and got.dtype == torch.float32
    _close(got, want)


MDN_CASES = {
    "standardized": _cfg(MDN),
    "standardized-c-ortho-odd": _cfg(MDN, "c-ortho"),
    "plain-odd": _cfg(MDN, standardization=False),
}


@pytest.mark.parametrize("case", list(MDN_CASES))
def test_multidomainnet_forward_matches_jax(case):
    cfg = MDN_CASES[case]
    h, w = (17, 13) if case.endswith("odd") else (H, W)
    y, sens, mask, _ = _data(b=B, c=C, h=h, w=w, seed=14)
    v = _jax_vars(cfg, y, sens, mask, seed=2)
    want = _jax_predict(cfg, v, y, sens, mask)
    with torch.no_grad():
        got = _port(cfg, v)(*_t(y, sens, mask)).prediction
    assert got.shape == (B, h, w, 2)
    _close(got, want)


@pytest.mark.parametrize("cfg", [{"model_name": "CS", "cs_type": "l1_wavelet"},
                                 {"model_name": "CS", "cs_type": "total_variation", "fft_centered": True,
                                  "fft_normalization": "ortho"},
                                 {"model_name": "PICS", "reg_wt": 0.05}], ids=["cs", "cs-tv-c-ortho", "pics"])
def test_cs_models_match_jax_at_an_odd_size(cfg):
    cfg = {**cfg, "num_iters": 8}
    y, sens, mask, _ = _data(b=B, c=C, h=17, w=13, seed=15)
    want = _jax_predict(cfg, {}, y, sens, mask)
    with torch.no_grad():
        got = build_model(cfg, device="cpu")(*_t(y, sens, mask)).prediction
    _close(got, want)


@pytest.mark.parametrize("base", ["rvn", "mdn"])
def test_bf16_compute_matches_jax(base):
    cfg = _cfg(RVN if base == "rvn" else MDN, compute_dtype="bfloat16")
    y, sens, mask, _ = _data(b=B, c=C, h=H, w=W, seed=16)
    v = _jax_vars(cfg, y, sens, mask, seed=3)
    want = _jax_predict(cfg, v, y, sens, mask)
    with torch.no_grad():
        got = _port(cfg, v)(*_t(y, sens, mask)).prediction.numpy()
    assert got.dtype == np.float32
    assert z2._rel_l2(got, want) < BF16_REL_L2
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("cfg", [_cfg(RVN, "c-ortho"), _cfg(MDN)], ids=["rvn", "mdn"])
def test_loss_and_gradients_match_jax_grad(cfg):
    y, sens, mask, target = _data(b=B, c=C, h=H, w=W, seed=17)
    v = _jax_vars(cfg, y, sens, mask, seed=4)
    model = jax_build_model(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(JOut(prediction=out.prediction), jnp.asarray(target), "l1")

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}, cfg)
    m = _port(cfg, v)
    loss = process_reconstruction_loss(m(*_t(y, sens, mask), train=True), torch.from_numpy(target), "l1")
    loss.backward()
    _close(float(loss.detach()), float(want_loss))
    got = {k: p.grad for k, p in m.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k].numpy(), GRAD_RTOL, GRAD_ATOL)


def test_cs_trains_to_the_jax_loss_and_updates_nothing():
    """CS has no parameters: a ``Trainer`` step is the forward and the loss of
    the JAX trainer's step on its empty tree, with a gradient norm of 0."""
    cfg = {"model_name": "CS", "num_iters": 6, "fft_centered": True, "fft_normalization": "ortho"}
    y, sens, mask, target = _data(b=B, c=C, h=H, w=W, seed=18)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    optim = {"name": "adam", "lr": 1e-3}
    jt = JTrainer(jax_build_model(cfg), optim_cfg=optim, loss_type="l1", mesh=make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    want = jt.training_batch(batch)
    tt = Trainer(build_model(cfg, device="cpu"), optim_cfg=optim, loss_type="l1", device="cpu")
    got = tt.training_batch(batch)
    _close(float(got["loss"]), float(want["loss"]))
    assert float(got["grad_norm"]) == float(want["grad_norm"]) == 0.0
    assert tt.state.optimizer is None and not list(tt.model.parameters())


# ---- the weight carry, archives, building ----


@pytest.mark.parametrize("cfg", [_cfg(RVN), _cfg(RVN, no_parameter_sharing=False, initializer_multiscale=2),
                                 _cfg(MDN)], ids=["rvn", "rvn-shared", "mdn"])
def test_params_carry_every_leaf_both_ways(cfg):
    y, sens, mask, _ = _data(b=1, c=C, h=H, w=W, seed=19)
    v = _jax_vars(cfg, y, sens, mask)
    fn = rvn_params_from_jax if cfg["model_name"] == "RVN" else multidomainnet_params_from_jax
    state = fn(v, cfg)
    assert sorted(state) == sorted(build_model(cfg, device="cpu").state_dict())
    back = zoo2_params_to_jax(state, cfg)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, v, back))
    with pytest.raises(KeyError, match="not used"):
        fn({"params": {**v["params"], "extra": np.zeros(1)}}, cfg)
    with pytest.raises(KeyError, match="missing"):
        zoo2_params_to_jax({k: t for k, t in list(state.items())[1:]}, cfg)


@pytest.mark.parametrize("cfg", [_cfg(RVN), _cfg(MDN)], ids=["rvn", "mdn"])
def test_archives_restore_across_the_packages(cfg, tmp_path):
    """A port archive (the flax msgpack of the bare param tree) restores in
    ``mridc_tpu``, and ``mridc_tpu``'s in the port, both to the weights and
    predictions they were written from."""
    y, sens, mask, _ = _data(b=B, c=C, h=H, w=W, seed=20)
    v = _jax_vars(cfg, y, sens, mask, seed=5)
    model = _port(cfg, v)
    path = checkpoints.save_archive(tmp_path / "port.mridc", cfg, model.state_dict())
    jmodel, jparams, jcfg = jckpt.restore_model(path)
    assert jcfg == cfg
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, v["params"], jax.tree_util.tree_map(
        np.asarray, dict(jparams))))
    jpath = jckpt.save_archive(tmp_path / "jax.mridc", cfg, v["params"])
    back, state, got_cfg = checkpoints.restore_model(jpath, device="cpu")
    assert got_cfg == cfg and all(torch.equal(state[k], model.state_dict()[k]) for k in state)
    with torch.no_grad():
        got = back(*_t(y, sens, mask)).prediction
    _close(got, np.asarray(jax.jit(jmodel.apply)({"params": jparams}, y, sens, mask).prediction))


@pytest.mark.parametrize("name", ["RVN", "RecurrentVarNet", "MultiDomainNet", "MultiDomain", "CS", "PICS"])
def test_zoo3_builds_on_the_card_unless_told_otherwise(name, monkeypatch):
    assert name.upper() in available_models() and name.upper() not in PENDING_MODELS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model({"model_name": name})
    small = {"recurrent_hidden_channels": 4, "initializer_channels": [4, 4], "initializer_dilations": [1, 2],
             "num_filters": 4}
    assert build_model({"model_name": name, **small}, device="cpu") is not None


def test_weights_come_from_the_generator_alone():
    for cfg in (_cfg(RVN), _cfg(MDN)):
        torch.manual_seed(0)
        a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
        torch.manual_seed(1)
        b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_jointicnet_refusal_names_m8():
    """JointICNet, which raised naming M8 until M8's second half was ported,
    builds (held against mridc_tpu in ``test_torch_port_jointicnet.py``)."""
    model = build_model({"model_name": "JointICNet"}, device="cpu")
    assert type(model).__name__ == "JointICNet" and "JOINTICNET" not in PENDING_MODELS


# ---- chip_smoke.py's configurations and launch tables, on the CPU path ----


def _yaml_model(path):
    return launch.load_config(ROOT / "projects" / path)["model"]


@pytest.mark.parametrize("name", ["rvn", "multidomainnet", "cs", "cs_tv", "pics", "cs_unsup"])
def test_chip_smoke_zoo3_configs_are_the_yamls(name):
    cs = z2._chip_smoke()
    if name == "cs_unsup":
        model = _yaml_model("unselfsupervised/conf/base_cs_run.yaml")
        extra = {"dimensionality", "consecutive_slices", "log_images", "ssdu", "n2r", "kspace_reconstruction_loss",
                 "reconstruction_loss_regularization_factor"}
    else:
        model = _yaml_model(f"reconstruction/conf/base_{name.replace('_tv', '')}_train.yaml")
        if name == "cs_tv":
            model = {**model, "cs_type": "total_variation"}
        extra = {"sens_chans", "sens_pools", "sens_mask_type", "complex_data", "log_images", "train_loss_fn",
                 "val_loss_fn", "optim"}
        assert model["train_ds"]["batch_size"] == cs.ZOO3_TRAIN_BATCH == 1 and model["optim"] == cs.TRAIN_OPTIM
    cfg = {**cs.ZOO_COMMON, **cs.ZOO3_CFGS[name]}
    assert {k: model[k] for k in cfg} == cfg
    assert not {k for k in model if k not in cfg and not k.endswith("_ds")} - extra


def test_chip_smoke_zoo3_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.ZOO3_PER_FORWARD and ZOO3_PER_STEP derive the K2 launches of
    the four models' forwards and training steps; on the CPU path each K2
    Function and stage calls its plain version where the card launches its
    stages, so counting the stages those calls stand for must give the same
    tables. Widths are cut; RVN's steps and the solvers' iterations (which the
    tables scale with) are kept."""
    cs = z2._chip_smoke()
    counts = {}

    def count(name, symbols):
        orig = getattr(k2, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(k2, name, wrapped)

    def load(needed, fft_order):
        return ["k2_load"] if needed and not fft_order else []

    count("sens_expand_plain", lambda x, s, c=False, n="backward", fft_order=False, mask=None:
          ["k2_expand", *(["k2_mask"] if mask is not None else []), *load(c, fft_order)])
    count("sens_expand_bwd_plain", lambda g, s, c=False, n="backward", fft_order=False, mask=None:
          [*load(c or mask is not None, fft_order), "k2_reduce"])
    count("sens_reduce_plain", lambda k, s, m=None, c=False, *a, fft_order=False, **kw:
          [*load(c or m is not None, fft_order), "k2_reduce"])
    count("sens_reduce_bwd_plain", lambda g, s, m=None, c=False, n="backward", fft_order=False:
          ["k2_expand", *(["k2_mask"] if m is not None else []), *load(c, fft_order)])
    count("normal_op_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce"])
    count("reduce_plain", lambda *a, **kw: ["k2_reduce"])

    def count_k4(name, symbols):  # RVN's edge pads
        orig = getattr(k4, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(k4, name, wrapped)

    count_k4("edge_pad_plain", lambda x, *a: [k4.PAD_SYMBOLS[x.dtype]])
    count_k4("edge_pad_bwd_plain", lambda g, *a: [k4.PAD_BWD_SYMBOLS[g.dtype]])
    y, sens, mask, target = _data(b=1, c=3, h=16, w=16, seed=21)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    cut = {"recurrent_hidden_channels": 4, "initializer_channels": [4, 4, 8, 8], "num_filters": 4}
    for name, cfg in cs.ZOO3_CFGS.items():
        cfg = {**cs.ZOO_COMMON, **cfg, **{k: v for k, v in cut.items() if k in cfg}}
        model = build_model(cfg, device="cpu")
        counts.clear()
        with torch.no_grad():
            model(*_t(y, sens, mask))
        assert counts == cs.ZOO3_PER_FORWARD[name], name
        if f"train_{name}" in cs.ZOO3_PER_STEP:
            trainer = Trainer(model, optim_cfg=cs.TRAIN_OPTIM, device="cpu")
            counts.clear()
            trainer.training_batch(batch)
            assert counts == cs.ZOO3_PER_STEP[f"train_{name}"], name
