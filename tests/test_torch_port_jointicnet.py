"""Port parity: JointICNet against ``mridc_tpu``'s on the CPU, on a
non-square grid with a non-binary mask and a k-space that is nonzero off the
mask (so that update X's data term, ``F^-1(where(m == 0, 0, F(s x)) - y)``,
differs from K2's ``F^-1(m (F(s x) - y))`` and update C's ``where`` s differ
from a product with the mask): forward in both FFT conventions, the train
loss and every gradient against ``jax.grad``, three ``Trainer`` steps against
optax, the param mapping both ways bit for bit, archives both ways, both
``projects/`` YAMLs through ``python -m mridc_tpu_torch run -c`` against
``mridc_tpu.launch`` on fixture volumes, and chip_smoke.py's phase J tables
counted on the CPU path.

Inputs come from numpy seeds (2 coils, 16x20, U-Nets of 4 filters and 1-2
pools); weights by ``init`` of the JAX model. Forward and loss: rtol 2e-3 /
atol 2e-4 of the largest magnitude (``tests/test_torch_parity.py:131``);
gradients: elementwise at rtol 2e-3 / atol 1e-3 of each parameter's largest
magnitude (``tests/test_torch_port_zoo.py``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu import launch as jlaunch
from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import config as jconfig
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu.train.trainer import TrainState as JTrainState
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch import cli
from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.kernels import k3_indrnn as k3
from mridc_tpu_torch.kernels import k4_conv_epilogue as k4
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import params_from_jax, params_to_jax

import test_torch_port_launch as tl
from fixtures import create_dataset
from test_torch_port_sens import numpy_init

ROOT = Path(__file__).resolve().parent.parent
TRAIN_YAML = ROOT / "projects/reconstruction/conf/base_jointicnet_train.yaml"
RUN_YAML = ROOT / "projects/reconstruction/conf/base_jointicnet_run.yaml"
RTOL, ATOL = 2e-3, 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
B, C, H, W = 2, 2, 16, 20
CFG = {"model_name": "JointICNet", "num_iter": 2, "kspace_unet_num_filters": 4, "kspace_unet_num_pool_layers": 1,
       "imspace_unet_num_filters": 4, "imspace_unet_num_pool_layers": 2, "sens_unet_num_filters": 4,
       "sens_unet_num_pool_layers": 1}
CONVENTIONS = {"u-backward": (False, "backward"), "c-ortho": (True, "ortho")}
ICNET_SMALL = {k: v for k, v in CFG.items() if k.endswith(("filters", "layers"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _cfg(convention="u-backward", **kw):
    c, n = CONVENTIONS[convention]
    return {**CFG, "fft_centered": c, "fft_normalization": n, **kw}


def _data(seed=0):
    """k-space that is nonzero everywhere (y off the mask too), unit-RSS
    maps, a non-binary column mask with a binary centre (the ACS band the
    sens net reads), the target."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, H, W, 2)).astype(np.float32)
    sens = rng.standard_normal((B, C, H, W, 2)).astype(np.float32)
    sens /= np.sqrt((sens**2).sum(axis=(1, 4), keepdims=True))
    cols = (rng.random((B, W)) < 0.4) * rng.uniform(0.3, 0.9, (B, W))
    cols[:, W // 2 - 3: W // 2 + 3] = 1.0
    mask = np.broadcast_to(cols[:, None, None, :], (B, 1, H, W)).astype(np.float32).copy()
    target = rng.standard_normal((B, H, W)).astype(np.float32)
    return y, sens, mask, target


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_params(cfg, y, sens, mask, seed=0):
    params = numpy_init(jax_build_model(cfg), y, sens, mask, seed=seed)
    # small per-iteration weights, so that the updates stay contractive
    rng = np.random.default_rng(seed + 100)
    for k in ("reg_param_I", "reg_param_F", "reg_param_C", "lr_image", "lr_sens"):
        params[k] = rng.uniform(0.05, 0.3, params[k].shape).astype(np.float32)
    return params


def _port(cfg, params):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return model


def test_scopes_and_keys():
    """The JAX package's scopes, read off ``init``, and the port's modules."""
    y, sens, mask, _ = _data()
    params = _jax_params(_cfg(), y, sens, mask)
    assert set(params) == {"NormUnet_0", "NormUnet_1", "SensitivityModel_0", "reg_param_I", "reg_param_F",
                           "reg_param_C", "lr_image", "lr_sens"}
    assert params["reg_param_I"].shape == (2,)
    # NormUnet_0 is the k-space U-Net (1 pool), NormUnet_1 the image U-Net (2 pools)
    assert "TransposeConvBlock_1" not in params["NormUnet_0"]["Unet_0"]
    assert "TransposeConvBlock_1" in params["NormUnet_1"]["Unet_0"]
    model = build_model(_cfg(), device="cpu")
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "kspace_model", "image_model", "sens_net", "reg_param_I", "reg_param_F", "reg_param_C", "lr_image", "lr_sens"}
    assert all(k.startswith("sens_net.norm_unet.unet.") for k in model.state_dict() if k.startswith("sens_net"))


@pytest.mark.parametrize("convention", sorted(CONVENTIONS))
def test_forward_matches_jax(convention):
    cfg = _cfg(convention)
    y, sens, mask, _ = _data(seed=1)
    assert 0 < np.abs(mask - (mask > 0)).max() and np.abs(y * (mask == 0)[..., None]).max() > 0
    params = _jax_params(cfg, y, sens, mask, seed=2)
    want = jax_build_model(cfg).apply({"params": params}, *(jnp.asarray(a) for a in (y, sens, mask))).prediction
    model = _port(cfg, params)
    with torch.no_grad():
        _close(model(*_t(y, sens, mask)).prediction, want)
        # the dataset's maps are not read
        _close(model(*_t(y, np.zeros_like(sens), mask)).prediction, want)


@pytest.mark.parametrize("convention", sorted(CONVENTIONS))
def test_train_loss_and_gradients_match_jax_grad(convention):
    cfg = _cfg(convention)
    y, sens, mask, target = _data(seed=3)
    params = _jax_params(cfg, y, sens, mask, seed=4)
    jmodel = jax_build_model(cfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, *(jnp.asarray(a) for a in (y, sens, mask)), train=True)
        return jloss(out, jnp.asarray(target), "l1")

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), cfg)
    model = _port(cfg, params)
    loss = process_reconstruction_loss(model(*_t(y, sens, mask), train=True), torch.from_numpy(target), "l1")
    loss.backward()
    _close(float(loss.detach()), float(want_loss))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w_ in want.items():
        assert float(w_.abs().max()) > 0, k
        _close(got[k], w_.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
         "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}


def test_three_trainer_steps_give_optax_parameters():
    """Trainer under the YAML's Adam and InverseSquareRootAnnealing: every
    gradient runs through K2's Functions with the maps' gradient."""
    cfg = _cfg("c-ortho")
    y, sens, mask, target = _data(seed=5)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    params = _jax_params(cfg, y, sens, mask, seed=6)
    trainer_cfg = {"max_steps": 30}
    jt = JTrainer(jax_build_model(cfg), optim_cfg=OPTIM, trainer_cfg=trainer_cfg, loss_type="l1", mesh=make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    jt.state = JTrainState.create(params, jt._tx)
    want_losses = [float(jt.training_batch(batch)["loss"]) for _ in range(3)]
    model = _port(cfg, params)
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg=trainer_cfg, loss_type="l1", device="cpu")
    tt.setup_optimization()
    tt.init_state(batch)
    _close([float(tt.training_batch(batch)["loss"]) for _ in range(3)], want_losses)
    want_params = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), cfg)
    for k, p in model.named_parameters():
        _close(p, want_params[k].numpy())
    _close(tt.predict_batch(batch), np.asarray(jt.predict_batch(batch)))


def test_params_round_trip_bit_for_bit_and_archives_restore_both_ways(tmp_path):
    cfg = _cfg("c-ortho")
    y, sens, mask, _ = _data(seed=7)
    params = _jax_params(cfg, y, sens, mask, seed=8)
    back = params_to_jax(params_from_jax(params, cfg), cfg)["params"]
    flat = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(back))
    want_flat = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(params))
    assert sorted(flat) == sorted(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(flat[k], v)
    want = np.asarray(jax_build_model(cfg).apply({"params": params}, *(jnp.asarray(a) for a in (y, sens, mask)))
                      .prediction)
    path = checkpoints.save_archive(tmp_path / "port.mridc", cfg, _port(cfg, params).state_dict())
    _, jparams, _ = jckpt.restore_model(path)
    _close(jax_build_model(cfg).apply({"params": jparams}, *(jnp.asarray(a) for a in (y, sens, mask))).prediction,
           want)
    restored, _, _ = checkpoints.restore_model(jckpt.save_archive(tmp_path / "jax.mridc", cfg, params), device="cpu")
    with torch.no_grad():
        _close(restored(*_t(y, sens, mask)).prediction, want)


# ---- from the config files, against mridc_tpu.launch ----

SMALL = ["model.kspace_unet_num_filters=4", "model.kspace_unet_num_pool_layers=1",
         "model.imspace_unet_num_filters=4", "model.imspace_unet_num_pool_layers=1",
         "model.sens_unet_num_filters=4", "model.sens_unet_num_pool_layers=1", "trainer.max_epochs=1",
         "trainer.log_every_n_steps=1", "trainer.accelerator=cpu"]
# The YAMLs read uncentered k-space under an fftshifted mask; the sens net
# takes its ACS band from the centre of the mask's first row, which a shifted
# mask leaves unsampled: both packages then keep one empty k-space row, get
# all-zero maps, and the RSS normalisation's sqrt at 0 gives NaN gradients
# (ROADMAP section 3). The fixture volumes hold centered k-space, so the runs
# here read them centered, under unshifted masks.
_DS = ("train_ds", "validation_ds", "test_ds")
CENTERED = (["model.fft_centered=true"] + [f"model.{d}.fft_centered=true" for d in _DS]
            + [f"model.{d}.mask_args.shift_mask=false" for d in _DS])


def test_config_files_match_jax_and_each_archive_restores_in_the_other(tmp_path, monkeypatch):
    """``run -c base_jointicnet_train.yaml`` (2 steps at batch 1, 4 coils,
    16x16 fixture volumes) through ``cli.main`` and ``mridc_tpu.launch``,
    both from one ``pretrained: true`` archive of ``mridc_tpu``: per-step
    losses and validation metrics, finite; then ``base_jointicnet_run.yaml``
    (``mode: test``, ``pretrained: true``) of each package on the archive the
    other package's training wrote, against ``mridc_tpu``'s test of its own
    archive: the written reconstructions, finite (centered, ``CENTERED``)."""
    import h5py

    for split, n, seed in (("train", 2, 0), ("val", 1, 1), ("test", 1, 2)):
        create_dataset(tmp_path / split, n_files=n, slices=1, coils=4, h=16, w=16, seed=seed)
    data = [f"model.train_ds.data_path={tmp_path / 'train'}", f"model.validation_ds.data_path={tmp_path / 'val'}",
            f"model.test_ds.data_path={tmp_path / 'test'}"]
    cfg = jconfig.load_config(TRAIN_YAML, SMALL + CENTERED + data)
    y = np.zeros((1, 4, 16, 16, 2), np.float32)
    params = numpy_init(jax_build_model(cfg["model"]), y, np.ones_like(y), np.ones((1, 1, 16, 16), np.float32),
                        seed=3)
    for k in ("reg_param_I", "reg_param_F", "reg_param_C", "lr_image", "lr_sens"):
        params[k] = np.full(params[k].shape, 0.1, np.float32)
    archive = jckpt.save_archive(tmp_path / "jax_jointicnet.mridc", cfg["model"], params)
    common = SMALL + CENTERED + data + ["pretrained=true", f"checkpoint={archive}"]
    runs = {}
    for name, cls, run in (
        ("jax", JTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(TRAIN_YAML, o))),
        ("port", Trainer, lambda o: cli.main(["run", "-c", str(TRAIN_YAML), *o])),
    ):
        losses, vals = [], []
        with monkeypatch.context() as m:
            tl._recording(m, cls, losses, vals)
            run(common + [f"exp_manager.exp_dir={tmp_path / name}"])
        runs[name] = (losses, vals)
    (jl, jv), (pl, pv) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 2 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL * max(1.0, max(abs(v) for v in jl)))
    assert len(pv) == len(jv) and pv
    for p, j in zip(pv, jv):
        assert set(p) == set(j)
        for k in j:
            assert np.isfinite(j[k]), k
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=ATOL * max(1.0, abs(float(j[k]))), err_msg=k)

    trained = {name: next((tmp_path / name / "jointicnet").glob("*/jointicnet.mridc")) for name in ("jax", "port")}
    test = SMALL + CENTERED + data + ["pretrained=true"]
    jlaunch.run_from_config(jconfig.load_config(RUN_YAML, test + [f"checkpoint={trained['jax']}",
                                                                  f"exp_manager.exp_dir={tmp_path / 'jt_jax'}"]))
    jlaunch.run_from_config(jconfig.load_config(RUN_YAML, test + [f"checkpoint={trained['port']}",
                                                                  f"exp_manager.exp_dir={tmp_path / 'jt_port'}"]))
    cli.main(["run", "-c", str(RUN_YAML), *test, f"checkpoint={trained['jax']}",
              f"exp_manager.exp_dir={tmp_path / 'pt_jax'}"])
    recs = {}
    for side in ("jt_jax", "jt_port", "pt_jax"):
        (run_dir,) = (tmp_path / side / "jointicnet").iterdir()
        files = sorted((run_dir / "reconstructions").iterdir())
        assert files, side
        recs[side] = {f.name: h5py.File(f)["reconstruction"][()] for f in files}
    for side in ("jt_port", "pt_jax"):
        assert sorted(recs[side]) == sorted(recs["jt_jax"])
        for n, want in recs["jt_jax"].items():
            assert np.isfinite(want).all() and np.abs(want).max() > 0
            _close(recs[side][n], want)


def test_yamls_build_through_the_launcher():
    from mridc_tpu_torch import launch

    for path in (TRAIN_YAML, RUN_YAML):
        model_cfg = launch.load_config(path)["model"]
        assert launch._auto_dc_mode(dict(model_cfg)) == model_cfg and launch.model_task("JointICNet") == "reconstruction"
        assert type(build_model(model_cfg, device="cpu")).__name__ == "JointICNet"


# ---- chip_smoke.py's phase J, on the CPU path ----


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_j_configs_are_the_yamls():
    import yaml

    cs = _chip_smoke()
    for cfg, path in ((cs.J_TRAIN_CFG, TRAIN_YAML), (cs.J_RUN_CFG, RUN_YAML)):
        assert cfg == yaml.safe_load(path.read_text())
    model = yaml.safe_load(TRAIN_YAML.read_text())["model"]
    assert cs.J_ICNET_CFG == {k: v for k, v in model.items() if k not in ("train_ds", "validation_ds", "test_ds",
                                                                          "optim")}
    assert cs.J_OPTIM == model["optim"]
    j2 = cs.j_cirim_cfg()
    assert j2["use_sens_net"] and (j2["sens_chans"], j2["sens_pools"]) == (8, 4)
    assert {k: v for k, v in j2.items() if k not in ("use_sens_net", "sens_chans", "sens_pools")} == cs.flagship_cfg(
        stack_intermediates=False, compute_dtype=None)


def _counting(monkeypatch):
    """Count the kernel launches that the plain calls of the CPU path stand
    for on the card."""
    counts = {}

    def count(mod, name, symbols):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a, **kw):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    def load(c, fft_order, mask=None):
        return ["k2_load"] if (c or mask is not None) and not fft_order else []

    def args(names, a, kw):
        return {**dict(zip(names, a)), **kw}

    exp_names = ("x", "s", "c", "n", "fft_order", "mask")
    red_names = ("k", "s", "mask", "c", "n", "sd", "cd", "fft_order")
    count(k1, "psf1d_dc_plain", lambda e, s, *a, **kw: [k1.SYMBOLS[s.dtype]])
    count(k1, "psf1d_dc_bwd_plain", lambda g, s, *a, **kw: [k1.BWD_SYMBOLS[s.dtype]])
    count(k1, "psf1d_dc_sens_bwd_plain", lambda g, e, s, *a, **kw: [k1.SENS_SYMBOLS[s.dtype]])
    count(k3, "indrnn_plain", lambda x, *a, **kw: [k3.SYMBOLS[x.dtype]])
    count(k3, "indrnn_bwd_plain", lambda g, x, *a, **kw: [k3.BWD_SYMBOLS[x.dtype]])
    count(k4, "edge_pad_plain", lambda x, *a, **kw: [k4.PAD_SYMBOLS[x.dtype]])
    count(k4, "edge_pad_bwd_plain", lambda g, *a, **kw: [k4.PAD_BWD_SYMBOLS[g.dtype]])
    count(k4, "bias_act_plain", lambda y, *a, **kw: [k4.ACT_SYMBOLS[y.dtype]])
    count(k4, "bias_act_bwd_plain",
          lambda g, out, act, want_db: [k4.ACT_BWD_SYMBOLS[g.dtype]] if act or want_db else [])
    count(k2, "full_dc_plain", lambda *a, **kw: ["k2_expand", "k2_residual", "k2_reduce"])
    count(k2, "full_dc_bwd_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce_acc"])
    count(k2, "full_dc_bwd_sens_plain",
          lambda *a, **kw: ["k2_expand", "k2_residual", "k2_expand", "k2_mask", "k2_sens_grad"])

    def expand_fwd(*a, **kw):
        v = args(exp_names, a, kw)
        c, order, m = v.get("c", False), v.get("fft_order", False), v.get("mask")
        return ["k2_expand", *(["k2_mask"] if m is not None else []), *(["k2_load"] if c and not order else [])]

    count(k2, "sens_expand_plain", expand_fwd)
    count(k2, "sens_expand_bwd_plain", lambda g, s, c=False, n="backward", fft_order=False, mask=None:
          [*load(c, fft_order, mask), "k2_reduce"])
    count(k2, "sens_expand_bwd_sens_plain", lambda g, x, s, c=False, n="backward", fft_order=False, mask=None:
          [*load(c, fft_order, mask), "k2_sens_grad"])

    def reduce_fwd(*a, **kw):
        v = args(red_names, a, kw)
        return [*load(v.get("c", False), v.get("fft_order", False), v.get("mask")), "k2_reduce"]

    count(k2, "sens_reduce_plain", reduce_fwd)
    count(k2, "sens_reduce_bwd_plain", lambda g, s, m=None, c=False, n="backward", fft_order=False:
          ["k2_expand", *(["k2_mask"] if m is not None else []), *(["k2_load"] if c and not fft_order else [])])
    count(k2, "sens_reduce_bwd_sens_plain", lambda g, k, s, m=None, c=False, n="backward", fft_order=False:
          [*load(c, fft_order, m), "k2_sens_grad"])
    count(k2, "normal_op_plain", lambda *a, **kw: ["k2_expand", "k2_mask", "k2_reduce"])
    count(k2, "normal_op_bwd_sens_plain",
          lambda *a, **kw: ["k2_expand", "k2_mask", "k2_expand", "k2_mask", "k2_sens_grad"])
    count(k2, "_reorder", lambda *a: ["k2_load"])
    return counts


def test_chip_smoke_j_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.J_PER_FORWARD and J_PER_STEP derive the launches of phase
    J's serving and training runs (the flagship CIRIM with a sens net in
    three DC routes, JointICNet at its YAML's widths); the CPU path calls
    each Function's plain version where the card launches its stages, so
    counting the stages those calls stand for gives the same tables."""
    cs = _chip_smoke()
    counts = _counting(monkeypatch)
    rng = np.random.default_rng(0)
    hw = 16
    y = rng.standard_normal((1, 3, hw, hw, 2)).astype(np.float32)
    sens = rng.standard_normal((1, 3, hw, hw, 2)).astype(np.float32)
    cols = np.zeros(hw, np.float32)
    cols[::4] = 1
    cols[hw // 2 - 2: hw // 2 + 2] = 1
    mask = np.broadcast_to(cols, (1, 1, hw, hw)).copy()
    small = dict(conv_filters=[4, 4, 2], recurrent_filters=[4, 4, 0], sens_chans=4, sens_pools=1)
    for run, (kind, overrides) in cs.J_SERVE.items():
        cfg = cs.j_cirim_cfg(**overrides, **small) if kind == "cirim" else {**cs.J_ICNET_CFG, **ICNET_SMALL}
        model = build_model(cfg, device="cpu")
        counts.clear()
        with torch.no_grad():
            model(*_t(y, sens, mask))
        assert counts == cs.J_PER_FORWARD[run], run
    target = rng.standard_normal((1, hw, hw)).astype(np.float32)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    for run, (kind, overrides) in cs.J_TRAIN.items():
        cfg = cs.j_cirim_cfg(**overrides, **small) if kind == "cirim" else {**cs.J_ICNET_CFG, **ICNET_SMALL}
        trainer = Trainer(build_model(cfg, device="cpu"), optim_cfg=cs.J_OPTIM, trainer_cfg=cs.TRAIN_CFG,
                          device="cpu")
        counts.clear()
        trainer.training_batch(batch)
        assert counts == cs.J_PER_STEP[run], run
    # J4: the YAMLs' model blocks read centered (J_CENTERED), fed batches that
    # carry the transform's initial prediction
    batch["initial_prediction"] = rng.standard_normal((1, hw, hw, 2)).astype(np.float32)
    full = np.zeros_like(mask)
    full[..., ::3, ::2] = 1  # a 2D mask: the CIRIM's full DC
    launch_models = {"launch_j_jointicnet": {**cs.J_TRAIN_CFG["model"], **ICNET_SMALL},
                     "launch_j_cirim_sens": {**cs.LAUNCH_CFG["model"], "use_sens_net": True, **small}}
    for run, model_cfg in launch_models.items():
        cfg = {k: v for k, v in model_cfg.items() if k not in ("train_ds", "validation_ds", "test_ds", "optim")}
        trainer = Trainer(build_model({**cfg, "fft_centered": True}, device="cpu"), optim_cfg=cs.J_OPTIM,
                          trainer_cfg=cs.TRAIN_CFG, device="cpu")
        counts.clear()
        trainer.training_batch({**batch, "mask": full})
        assert counts == cs.J_LAUNCH_PER_STEP[run], run
    assert any("shift_mask=false" in o for o in cs.J_CENTERED) and "model.fft_centered=true" in cs.J_CENTERED
