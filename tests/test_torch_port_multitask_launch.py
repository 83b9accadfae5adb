"""Port parity: the multitask task of mridc_tpu_torch against mridc_tpu's on
the CPU: ``RSMRIDataset``, ``RSMRIDataTransforms`` and ``RSBatchLoader`` bit
for bit on h5 fixture volumes with labels (``tests/fixtures.py``),
``MultitaskTrainer`` (three steps and ``validate``), ``python -m
mridc_tpu_torch run -c base_mtlrs_train.yaml`` against ``mridc_tpu.launch``,
the repaired ``mode: test`` beside the JAX package's failure, the 14
multitask YAMLs and every ``projects/`` YAML through the launcher, and the
entry points' refusal to run on the CPU unasked.

Models are cut to 4-8 channels, 2 pools and MTLRS to 2 blocks x 2 steps at
32x32 and 2 coils; losses and metrics at rtol 2e-3 / atol 2e-4 of the
largest magnitude, each parameter's update over three SGD steps at relative
l2 1e-2 (``test_torch_port_multitask.py``); data bit for bit. The JAX
trainer's state is made from ``jax.eval_shape`` of its model's init (a
test-side stand-in for flax's eager init; the weights are then replaced by
the archive's or the test's).
"""

import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu import launch as jlaunch
from mridc_tpu.data import seg_pipeline as jsp
from mridc_tpu.data import task_loaders as jtl
from mridc_tpu.data.factory import transform_kwargs as jtransform_kwargs
from mridc_tpu.metrics import segmentation as jmetrics
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import config as jconfig
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu.train.trainer import TrainState
from mridc_tpu_torch import cli, launch
from mridc_tpu_torch.data import seg_pipeline as tsp
from mridc_tpu_torch.data import task_loaders as ttl
from mridc_tpu_torch.data.factory import transform_kwargs
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train import task_trainers as ttt
from mridc_tpu_torch.utils.params import zoo2_params_from_jax, zoo2_params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_port_multitask as m1  # noqa: E402
from fixtures import create_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "projects" / "multitask" / "conf"
YAMLS = sorted(p.stem for p in CONF.glob("*.yaml"))
MTLRS_TRAIN, MTLRS_RUN = CONF / "base_mtlrs_train.yaml", CONF / "base_mtlrs_run.yaml"
SMALL = ["model.joint_reconstruction_segmentation_module_cascades=2", "model.reconstruction_module_time_steps=2",
         "model.reconstruction_module_conv_filters=[8,8,2]", "model.reconstruction_module_recurrent_filters=[8,8,0]",
         "model.segmentation_module_channels=4", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
         "trainer.accelerator=cpu", "exp_manager.create_tensorboard_logger=false"]
# the loaders of the trainer and batch tests draw equispaced 1D masks: the
# YAMLs' pure-Python poisson2d masker takes seconds a 32x32 slice
EQUISPACED = {"type": "equispaced1d", "accelerations": [4], "center_fractions": [0.08], "use_seed": True}
_close = m1._close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mtroot(tmp_path_factory):
    """Fixture volumes with 2-class labels ([S, C, H, W] one-hot), 32x32, 2
    coils with maps: 2 training volumes of 2 slices and another of 2, 1
    validation volume of 2, and a volume without labels."""
    root = tmp_path_factory.mktemp("mt")
    create_dataset(root / "train", n_files=2, slices=2, coils=2, h=32, w=32, with_segmentation=True)
    create_dataset(root / "train1", n_files=1, slices=2, coils=2, h=32, w=32, with_segmentation=True, seed=3)
    create_dataset(root / "val", n_files=1, slices=2, coils=2, h=32, w=32, with_segmentation=True, seed=1)
    create_dataset(root / "nolabels", n_files=1, slices=1, coils=2, h=32, w=32, seed=2)
    return root


def _fast_jax_init(monkeypatch):
    """The JAX trainer's state from ``jax.eval_shape`` of its model's init
    (zeros in the tree's shapes) instead of flax's eager init; every caller
    replaces the weights."""

    def init_state(self, rng, sample_batch):
        y, sens, mask, init_pred = self._model_inputs(sample_batch)
        shapes = jax.eval_shape(self.model.init, rng, y, sens, mask, init_pred)
        variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), dict(shapes))
        if self._tx is None:
            self.setup_optimization()
        self.state = TrainState.create(variables["params"], self._tx, ema=self.use_ema,
                                       batch_stats=variables.get("batch_stats"))
        return self.state

    monkeypatch.setattr(jtt.MultitaskTrainer, "init_state", init_state)


def _ds_cfg(root, **kw):
    ds = dict(jconfig.load_config(MTLRS_TRAIN)["model"]["train_ds"])
    ds.update({"data_path": str(root), "batch_size": 2, **kw})
    return ds


DS_CASES = {
    "yaml_poisson2d": {},
    "equispaced1d_centered_ortho": dict(mask_args=EQUISPACED, fft_centered=True, fft_normalization="ortho",
                                        normalize_inputs=False),
}


# ---- data ----


@pytest.mark.parametrize("case", list(DS_CASES))
def test_dataset_and_transform_are_bit_identical(mtroot, case):
    """``RSMRIDataset`` + ``RSMRIDataTransforms`` (every transform knob of the
    config through ``transform_kwargs``) against the JAX package's on each
    slice: the reconstruction 10-tuple and the one-hot labels bit for bit."""
    ds_cfg, model_cfg = _ds_cfg(mtroot / "train", **DS_CASES[case]), {"segmentation_module_output_channels": 2}
    want = jtl.RSMRIDataset(root=mtroot / "train", transform=jsp.RSMRIDataTransforms(
        output_classes=2, **jtransform_kwargs(ds_cfg, model_cfg)))
    got = ttl.RSMRIDataset(root=mtroot / "train", transform=tsp.RSMRIDataTransforms(
        output_classes=2, **transform_kwargs(ds_cfg, model_cfg)))
    assert len(got) == len(want) == 4
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert len(a) == len(b) == 11
        for x, y in zip(a, b):
            if isinstance(y, (list, tuple)):
                for xi, yi in zip(x, y):
                    np.testing.assert_array_equal(np.asarray(xi), np.asarray(yi))
            elif isinstance(y, np.ndarray):
                assert np.asarray(x).dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            elif not isinstance(y, dict):
                assert x == y
        assert a[-1].shape == (32, 32, 2)


def test_raw_samples_and_a_separate_labels_root_are_bit_identical(mtroot):
    """The dataset's raw tuples (k-space, maps, mask, target, labels, attrs,
    name, slice) with the labels read from the volumes and from
    ``segmentations_root``; a volume without labels gives empty ones."""
    for root, kw in ((mtroot / "val", {}), (mtroot / "val", {"segmentations_root": mtroot / "val"}),
                     (mtroot / "nolabels", {})):
        want, got = jtl.RSMRIDataset(root=root, **kw), ttl.RSMRIDataset(root=root, **kw)
        for i in range(len(want)):
            for a, b in zip(got[i], want[i]):
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                elif isinstance(b, dict):
                    assert a.keys() == b.keys()
                else:
                    assert a == b


def _loader(root, model_cfg, shuffle=False, batch=2, **kw):
    ds_cfg = _ds_cfg(root, batch_size=batch, mask_args=EQUISPACED, **kw)
    return launch._build_task_loader("multitask", ds_cfg, model_cfg, shuffle, "cpu")


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_are_bit_identical(mtroot, workers):
    """``RSBatchLoader`` through each launcher's loader factory: two shuffled
    epochs at batch 3 (the last batch short) on 0 and 2 worker threads,
    every array leaf and the labels padded to the target's shape."""
    model_cfg = {"segmentation_module_output_channels": 2}
    ds_cfg = _ds_cfg(mtroot / "train", batch_size=3, num_workers=workers, mask_args=EQUISPACED)
    want = jlaunch._build_task_loader("multitask", ds_cfg, model_cfg, True)
    got = launch._build_task_loader("multitask", ds_cfg, model_cfg, True, "cpu")
    assert len(got) == len(want) == 2
    for _ in range(2):
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and list(a["fname"]) == list(b["fname"])
            for k, v in b.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(np.asarray(a[k]), v)
            assert a["segmentation"].shape == a["target"].shape[:-1] + (2,)


def test_missing_labels_raise(mtroot):
    """A batch with a sample without labels raises, naming the fix."""
    with pytest.raises(ValueError, match="segmentations_path"):
        next(iter(_loader(mtroot / "nolabels", {"segmentation_module_output_channels": 2}, batch=1)))


# ---- the trainer ----


@pytest.mark.parametrize("name", ["mtlrs", "segnet"])
def test_trainer_steps_and_validate_match_jax(mtroot, name, monkeypatch):
    """Three ``MultitaskTrainer`` SGD steps (the YAMLs' loss: l1 plus
    detached CE and Dice, weights 0.7 / 0.6) against the JAX trainer:
    ``loss``, ``recon_loss``, ``seg_loss`` and ``grad_norm``, each
    parameter's update over the three steps at relative l2 1e-2; then
    ``validate()``'s ``val_loss``, ``val_SSIM`` and ``val_DICE``. SegNet
    trains on its stack of segmentations. SGD, as ``ROADMAP.md`` §1 has
    such runs compared."""
    _fast_jax_init(monkeypatch)
    cfg = dict(m1.MODELS[name])
    loss_cfg = ttt.seg_loss_cfg_from_model_cfg(jconfig.load_config(MTLRS_TRAIN)["model"])
    kw = dict(optim_cfg={"name": "sgd", "lr": 0.05}, seg_loss_cfg=loss_cfg, segmentation_loss_weight=0.6,
              reconstruction_loss_weight=0.7)
    batch = next(iter(_loader(mtroot / "train", cfg)))
    data = tuple(np.asarray(batch[k]) for k in ("masked_kspace", "sensitivity_maps", "mask")) + (None,)
    v = m1.jax_vars(cfg, data, seed=5)
    jt = jtt.MultitaskTrainer(m1._jm(m1._key(cfg)), **kw)
    jt.init_state(jax.random.PRNGKey(0), batch)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(params=params, opt_state=jt._tx.init(params))
    tt = ttt.MultitaskTrainer(m1.port(cfg, v), device="cpu", **kw)
    before = {k: p.detach().clone() for k, p in tt.model.state_dict().items()}
    for _ in range(3):
        want, got = jt.training_batch(batch), tt.training_batch(batch)
        assert sorted(got) == sorted(want) == ["grad_norm", "loss", "recon_loss", "seg_loss"]
        for k in want:
            _close(float(got[k]), float(want[k]))
    after = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jt.state.params)}, cfg)
    roundoff = 1e-6 * max(float((after[k] - before[k]).abs().max()) for k in after)
    for k, p in tt.model.state_dict().items():
        step, want_step = (p - before[k]).numpy(), (after[k] - before[k]).numpy()
        if float(np.abs(want_step).max()) <= roundoff:
            assert float(np.abs(step).max()) <= roundoff, k
        else:
            assert m1._rel_l2(step, want_step) < m1.GRAD_REL_L2, (k, m1._rel_l2(step, want_step))
    val = _loader(mtroot / "val", cfg)
    want_val, got_val = jt.validate(val), tt.validate(val)
    assert sorted(got_val) == sorted(want_val) == ["val_DICE", "val_SSIM", "val_loss"]
    for k in want_val:
        _close(got_val[k], want_val[k])
    pred, seg = tt.predict_batch(batch)
    assert pred.shape == (2, 32, 32, 2) and seg.shape == (2, 32, 32, 2)


def test_init_state_builds_a_coil_width_model_at_the_batch(mtroot):
    """SERANet's and IDSLR's modules are built by ``init_state`` at the first
    batch's coils (2 here: IDSLR's encoder 4 channels wide, SERANet's gate 4
    = 2 x its two segmentation input channels)."""
    for name, width in (("idslr", 4), ("seranet", 4)):
        model = build_model(m1.MODELS[name], device="cpu")
        trainer = ttt.MultitaskTrainer(model, device="cpu")
        trainer.init_state(next(iter(_loader(mtroot / "val", m1.MODELS[name], batch=1))))
        assert model.materialized and model.width == width
        assert model.state_dict()[model.width_key].shape[1] == width


# ---- the launcher ----


def _recording(monkeypatch, cls, losses, vals):
    step, validate = cls.training_batch, cls.validate

    def training_batch(self, batch):
        out = step(self, batch)
        losses.append({k: float(out[k]) for k in ("loss", "recon_loss", "seg_loss")})
        return out

    def val(self, *a, **kw):
        out = validate(self, *a, **kw)
        vals.append(dict(out))
        return out

    monkeypatch.setattr(cls, "training_batch", training_batch)
    monkeypatch.setattr(cls, "validate", val)


def test_config_run_matches_jax_and_its_archive_restores_in_jax(mtroot, monkeypatch):
    """``python -m mridc_tpu_torch run -c base_mtlrs_train.yaml`` (cut to 2
    blocks x 2 steps, 8 filters, 4 segmentation channels) against
    ``mridc_tpu.launch`` from one JAX archive: per-step ``loss``,
    ``recon_loss`` and ``seg_loss`` and the initial and final validations;
    the port's archive restores in ``mridc_tpu`` to the port's weights."""
    _fast_jax_init(monkeypatch)
    data = [f"model.train_ds.data_path={mtroot / 'train1'}", f"model.validation_ds.data_path={mtroot / 'val'}"]
    cfg = jconfig.load_config(MTLRS_TRAIN, SMALL + data)
    v = m1.jax_vars(cfg["model"], m1._data(), seed=7)
    archive = jckpt.save_archive(mtroot / "jmtlrs.mridc", cfg["model"], v["params"])
    common = SMALL + data + ["pretrained=true", f"checkpoint={archive}"]
    runs = {}
    for name, cls, run in (
        ("jax", jtt.MultitaskTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(MTLRS_TRAIN, o))),
        ("port", ttt.MultitaskTrainer, lambda o: cli.main(["run", "-c", str(MTLRS_TRAIN), *o])),
    ):
        losses, vals = [], []
        with monkeypatch.context() as m:
            _recording(m, cls, losses, vals)
            run(common + [f"exp_manager.exp_dir={mtroot / 'exp' / name}"])
        runs[name] = (losses, vals)
    (jl, jv), (pl, pv) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 2
    for p, j in zip(pl, jl):
        for k in j:
            _close(p[k], j[k])
    assert len(pv) == len(jv) == 2
    for p, j in zip(pv, jv):
        assert sorted(p) == sorted(j) == ["val_DICE", "val_SSIM", "val_loss"]
        for k in j:
            _close(p[k], j[k])
    (run_dir,) = (mtroot / "exp" / "port" / "mtlrs").iterdir()
    trained = run_dir / "mtlrs.mridc"
    _, jparams, jcfg = jckpt.restore_model(trained)
    assert jcfg["model_name"] == "MTLRS"
    model, _, _ = checkpoints.restore_model(trained, device="cpu")
    back = zoo2_params_to_jax(model.state_dict(), jcfg)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_mode_test_writes_recon_classes_and_metrics_where_jax_raises(mtroot, monkeypatch):
    """``mode: test`` of base_mtlrs_run.yaml on one archive (seeded masks):
    the JAX launcher's inherited ``Trainer.test`` indexes the (prediction,
    segmentation) pair as the batch of predictions and its SSIM raises
    (``ValueError``); the port writes each volume's ``reconstruction`` [S,
    H, W] and ``segmentation`` classes [S, H, W, 2] and logs SSIM, PSNR,
    NMSE, MSE, DICE, IOU, F1 and HD95, equal to the metrics of the trainer's
    own predictions."""
    _fast_jax_init(monkeypatch)
    overrides = SMALL + ["model.test_ds.mask_args.use_seed=true", "model.test_ds.use_seed=true",
                         f"model.test_ds.data_path={mtroot / 'val'}"]
    cfg = jconfig.load_config(MTLRS_RUN, overrides)
    v = m1.jax_vars(cfg["model"], m1._data(), seed=8)
    archive = jckpt.save_archive(mtroot / "jrun.mridc", cfg["model"], v["params"])
    overrides += [f"checkpoint={archive}"]
    with pytest.raises(ValueError, match="dimensions"):
        jlaunch.run_from_config(jconfig.load_config(MTLRS_RUN, overrides + [f"exp_manager.exp_dir={mtroot / 'jt'}"]))
    trainer, means = launch.run_from_config(jconfig.load_config(
        MTLRS_RUN, overrides + ["trainer.accelerator=cpu", f"exp_manager.exp_dir={mtroot / 'pt'}"]))
    assert sorted(means) == ["DICE", "F1", "HD95", "IOU", "MSE", "NMSE", "PSNR", "SSIM"]
    (test_dir,) = (mtroot / "pt" / "mtlrs").iterdir()
    (written,) = (test_dir / "reconstructions").iterdir()
    with h5py.File(written, "r") as f:
        recon, classes = f["reconstruction"][()], f["segmentation"][()]
    assert recon.shape == (2, 32, 32) and float(recon.max()) == 1.0
    assert classes.shape == (2, 32, 32, 2) and (classes.sum(-1) == 1).all()
    loader = launch._build_task_loader("multitask", cfg["model"]["test_ds"], cfg["model"], False, "cpu")
    batches = list(loader)
    preds = np.concatenate([ttt._seg_pred_classes(trainer.predict_batch(b)[1]) for b in batches])
    np.testing.assert_array_equal(classes, preds)
    labels = np.concatenate([b["segmentation"] for b in batches])
    want = jmetrics.SegmentationMetrics()(np.moveaxis(labels, -1, 0), np.moveaxis(preds, -1, 0))
    for k in want:
        _close(means[k], want[k])


@pytest.mark.parametrize("name", YAMLS)
def test_multitask_yamls_build_through_the_launcher(name):
    """Each projects/multitask/conf YAML's model block: ``_auto_dc_mode`` and
    ``model_task`` as the JAX launcher's, its model built (at 2 coils where
    its widths follow them) at the YAML's widths."""
    model = jconfig.load_config(CONF / f"{name}.yaml")["model"]
    cfg = launch._auto_dc_mode(dict(model))
    assert cfg == jlaunch._auto_dc_mode(dict(model))
    assert launch.model_task(model["model_name"]) == jlaunch.model_task(model["model_name"]) == "multitask"
    built = build_model(cfg, device="cpu")
    if not getattr(built, "materialized", True):
        built.materialize(2)
    assert sum(p.numel() for p in built.parameters()) > 0


def test_every_project_yaml_but_jointicnets_builds():
    """All 87 ``projects/`` YAMLs build through ``_auto_dc_mode`` and
    ``build_model`` on the CPU (JointICNet's 2, which raised naming M8 until
    it was ported, included)."""
    built = []
    for path in sorted((ROOT / "projects").glob("*/conf/*.yaml")):
        model = jconfig.load_config(path).get("model") or {}
        build_model(launch._auto_dc_mode(dict(model)), device="cpu")
        built.append(path.stem)
    assert len(built) == 87 and {"base_jointicnet_train", "base_jointicnet_run"} <= set(built)


def test_multitask_entry_points_run_on_the_card_unless_asked(monkeypatch, mtroot):
    """Without a card, the model build, the trainer and a multitask run raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = m1.MODELS["mtlrs"]
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttt.MultitaskTrainer(build_model(cfg, device="cpu"))
    run = jconfig.load_config(MTLRS_TRAIN, [f"model.train_ds.data_path={mtroot / 'train'}",
                                            f"exp_manager.exp_dir={mtroot / 'nocard'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_from_config(run)


# ---- chip_smoke's phase M ----


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", sorted(_chip_smoke().M_CFGS))
def test_chip_smoke_m_models_are_the_yamls(name):
    """Phase M's model configs are the train YAMLs' model keys (the data
    blocks and the keys every multitask YAML shares aside), and its
    config-file runs are the MTLRS and SERANet YAMLs as written."""
    cs = _chip_smoke()
    yaml = jconfig.load_config(CONF / f"base_{name}_train.yaml")
    shared = cs._q_cfg("x", {}, "train")["model"]
    assert {k: v for k, v in yaml["model"].items() if k not in shared or v != shared[k]} == cs.M_CFGS[name]
    assert cs._q_cfg(yaml["exp_manager"]["name"], cs.M_CFGS[name], "train") == yaml
    assert cs._q_cfg(yaml["exp_manager"]["name"], cs.M_CFGS[name], "test") == jconfig.load_config(
        CONF / f"base_{name}_run.yaml")


def test_chip_smoke_m_launch_configs_are_the_yamls():
    cs = _chip_smoke()
    for attr, yaml in (("M_TRAIN_CFG", "base_mtlrs_train"), ("M_RUN_CFG", "base_mtlrs_run"),
                       ("SERANET_TRAIN_CFG", "base_seranet_train"), ("SERANET_RUN_CFG", "base_seranet_run")):
        assert getattr(cs, attr) == jconfig.load_config(CONF / f"{yaml}.yaml"), attr


def test_chip_smoke_m_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.M_PER_FORWARD, M_PER_STEP and m_fed_per_step derive phase
    M's K1, K2 and K3 launches (the YAMLs' depths: 5 blocks x 8 steps;
    uncentered FFTs); counted on the CPU path with the widths cut to 8
    filters and 4 channels at 32x32 and 2 coils."""
    from mridc_tpu_torch.kernels import k1_psf1d_dc as k1

    import test_torch_port_qcirim as q1

    cs = _chip_smoke()
    counts = q1._counting(monkeypatch)
    for name, sym in (("psf1d_dc_plain", lambda e, *a, **k: [k1.SYMBOLS[e.dtype]]),
                      ("psf1d_dc_bwd_plain", lambda g, *a, **k: [k1.BWD_SYMBOLS[g.dtype]])):
        orig = getattr(k1, name)

        def wrapped(*a, _orig=orig, _sym=sym, **kw):
            for s in _sym(*a, **kw):
                counts[s] = counts.get(s, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(k1, name, wrapped)
    cut = {"reconstruction_module_conv_filters": [8, 8, 2], "reconstruction_module_recurrent_filters": [8, 8, 0],
           "segmentation_module_channels": 4, "reconstruction_module_channels": 4}

    def model(name, overrides=None):
        m = build_model({**cs.M_CFGS[name], **cut, **(overrides or {})}, device="cpu")
        if not getattr(m, "materialized", True):
            m.materialize(2)
        return m

    for run, (name, overrides, psf1d) in cs.M_SERVE.items():
        data = m1._data({"psf1d": psf1d})
        counts.clear()
        with torch.no_grad():
            model(name, overrides)(*m1._torch_inputs(data))
        assert counts == cs.M_PER_FORWARD[run], run
    data = m1._data()
    batch = {"masked_kspace": data[0][:1], "sensitivity_maps": data[1][:1], "mask": data[2][:1],
             "target": np.abs(data[0][:1, 0, ..., 0]), "segmentation": np.eye(2, dtype=np.float32)[
                 np.random.default_rng(0).integers(0, 2, (1, 32, 32))]}
    for run, (name, b, table) in cs.M_TRAIN.items():
        if b != 1:
            continue  # the B=1 runs' counts (the tables do not depend on the batch)
        trainer = ttt.MultitaskTrainer(model(name), optim_cfg=cs.TRAIN_OPTIM, seg_loss_cfg=cs.m_loss_cfg(),
                                       device="cpu")
        trainer.init_state(batch)
        counts.clear()
        trainer.training_batch(batch)
        assert counts == cs.M_PER_STEP[table], run
        counts.clear()
        trainer.training_batch({**batch, "initial_prediction": data[3] if data[3] is not None else
                                np.ones((1, 32, 32, 2), np.float32)})
        assert counts == cs.m_fed_per_step(table), run
