"""Port parity: the segmentation task of mridc_tpu_torch against mridc_tpu's
on the CPU: the transform, the dataset and the batcher bit for bit on h5
fixture volumes with labels (``tests/fixtures.py``), ``SegmentationTrainer``
(three steps and ``validate``, live BatchNorm too), ``python -m
mridc_tpu_torch run -c`` of a segmentation YAML against ``mridc_tpu.launch``,
the repaired ``mode: test`` and 5-slice lambda config beside the JAX
package's failures, every segmentation YAML through the launcher, and the
``.mridc`` archives of each model both ways.

Models are cut to 4-8 channels and 2 pools at 32x32; losses and metrics at
rtol 2e-3 / atol 2e-4 of the largest magnitude; data and weights bit for bit.
The JAX trainer's state is made from ``jax.eval_shape`` of its model's init
(a test-side stand-in for flax's eager init, which takes tens of seconds on
the CPU; the weights are then replaced by the archive's or the test's).
"""

import json
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
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import config as jconfig
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu.train.trainer import TrainState
from mridc_tpu_torch import cli, launch
from mridc_tpu_torch.data import seg_pipeline as tsp
from mridc_tpu_torch.data import task_loaders as ttl
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train import task_trainers as ttt
from mridc_tpu_torch.utils.params import zoo2_params_from_jax, zoo2_params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_port_seg as s1  # noqa: E402
from fixtures import create_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "projects" / "segmentation" / "conf"
YAMLS = sorted(p.stem for p in CONF.glob("*.yaml"))
UNET_TRAIN, UNET_RUN = CONF / "base_segmentation_unet_train.yaml", CONF / "base_segmentation_unet_run.yaml"
LAMBDA5 = CONF / "base_segmentation_lambda_unet3d_train.yaml"
SMALL = ["model.segmentation_module_channels=4", "model.segmentation_module_pooling_layers=2",
         "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "trainer.accelerator=cpu",
         "exp_manager.create_tensorboard_logger=false"]
_close = s1._close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def segroot(tmp_path_factory):
    """Fixture volumes with 2-class labels ([S, C, H, W] one-hot): 2 training
    volumes of 3 slices, 1 validation volume of 2, and 5-slice volumes for the
    consecutive-slice config (32x32, 4 coils, with maps; the validation volume
    also with a ``reconstruction`` image)."""
    root = tmp_path_factory.mktemp("seg")
    create_dataset(root / "train", n_files=2, slices=3, coils=4, h=32, w=32, with_segmentation=True)
    create_dataset(root / "val", n_files=1, slices=2, coils=4, h=32, w=32, with_segmentation=True, seed=1)
    with h5py.File(root / "val" / "file_0.h5", "a") as f:  # the image a dataset without complex data reads
        f.create_dataset("reconstruction", data=f["reconstruction_rss"][()])
    create_dataset(root / "five", n_files=1, slices=6, coils=4, h=32, w=32, with_segmentation=True, seed=2)
    create_dataset(root / "five_val", n_files=1, slices=5, coils=4, h=32, w=32, with_segmentation=True, seed=3)
    create_dataset(root / "labels3", n_files=1, slices=2, coils=4, h=32, w=32, with_segmentation=True, seed=4,
                   classes=3)
    return root


def _fast_jax_init(monkeypatch):
    """The JAX trainer's state from ``jax.eval_shape`` of its model's init
    (zeros in the tree's shapes) instead of flax's eager init; every caller
    replaces the weights."""

    def init_state(self, rng, sample_batch):
        shapes = jax.eval_shape(self.model.init, rng, jnp.asarray(sample_batch["image"]))
        variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), dict(shapes))
        if self._tx is None:
            self.setup_optimization()
        self.state = TrainState.create(variables["params"], self._tx, ema=self.use_ema,
                                       batch_stats=variables.get("batch_stats"))
        return self.state

    monkeypatch.setattr(jtt.SegmentationTrainer, "init_state", init_state)


# ---- data ----


TRANSFORMS = {
    "sense_magnitude": dict(coil_combination_method="SENSE", output_classes=2),
    "rss_magnitude": dict(coil_combination_method="RSS", output_classes=None),
    "sense_complex": dict(coil_combination_method="SENSE", magnitude_input=False, input_channels=2,
                          output_classes=2),
    "centered_ortho": dict(coil_combination_method="SENSE", fft_centered=True, fft_normalization="ortho",
                           normalize_inputs=False, output_classes=2),
}


@pytest.mark.parametrize("case", list(TRANSFORMS))
def test_dataset_and_transform_are_bit_identical(segroot, case):
    """``SegmentationMRIDataset`` + ``SegmentationDataTransforms`` against the
    JAX package's on each slice: image and one-hot labels bit for bit."""
    kw = TRANSFORMS[case]
    want = jtl.SegmentationMRIDataset(root=segroot / "train", transform=jsp.SegmentationDataTransforms(**kw))
    got = ttl.SegmentationMRIDataset(root=segroot / "train", transform=tsp.SegmentationDataTransforms(**kw))
    assert len(got) == len(want) == 6
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a["fname"] == b["fname"] and a["slice_idx"] == b["slice_idx"]
        for k in ("image", "segmentation"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_raw_samples_and_a_separate_labels_root_are_bit_identical(segroot):
    """The dataset's raw tuples (k-space, maps, mask, image, labels, attrs)
    with the labels read from the volumes and from ``segmentations_root``;
    and without complex data (the ``reconstruction`` image)."""
    for kw in ({}, {"segmentations_root": segroot / "val"}, {"complex_data": False}):
        want = jtl.SegmentationMRIDataset(root=segroot / "val", **kw)
        got = ttl.SegmentationMRIDataset(root=segroot / "val", **kw)
        for i in range(len(want)):
            for a, b in zip(got[i], want[i]):
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                elif isinstance(a, dict):
                    assert a.keys() == b.keys()
                else:
                    assert a == b


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_are_bit_identical(segroot, workers):
    """``SegBatchLoader`` against the JAX package's: two shuffled epochs at
    batch 4 (the last batch short), on 0 and 2 worker threads."""
    tfm = dict(coil_combination_method="SENSE", output_classes=2)
    want = jsp.SegBatchLoader(jtl.SegmentationMRIDataset(root=segroot / "train",
                                                         transform=jsp.SegmentationDataTransforms(**tfm)),
                              batch_size=4, shuffle=True, seed=3, num_workers=workers)
    got = tsp.SegBatchLoader(ttl.SegmentationMRIDataset(root=segroot / "train",
                                                        transform=tsp.SegmentationDataTransforms(**tfm)),
                             batch_size=4, shuffle=True, seed=3, num_workers=workers)
    assert len(got) == len(want) == 2
    for _ in range(2):
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and a["fname"] == b["fname"]
            for k in ("image", "segmentation", "slice_idx"):
                np.testing.assert_array_equal(a[k], b[k])


def test_labels_of_consecutive_slices_stay_per_slice(segroot):
    """A 5-slice window of one-hot labels [S, C, H, W]: the JAX package's
    ``_to_onehot`` reads it as integer labels ([S, C, H, W, C]); the port's
    gives [S, H, W, C], each slice's labels as the single-slice sample has
    them. Three classes as integer labels are expanded alike."""
    with h5py.File(segroot / "five" / "file_0.h5") as f:
        seg = f["segmentation"][0:5]
    assert jsp._to_onehot(seg, 2).shape == (5, 2, 32, 32, 2)
    got = tsp._to_onehot(seg, 2)
    assert got.shape == (5, 32, 32, 2)
    for s in range(5):
        np.testing.assert_array_equal(got[s], jsp._to_onehot(seg[s], 2))
    labels = np.random.default_rng(0).integers(0, 3, (32, 32))
    np.testing.assert_array_equal(tsp._to_onehot(labels, 3), jsp._to_onehot(labels, 3))
    with h5py.File(segroot / "labels3" / "file_0.h5") as f:
        three = f["segmentation"][0]
    np.testing.assert_array_equal(tsp._to_onehot(three, 3), jsp._to_onehot(three, 3))


# ---- the trainer ----


def _loader(root, model_cfg, shuffle=False, consecutive=1, batch=2):
    ds_cfg = {"data_path": str(root), "batch_size": batch, "coil_combination_method": "SENSE",
              "consecutive_slices": consecutive}
    return launch._build_task_loader("segmentation", ds_cfg, model_cfg, shuffle, "cpu")


@pytest.mark.parametrize("name", ["unet", "vnet_live"])
def test_trainer_steps_and_validate_match_jax(segroot, name, monkeypatch):
    """Three ``SegmentationTrainer`` SGD steps (the YAMLs' loss: detached CE +
    Dice at 0.5 / 0.5) against the JAX trainer: losses, gradient norms, each
    parameter's update over the three
    steps at relative l2 1e-2 (a roundoff update, of a conv bias before
    train-mode BatchNorm, held to roundoff) and the live BatchNorm statistics
    after; then ``validate()``'s ``val_loss`` and ``val_DICE``. SGD, as
    ``ROADMAP.md`` §1 has such runs compared: Adam normalises each element's
    step, so an element whose gradient is roundoff steps by roundoff's sign,
    (Adam's own parity is held in ``test_torch_port_train.py``). Live
    BatchNorm is V-Net's here: the lambda U-Net's float32 gradient is
    ill-conditioned (``test_torch_port_seg.py``), and at any rate its gradient
    norm swings from step to step by more than its noise, so two trajectories
    part within two steps (at SGD 5e-4: 2.41 against 2.28 at the third step,
    with losses equal to 1e-5); its live statistics are held on a forward in
    ``test_torch_port_seg.py`` and its folded steps below. V-Net's steps
    keep every channel (its dropout draws differ per package)."""
    _fast_jax_init(monkeypatch)
    base = name.split("_")[0]
    cfg = {**s1.MODELS[base], "segmentation_module_output_channels": 2}
    if name.endswith("live"):
        cfg["train_batch_stats"] = True
    keep_all = lambda shape, p: np.ones(shape, bool)  # noqa: E731
    if base == "vnet":
        monkeypatch.setattr(s1.fnn.Dropout, "__call__", s1._patched_flax_dropout(keep_all))
    loss_cfg = ttt.seg_loss_cfg_from_model_cfg(jconfig.load_config(UNET_TRAIN)["model"])
    optim = {"name": "sgd", "lr": 0.05}
    batch = next(iter(_loader(segroot / "train", cfg)))
    v = s1.jax_vars(cfg, batch["image"].shape, seed=5)
    jt = jtt.SegmentationTrainer(s1._jm(s1._key(cfg)), optim_cfg=optim, seg_loss_cfg=loss_cfg)
    jt.init_state(jax.random.PRNGKey(0), batch)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(params=params, opt_state=jt._tx.init(params),
                                batch_stats=jax.tree_util.tree_map(jnp.asarray, v.get("batch_stats")))
    tt = ttt.SegmentationTrainer(s1.port(cfg, v), optim_cfg=optim, seg_loss_cfg=loss_cfg, device="cpu")
    before = {k: p.detach().clone() for k, p in tt.model.state_dict().items()}
    with s1.seg_blocks.dropout_masks(keep_all):
        for _ in range(3):
            want, got = jt.training_batch(batch), tt.training_batch(batch)
            _close(float(got["loss"]), float(want["loss"]))
            _close(float(got["grad_norm"]), float(want["grad_norm"]))
    tree = {"params": jax.tree_util.tree_map(np.asarray, jt.state.params)}
    if jt.state.batch_stats is not None:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
    after = zoo2_params_from_jax(tree, cfg)
    roundoff = 1e-6 * max(float((after[k] - before[k]).abs().max()) for k in after)
    for k, p in tt.model.state_dict().items():
        step, want_step = (p - before[k]).numpy(), (after[k] - before[k]).numpy()
        if k.endswith(("running_mean", "running_var")):
            _close(p, after[k].numpy())
        elif float(np.abs(want_step).max()) <= roundoff:  # frozen statistics too: a zero gradient
            assert float(np.abs(step).max()) <= roundoff, k
        else:
            assert s1._rel_l2(step, want_step) < s1.GRAD_REL_L2, (k, s1._rel_l2(step, want_step))
    if name.endswith("live"):
        assert any(k.endswith("running_var") for k in after)
    val = _loader(segroot / "val", cfg)
    want_val, got_val = jt.validate(val), tt.validate(val)
    assert sorted(got_val) == sorted(want_val) == ["val_DICE", "val_loss"]
    for k in want_val:
        _close(got_val[k], want_val[k])


def test_five_slice_batches_fold_for_a_2d_trunk(segroot):
    """A [B, 5, H, W, 1] batch reaches the lambda U-Net folded to [5B, H, W,
    1], rows grouped (g, t) as its temporal lambda groups them, and its
    logits unfold to [B, 5, H, W, 2]: the prediction equals the JAX
    ``LambdaUnet`` applied to the folded batch; the 3D U-Net takes the
    batch as volumes."""
    cfg = {**jconfig.load_config(LAMBDA5)["model"], "segmentation_module_channels": 8,
           "segmentation_module_pooling_layers": 2}
    batch = next(iter(_loader(segroot / "five", cfg, consecutive=5, batch=2)))
    assert batch["image"].shape == (2, 5, 32, 32, 1) and batch["segmentation"].shape == (2, 5, 32, 32, 2)
    folded = batch["image"].reshape(10, 32, 32, 1)
    v = s1.jax_vars(cfg, folded.shape, seed=6)
    want = np.asarray(s1._jax_apply(s1._key(cfg), False)(v, jnp.asarray(folded))).reshape(2, 5, 32, 32, 2)
    tt = ttt.SegmentationTrainer(s1.port(cfg, v), device="cpu")
    _close(tt.predict_batch(batch), want)
    out = tt.training_batch(batch)
    assert np.isfinite(float(out["loss"])) and np.isfinite(float(out["grad_norm"]))
    vol = ttt.SegmentationTrainer(build_model(s1.MODELS["unet3d"], device="cpu"), device="cpu")
    vol.init_state(batch)
    assert vol.predict_batch(batch).shape == (2, 5, 32, 32, 2)
    assert vol.model.trunk.down_sample_layers[0].conv1.weight.shape[1] == 1


def test_jax_launcher_fails_on_the_five_slice_config(segroot, monkeypatch):
    """The JAX package cannot run base_segmentation_lambda_unet3d_train.yaml:
    its lambda layer unpacks 4 axes of the [B, 5, H, W, 1] batch."""
    _fast_jax_init(monkeypatch)
    overrides = ["model.segmentation_module_channels=8", "model.segmentation_module_pooling_layers=2",
                 f"model.train_ds.data_path={segroot / 'five'}", f"model.validation_ds.data_path={segroot / 'five_val'}",
                 f"exp_manager.exp_dir={segroot / 'exp_j5'}", "exp_manager.create_tensorboard_logger=false"]
    with pytest.raises(ValueError, match="too many values to unpack"):
        jlaunch.run_from_config(jconfig.load_config(LAMBDA5, overrides))


def test_five_slice_config_runs_from_its_yaml(segroot):
    """``run -c base_segmentation_lambda_unet3d_train.yaml`` as written but
    for the widths (5 consecutive slices, the temporal lambda, batch 1): two
    steps, finite losses and validations, an archive."""
    overrides = ["model.segmentation_module_channels=8", "model.segmentation_module_pooling_layers=2",
                 "trainer.accelerator=cpu", "exp_manager.create_tensorboard_logger=false",
                 f"model.train_ds.data_path={segroot / 'five'}", f"model.validation_ds.data_path={segroot / 'five_val'}",
                 f"exp_manager.exp_dir={segroot / 'exp_p5'}", "trainer.max_epochs=1"]
    cli.main(["run", "-c", str(LAMBDA5), *overrides])
    (run_dir,) = (segroot / "exp_p5" / "lambdaunet3d").iterdir()
    assert (run_dir / "lambdaunet3d.mridc").is_file()
    model, _, cfg = checkpoints.restore_model(run_dir / "lambdaunet3d.mridc", device="cpu")
    assert cfg["consecutive_slices"] == 5 and model.trunk.conv.layers[0].temp_conv is not None


# ---- the launcher ----


def _recording(monkeypatch, cls, losses, vals):
    step, validate = cls.training_batch, cls.validate

    def training_batch(self, batch):
        out = step(self, batch)
        losses.append(float(out["loss"]))
        return out

    def val(self, *a, **kw):
        out = validate(self, *a, **kw)
        vals.append(dict(out))
        return out

    monkeypatch.setattr(cls, "training_batch", training_batch)
    monkeypatch.setattr(cls, "validate", val)


def test_config_run_matches_jax_and_its_archive_restores_in_jax(segroot, monkeypatch):
    """``python -m mridc_tpu_torch run -c base_segmentation_unet_train.yaml``
    (cut to 4 channels x 2 pools) against ``mridc_tpu.launch`` from one JAX
    archive: per-step losses and the initial and final validations; the
    port's archive restores in ``mridc_tpu`` to the port's weights."""
    _fast_jax_init(monkeypatch)
    data = [f"model.train_ds.data_path={segroot / 'train'}", f"model.validation_ds.data_path={segroot / 'val'}"]
    cfg = jconfig.load_config(UNET_TRAIN, SMALL + data)
    v = s1.jax_vars(cfg["model"], (1, 32, 32, 1), seed=7)
    archive = jckpt.save_archive(segroot / "junet.mridc", cfg["model"], v["params"])
    common = SMALL + data + ["pretrained=true", f"checkpoint={archive}"]
    runs = {}
    for name, cls, run in (
        ("jax", jtt.SegmentationTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(UNET_TRAIN, o))),
        ("port", ttt.SegmentationTrainer, lambda o: cli.main(["run", "-c", str(UNET_TRAIN), *o])),
    ):
        losses, vals = [], []
        with monkeypatch.context() as m:
            _recording(m, cls, losses, vals)
            run(common + [f"exp_manager.exp_dir={segroot / 'exp' / name}"])
        runs[name] = (losses, vals)
    (jl, jv), (pl, pv) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 6
    _close(np.asarray(pl), np.asarray(jl))
    assert len(pv) == len(jv) == 2
    for p, j in zip(pv, jv):
        assert sorted(p) == sorted(j) == ["val_DICE", "val_loss"]
        for k in j:
            _close(p[k], j[k])
    (run_dir,) = (segroot / "exp" / "port" / "segmentation_unet").iterdir()
    trained = run_dir / "segmentation_unet.mridc"
    _, jparams, jcfg = jckpt.restore_model(trained)
    assert jcfg["model_name"] == "SegmentationUNet"
    model, _, _ = checkpoints.restore_model(trained, device="cpu")
    back = zoo2_params_to_jax(model.state_dict(), jcfg)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_mode_test_writes_classes_and_metrics_where_jax_raises(segroot, monkeypatch):
    """``mode: test`` of base_segmentation_unet_run.yaml on one archive: the
    JAX launcher's inherited ``Trainer.test`` reads ``batch["target"]``,
    which segmentation batches lack (``KeyError``); the port writes each
    volume's predicted classes [S, H, W, 2] (one class a pixel) under
    ``segmentation`` and logs DICE, IOU, F1 and HD95, equal to the
    metrics of the trainer's own predictions."""
    _fast_jax_init(monkeypatch)
    cfg = jconfig.load_config(UNET_RUN, SMALL[:2])
    v = s1.jax_vars(cfg["model"], (1, 32, 32, 1), seed=8)
    archive = jckpt.save_archive(segroot / "jrun.mridc", cfg["model"], v["params"])
    overrides = SMALL[:2] + [f"model.test_ds.data_path={segroot / 'val'}", f"checkpoint={archive}",
                             "exp_manager.create_tensorboard_logger=false"]
    with pytest.raises(KeyError, match="target"):
        jlaunch.run_from_config(jconfig.load_config(UNET_RUN, overrides + [f"exp_manager.exp_dir={segroot / 'jt'}"]))
    trainer, means = launch.run_from_config(
        jconfig.load_config(UNET_RUN, overrides + ["trainer.accelerator=cpu", f"exp_manager.exp_dir={segroot / 'pt'}"]))
    assert sorted(means) == ["DICE", "F1", "HD95", "IOU"]
    (test_dir,) = (segroot / "pt" / "segmentation_unet").iterdir()
    (written,) = (test_dir / "reconstructions").iterdir()
    with h5py.File(written, "r") as f:
        classes = f["segmentation"][()]
    assert classes.shape == (2, 32, 32, 2) and (classes.sum(-1) == 1).all()
    loader = _loader(segroot / "val", cfg["model"], batch=1)
    preds = np.concatenate([ttt._seg_pred_classes(trainer.predict_batch(b)) for b in loader])
    np.testing.assert_array_equal(classes, preds)
    labels = np.concatenate([b["segmentation"] for b in loader])
    want = s1.jmetrics.SegmentationMetrics()(np.moveaxis(labels, -1, 0), np.moveaxis(preds, -1, 0))
    for k in want:
        _close(means[k], want[k])


@pytest.mark.parametrize("name", YAMLS)
def test_segmentation_yamls_build_through_the_launcher(name):
    """Each projects/segmentation/conf YAML's model block: ``_auto_dc_mode``
    and ``model_task`` as the JAX launcher's, its model built and its trunk
    materialised at the magnitude input's single channel (the YAMLs say 2)."""
    model = jconfig.load_config(CONF / f"{name}.yaml")["model"]
    cfg = launch._auto_dc_mode(dict(model))
    assert cfg == jlaunch._auto_dc_mode(dict(model)) == model
    assert launch.model_task(model["model_name"]) == jlaunch.model_task(model["model_name"]) == "segmentation"
    assert model["segmentation_module_input_channels"] == 2 and model["magnitude_input"]
    built = build_model(cfg, device="cpu")
    built.materialize((1, 32, 32, 1))
    assert type(built).__name__.lower() == model["model_name"].lower()
    assert built.state_dict()[f"trunk.{built.first_conv}"].shape[1] == 1


# ---- archives ----


@pytest.mark.parametrize("name", sorted(s1.MODELS) + ["lambda_live"])
def test_archives_both_ways(tmp_path, name):
    """A ``mridc_tpu`` archive restores in the port to the mapped weights
    (live statistics too), and the port's archive (flax msgpack) restores in
    ``mridc_tpu`` to the same tree, bit for bit."""
    cfg = dict(s1.MODELS["lambda" if name == "lambda_live" else name])
    if name == "lambda_live":
        cfg["train_batch_stats"] = True
    v = s1.jax_vars(cfg, (1, 32, 32, 1), seed=9)
    jarchive = jckpt.save_archive(tmp_path / "j.mridc", cfg, v["params"], v.get("batch_stats"))
    model, state, _ = checkpoints.restore_model(jarchive, device="cpu")
    want = zoo2_params_from_jax(v, cfg)
    assert state.keys() == want.keys()
    for k in want:
        assert torch.equal(state[k], want[k]), k
    parchive = checkpoints.save_archive(tmp_path / "p.mridc", cfg, model.state_dict())
    _, variables, jcfg = jckpt.restore_model_variables(parchive)
    assert json.loads(json.dumps(jcfg)) == cfg
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(variables), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), b)


# ---- chip_smoke.py's phase G configs ----


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", sorted(_chip_smoke().G_CFGS))
def test_chip_smoke_g_models_are_the_yamls(name):
    """Phase G's model keys (``G_CFGS``) are each train YAML's."""
    cs = _chip_smoke()
    model = jconfig.load_config(CONF / f"base_segmentation_{name}_train.yaml")["model"]
    assert {k: model[k] for k in cs.G_CFGS[name]} == cs.G_CFGS[name]
    assert set(model) - set(cs.G_CFGS[name]) == set(cs.SEG_UNET_TRAIN_CFG["model"]) - set(cs.G_CFGS["unet"])


@pytest.mark.parametrize("name,attr", [("base_segmentation_unet_train", "SEG_UNET_TRAIN_CFG"),
                                       ("base_segmentation_unet_run", "SEG_UNET_RUN_CFG"),
                                       ("base_segmentation_lambda_unet3d_train", "SEG_LAMBDA5_TRAIN_CFG")])
def test_chip_smoke_g_launch_configs_are_the_yamls(name, attr):
    """Phase G's config-file runs read the YAMLs as written."""
    assert getattr(_chip_smoke(), attr) == jconfig.load_config(CONF / f"{name}.yaml")


def test_segmentation_entry_points_run_on_the_card_unless_asked(monkeypatch, segroot):
    """Without a card, the model build, the trainer and a segmentation run
    raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = s1.MODELS["unet"]
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttt.SegmentationTrainer(build_model(cfg, device="cpu"))
    run = jconfig.load_config(UNET_TRAIN, [f"model.train_ds.data_path={segroot / 'train'}",
                                           f"exp_manager.exp_dir={segroot / 'nocard'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_from_config(run)
    assert build_model(cfg, device="cpu").materialized is False
