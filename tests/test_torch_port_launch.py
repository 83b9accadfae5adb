"""Port parity: running from a config. ``python -m mridc_tpu_torch run -c
projects/reconstruction/conf/base_cirim_train.yaml`` (the port's CLI) against
``mridc_tpu.launch.run_from_config`` of the same config on the CPU, on
``tests/fixtures.py:create_dataset`` h5 volumes, both starting from one
``pretrained: true`` archive that ``mridc_tpu`` wrote.

The config is cut to size by overrides (1 cascade, 2 time steps, 8 filters,
4 coils, 32 x 32, one epoch). Per-step losses, the initial and final
validation metrics and ``mode: test``'s written reconstructions are held at
rtol 2e-3 / atol 2e-4 (``tests/test_torch_parity.py``'s tolerance); the run
dirs hold the same file names. ``_auto_dc_mode`` and ``model_task`` agree
with the JAX launcher's on every ``projects/`` config's model block.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mridc_tpu import launch as jlaunch
from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import config as jconfig
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch import cli, launch
from mridc_tpu_torch.train.trainer import Trainer

from fixtures import create_dataset

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "projects/reconstruction/conf/base_cirim_train.yaml"
CONFIGS = sorted(ROOT.glob("projects/*/conf/*.yaml"))
RTOL, ATOL = 2e-3, 2e-4
SMALL = ["model.num_cascades=1", "model.time_steps=2", "model.conv_filters=[8,8,2]",
         "model.recurrent_filters=[8,8,0]", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
         "trainer.accelerator=cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Fixture volumes (train: 2 files, validation and test: 1 each; 2 slices,
    4 coils, 32 x 32) and a ``mridc_tpu`` archive of the small CIRIM."""
    root = tmp_path_factory.mktemp("port_launch")
    for split, n, seed in (("train", 2, 0), ("val", 1, 1), ("test", 1, 2)):
        create_dataset(root / split, n_files=n, slices=2, coils=4, h=32, w=32, seed=seed)
    data = [f"model.train_ds.data_path={root / 'train'}", f"model.validation_ds.data_path={root / 'val'}",
            f"model.test_ds.data_path={root / 'test'}"]
    cfg = jconfig.load_config(YAML, SMALL + data)
    model = jax_build_model(cfg["model"])
    y = np.zeros((1, 4, 32, 32, 2), np.float32)
    params = model.init(jax.random.PRNGKey(3), y, np.ones((1, 4, 32, 32, 2), np.float32),
                        np.ones((1, 1, 32, 32, 1), np.float32))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.0, params)
    archive = jckpt.save_archive(root / "jax_cirim.mridc", cfg["model"], params)
    return root, data + ["pretrained=true", f"checkpoint={archive}"]


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


def _run_dir(exp_dir):
    (run,) = (Path(exp_dir) / "cirim").iterdir()
    return run


def test_config_run_matches_jax(setup, monkeypatch):
    root, common = setup
    runs = {}
    for name, cls, run in (
        ("jax", JTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(YAML, o))),
        ("port", Trainer, lambda o: cli.main(["run", "-c", str(YAML), *o])),
    ):
        losses, vals = [], []
        with monkeypatch.context() as m:
            _recording(m, cls, losses, vals)
            run(SMALL + common + [f"exp_manager.exp_dir={root / name}"])
        runs[name] = (losses, vals)
    (jl, jv), (pl, pv) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 4  # 2 volumes x 2 slices at batch 1
    _close(pl, jl, "per-step losses")
    assert len(pv) == len(jv) == 2  # the initial validation and the epoch's
    for p, j in zip(pv, jv):
        assert set(p) == set(j)
        for k in j:
            _close(p[k], j[k], k)
    jdir, pdir = _run_dir(root / "jax"), _run_dir(root / "port")
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in (pdir / "checkpoints").iterdir()) == sorted(
        p.name for p in (jdir / "checkpoints").iterdir())
    # the port's config.yaml and hparams.yaml (JSON text) read back as written
    assert jconfig.load_config(pdir / "config.yaml") == launch.load_config(pdir / "config.yaml")
    assert jconfig.load_config(pdir / "hparams.yaml")["model_name"] == "CIRIM"


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: f"{p.parent.parent.name}/{p.stem}")
def test_auto_dc_mode_and_task_match_jax(path):
    model = jconfig.load_config(path).get("model") or {}
    model = {**model, **{k: {**model[k], "data_path": "/data"} for k in ("train_ds", "validation_ds", "test_ds")
                         if isinstance(model.get(k), dict)}}
    assert launch._auto_dc_mode(dict(model)) == jlaunch._auto_dc_mode(dict(model))
    assert launch.model_task(model.get("model_name", "")) == jlaunch.model_task(model.get("model_name", ""))


@pytest.mark.parametrize("name,item", [("SEGNET", "M12"), ("MTLRS", "M12"), ("SERANET", "M12")])
def test_unported_tasks_raise_naming_their_item(name, item, tmp_path, monkeypatch):
    """The multitask names, which raised naming their ROADMAP item until it
    was ported, now reach ``MultitaskTrainer``: a config without data builds
    the model and the trainer and stops at the missing ``train_ds``; no
    pending model is filed under the item."""
    from mridc_tpu_torch.models import PENDING_MODELS
    from mridc_tpu_torch.train import task_trainers

    built = []
    init = task_trainers.MultitaskTrainer.__init__
    monkeypatch.setattr(task_trainers.MultitaskTrainer, "__init__",
                        lambda self, *a, **kw: (init(self, *a, **kw), built.append(self))[0])
    cfg = {"model": {"model_name": name}, "trainer": {"accelerator": "cpu"},
           "exp_manager": {"exp_dir": str(tmp_path)}}
    with pytest.raises(KeyError, match="train_ds"):
        launch.run_from_config(cfg)
    assert len(built) == 1 and type(built[0].model).__name__.upper() == name
    assert not any(item in v for v in PENDING_MODELS.values())


def test_pretrained_name_or_url_raises_naming_m13(setup, tmp_path, monkeypatch):
    """``pretrained: true`` takes a registered pretrained name, its alias and a
    URL cached under the JAX package's key as it takes the archive's path:
    the same weights bit for bit. An unknown name raises
    ``FileNotFoundError``. (The name is the one the test had while names and
    URLs raised.)"""
    from mridc_tpu_torch.models import pretrained
    from mridc_tpu_torch.train.checkpoints import load_archive
    from mridc_tpu_torch.utils.cloud import cache_path

    archive = next(o for o in setup[1] if o.startswith("checkpoint=")).split("=", 1)[1]
    monkeypatch.setattr(pretrained, "_PRETRAINED", {})
    monkeypatch.setenv("MRIDC_TPU_CACHE_DIR", str(tmp_path / "cache"))
    url = "https://models.example.org/cirim/cirim_small.mridc"
    cached = cache_path(url, "cirim_small.mridc")
    cached.parent.mkdir(parents=True)
    cached.write_bytes(Path(archive).read_bytes())
    pretrained.register_pretrained_model(pretrained.PretrainedModelInfo(
        "cirim_small", "CIRIM, 1 cascade", archive, aliases=("cirim_tiny",)))
    _, want = load_archive(archive)
    for ckpt in ("cirim_small", "cirim_tiny", url, archive):
        got = launch._pretrained_state(ckpt)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (ckpt, k)
    with pytest.raises(FileNotFoundError, match="cirim_small"):
        launch._pretrained_state("cirim_knee_unregistered")


def test_without_cpu_accelerator_and_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = jconfig.load_config(YAML)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_from_config({**cfg, "trainer": {**cfg["trainer"], "accelerator": "gpu"}})
