"""Port parity: RecurrentVarNet, MultiDomainNet, CS and PICS from their config
files. The ten ``projects/`` YAMLs of the four models build through
``python -m mridc_tpu_torch run -c`` (``cli.main``) on the CPU; a 2-step fit
of base_rvn_train.yaml at a small width and ``mode: test`` of two CS/PICS
run configs match ``mridc_tpu.launch`` on fixture volumes (rtol 2e-3 / atol
2e-4, ``tests/test_torch_parity.py:131``).
"""

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

import test_torch_port_launch as tl
import test_torch_port_zoo2 as z2
from fixtures import create_dataset
from test_torch_port_zoo3 import ATOL, ROOT, RTOL, YAMLS, _close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_through_the_launcher(path, monkeypatch, tmp_path):
    """``python -m mridc_tpu_torch run -c <yaml>`` reaches ``build_model``
    through ``_auto_dc_mode``, which leaves the model block as written, and
    builds the model on the CPU (stopped there, before any data is read)."""
    from mridc_tpu_torch import models

    built, orig = {}, models.build_model

    def stop(cfg, device=None, generator=None):
        assert "dc_mode" not in cfg
        built["model"] = orig(cfg, device=device, generator=generator)
        raise z2._Built

    monkeypatch.setattr(models, "build_model", stop)
    with pytest.raises(z2._Built):
        cli.main(["run", "-c", str(ROOT / "projects" / path), "trainer.accelerator=cpu",
                  f"exp_manager.exp_dir={tmp_path}"])
    model_cfg = launch.load_config(ROOT / "projects" / path)["model"]
    assert launch._auto_dc_mode(model_cfg) == model_cfg
    assert type(built["model"]).__name__ == {"RVN": "RecurrentVarNet"}.get(model_cfg["model_name"],
                                                                            model_cfg["model_name"])


# ---- running base_rvn_train.yaml, against mridc_tpu.launch ----


def test_rvn_config_fit_matches_jax(tmp_path, monkeypatch):
    """``cli.main(["run", "-c", base_rvn_train.yaml])`` against
    ``mridc_tpu.launch.run_from_config`` at a small width on fixture volumes
    (2 training steps at batch 1, 4 coils, 16x16), both from one
    ``pretrained: true`` archive that ``mridc_tpu`` wrote: the per-step
    losses and the validation metrics."""
    yaml_path = ROOT / "projects/reconstruction/conf/base_rvn_train.yaml"
    for split, n, seed in (("train", 2, 0), ("val", 1, 1)):
        create_dataset(tmp_path / split, n_files=n, slices=1, coils=4, h=16, w=16, seed=seed)
    small = ["model.recurrent_hidden_channels=4", "model.recurrent_num_layers=1",
             "model.initializer_channels=[4,4,8,8]", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
             "trainer.accelerator=cpu", f"model.train_ds.data_path={tmp_path / 'train'}",
             f"model.validation_ds.data_path={tmp_path / 'val'}", "model.test_ds.data_path=null"]
    cfg = jconfig.load_config(yaml_path, small)
    y = np.zeros((1, 4, 16, 16, 2), np.float32)
    params = jax.jit(jax_build_model(cfg["model"]).init)(jax.random.PRNGKey(3), y, np.ones_like(y),
                                                         np.ones((1, 1, 16, 16), np.float32))["params"]
    archive = jckpt.save_archive(tmp_path / "jax_rvn.mridc", cfg["model"],
                                 jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.0, params))
    common = small + ["pretrained=true", f"checkpoint={archive}"]
    runs = {}
    for name, cls, run in (
        ("jax", JTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(yaml_path, o))),
        ("port", Trainer, lambda o: cli.main(["run", "-c", str(yaml_path), *o])),
    ):
        losses, vals = [], []
        with monkeypatch.context() as m:
            tl._recording(m, cls, losses, vals)
            run(common + [f"exp_manager.exp_dir={tmp_path / name}"])
        runs[name] = (losses, vals)
    (jl, jv), (pl, pv) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL * max(1.0, max(abs(v) for v in jl)))
    assert len(pv) == len(jv) and pv
    for p, j in zip(pv, jv):
        assert set(p) == set(j)
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=ATOL * max(1.0, abs(float(j[k]))), err_msg=k)


@pytest.mark.parametrize("path", ["reconstruction/conf/base_pics_run.yaml", "unselfsupervised/conf/base_cs_run.yaml"])
def test_cs_run_configs_write_the_jax_reconstructions(path, tmp_path):
    """``mode: test`` of a CS/PICS run config through ``cli.main`` writes the
    reconstructions ``mridc_tpu``'s launcher writes (fixture volumes, 4 coils,
    16x16; the unselfsupervised config's stanford_knees reader swapped for the
    fastMRI one the fixtures write). The masks are seeded, so that the two
    runs draw the same ones. ``normalize_inputs`` is off: its max
    normalisation of the maps lifts their root sum of squares to ~1.7 on
    these volumes, past the solvers' sum |S|^2 = 1, and FISTA's unit step
    then diverges in both packages alike (to ~1e9 and inf)."""
    import h5py

    create_dataset(tmp_path / "test", n_files=1, slices=2, coils=4, h=16, w=16, seed=3)
    over = ["trainer.accelerator=cpu", f"model.test_ds.data_path={tmp_path / 'test'}",
            "model.test_ds.dataset_format=null", "model.test_ds.normalize_inputs=false",
            "model.test_ds.mask_args.use_seed=true", "model.test_ds.use_seed=true"]
    yaml_path = ROOT / "projects" / path
    jlaunch.run_from_config(jconfig.load_config(yaml_path, over + [f"exp_manager.exp_dir={tmp_path / 'jax'}"]))
    cli.main(["run", "-c", str(yaml_path), *over, f"exp_manager.exp_dir={tmp_path / 'port'}"])
    (jrun,), (prun,) = ((tmp_path / side).glob("*/*") for side in ("jax", "port"))
    jrec, prec = jrun / "reconstructions", prun / "reconstructions"
    names = sorted(p.name for p in jrec.iterdir())
    assert names and names == sorted(p.name for p in prec.iterdir())
    for n in names:
        with h5py.File(jrec / n) as j, h5py.File(prec / n) as p:
            _close(p["reconstruction"][()], j["reconstruction"][()])
