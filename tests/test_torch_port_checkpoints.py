"""Port parity: checkpoints. ``.mridc`` archives cross both ways between
``mridc_tpu_torch`` and ``mridc_tpu`` (a small CIRIM and a small VarNet
predict the same from the restored weights at rtol 2e-3 / atol 2e-4), step
checkpoints resume bit for bit on the CPU, and the top-k bookkeeping keeps,
ranks and restores as ``mridc_tpu``'s orbax checkpointer does under ``mode``
min and max.
"""

import io
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import cirim_params_from_jax, varnet_params_from_jax

import test_torch_port_cirim as tc
import test_torch_port_vn as tv

RTOL, ATOL = 2e-3, 2e-4
OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
         "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(config, JAX params, mapping to the port's state dict, inputs)."""
    if name == "cirim":
        cfg = tc._cfg(dc_mode="full")
        y, sens, mask = tc._data(24, 24, seed=1)
        return cfg, tc._jax_params(cfg, y, sens, mask, seed=2), cirim_params_from_jax, (y, sens, mask)
    cfg = tv._cfg()
    y, sens, mask, _ = tv._data(32, 32, seed=1)
    return cfg, tv._jax_params(cfg, y, sens, mask, seed=2), varnet_params_from_jax, (y, sens, mask)


def _jax_predict(cfg, params, inputs):
    model = jax_build_model(cfg)
    return np.asarray(model.apply({"params": params}, *(jnp.asarray(a) for a in inputs)).prediction)


def _port_predict(model, inputs):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in inputs)).prediction.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", ["cirim", "varnet"])
def test_port_archive_restores_in_jax(name, tmp_path):
    cfg, params, to_port, inputs = _case(name)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(to_port(params))
    path = checkpoints.save_archive(tmp_path / f"{name}.mridc", cfg, model.state_dict())
    jmodel, jparams, jcfg = jckpt.restore_model(path)
    assert jcfg == cfg
    got = np.asarray(jmodel.apply({"params": jparams}, *(jnp.asarray(a) for a in inputs)).prediction)
    _close(got, _port_predict(model, inputs))


@pytest.mark.parametrize("name", ["cirim", "varnet"])
def test_jax_archive_restores_in_the_port(name, tmp_path):
    cfg, params, _, inputs = _case(name)
    path = jckpt.save_archive(tmp_path / f"{name}.mridc", cfg, params)
    model, state, got_cfg = checkpoints.restore_model(path, device="cpu")
    assert got_cfg == cfg and set(state) == set(model.state_dict())
    _close(_port_predict(model, inputs), _jax_predict(cfg, params, inputs))


def test_archive_without_weights_says_so(tmp_path):
    path = tmp_path / "no_weights.mridc"
    with tarfile.open(path, "w:gz") as tar:
        data = b'{"model_name": "CIRIM"}'
        info = tarfile.TarInfo("model_config.yaml")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="no model weights"):
        checkpoints.load_archive(path)


def test_flax_archive_of_jointicnet_restores(tmp_path):
    """JointICNet, the last model ported (M8), is archived in flax msgpack
    and restored from it; an archive with an empty tree names the leaves it
    lacks."""
    cfg = {"model_name": "JointICNet", "num_iter": 1, "kspace_unet_num_filters": 2, "kspace_unet_num_pool_layers": 1,
           "imspace_unet_num_filters": 2, "imspace_unet_num_pool_layers": 1, "sens_unet_num_filters": 2,
           "sens_unet_num_pool_layers": 1}
    from mridc_tpu_torch.models import build_model

    state = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    path = checkpoints.save_archive(tmp_path / "jointicnet.mridc", cfg, state)
    with tarfile.open(path) as tar:
        assert "model_weights.msgpack" in tar.getnames()
    got_cfg, got = checkpoints.load_archive(path)
    assert got_cfg == cfg and sorted(got) == sorted(state) and all(torch.equal(got[k], state[k]) for k in state)
    empty = tmp_path / "empty.mridc"
    with tarfile.open(empty, "w:gz") as tar:
        for name, data in (("model_config.yaml", b'{"model_name": "JointICNet"}'),
                           ("model_weights.msgpack", b"\x80")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    with pytest.raises(KeyError, match="missing"):
        checkpoints.load_archive(empty)


def _batches(n):
    cfg = tc._cfg(dc_mode="full", num_cascades=1, time_steps=2)
    out = []
    for i in range(n):
        y, sens, mask = tc._data(16, 16, seed=10 + i)
        target = np.random.default_rng(i).standard_normal((tc.B, 16, 16)).astype(np.float32)
        out.append({"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target})
    return cfg, out


def _trainer(cfg, seed):
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(model, optim_cfg=OPTIM, trainer_cfg={"max_steps": 10}, use_ema=True, device="cpu")
    trainer.setup_optimization(num_samples=8, batch_size=2)
    trainer.init_state()
    return trainer


def test_step_checkpoint_resumes_bit_for_bit(tmp_path):
    """2 steps, a step checkpoint, a fresh trainer (other initial weights)
    restored from it, 2 more steps: the parameters, the EMA weights and the
    optimizer's moments equal those of 4 straight steps, bit for bit."""
    cfg, batches = _batches(4)
    straight = _trainer(cfg, seed=0)
    for b in batches:
        straight.training_batch(b)
    first = _trainer(cfg, seed=0)
    for b in batches[:2]:
        first.training_batch(b)
    ckpt = checkpoints.StepCheckpointer(tmp_path / "checkpoints")
    ckpt.save(2, first.state_dict(), {"val_loss": 0.5})
    resumed = _trainer(cfg, seed=1)
    resumed.load_state_dict(ckpt.restore())
    assert resumed.state.step == 2
    for b in batches[2:]:
        resumed.training_batch(b)
    want, got = straight.state_dict(), resumed.state_dict()
    assert got["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for k, v in want["ema"].items():
        assert torch.equal(got["ema"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)


# (step, val_loss); step 6 misses the monitored metric: it ranks worst
SERIES = [(1, 0.5), (2, 0.2), (3, 0.9), (4, 0.1), (5, 0.3), (6, None)]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_top_k_matches_orbax(mode, tmp_path):
    port = checkpoints.StepCheckpointer(tmp_path / "port", max_to_keep=3, mode=mode)
    orbax = jckpt.OrbaxCheckpointer(tmp_path / "orbax", max_to_keep=3, mode=mode)
    for step, loss in SERIES:
        metrics = {} if loss is None else {"val_loss": loss}
        port.save(step, {"x": torch.tensor(float(step)), "step": step}, metrics)
        orbax.save(step, {"x": np.asarray(float(step), np.float32)}, metrics)
        assert port.latest_step() == orbax.latest_step()
        assert port.best_step() == orbax.best_step()
        assert sorted(int(p.name) for p in (tmp_path / "port").iterdir() if p.name.isdigit()) == sorted(
            orbax._mgr.all_steps())
    best = port.restore_best()
    assert float(best["x"]) == float(orbax.restore_best({"x": np.asarray(0.0, np.float32)})["x"])
    port.save_last({"x": torch.tensor(7.0), "step": 7})
    assert float(port.restore_last()["x"]) == 7.0 and port.best_step() == orbax.best_step()
    orbax.close()
