"""Port parity: ``Trainer.fit``, ``validate`` and ``test`` of mridc_tpu_torch
against mridc_tpu's on the CPU, on ``tests/fixtures.py:create_dataset`` h5
volumes read by each package's own loader.

Both trainers start from the same CIRIM weights. Per-step losses, the epoch
metrics (train loss, validation loss, MSE, NMSE, PSNR, SSIM) and the test
metrics are held at rtol 2e-3 / atol 2e-4, the tolerance of
``tests/test_torch_parity.py``; runs of the port that differ only in their
loader stages must agree exactly.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from mridc_tpu.data import factory as jfactory
from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train.trainer import TrainState as JTrainState
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch.data import factory
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train import trainer as trainer_module
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import cirim_params_from_jax

from fixtures import create_dataset
from test_torch_port_cirim import _cfg, _data, _jax_params
from test_torch_port_data import _train_ds

RTOL, ATOL = 2e-3, 2e-4
OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
         "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}
PLATEAU = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
           "sched": {"name": "ReduceLROnPlateau", "factor": 0.5, "patience": 0, "threshold": 0.5}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_fit")
    create_dataset(root, n_files=2, slices=3, coils=4, h=32, w=32)
    return root


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _ds(dataset_dir, case):
    """(train, validation) dataset configs: the YAML's own (poisson2d,
    uncentered backward FFT) or an equispaced 1D mask for the psf1d DC."""
    base = _train_ds()
    if case == "psf1d":
        base["mask_args"] = {"type": "equispaced1d", "accelerations": [4], "center_fractions": [0.08]}
    train = {**base, "data_path": str(dataset_dir), "batch_size": 2}
    return train, {**train, "shuffle": False}


def _model_cfg(case):
    return _cfg(dc_mode="full" if case != "psf1d" else "psf1d", num_cascades=1, fft_centered=False,
                fft_normalization="backward")


def _recording(trainer, losses):
    step = trainer.training_batch

    def wrapped(batch):
        out = step(batch)
        losses.append(float(out["loss"]))
        return out

    trainer.training_batch = wrapped


def _run_jax(case, dataset_dir, trainer_cfg, optim, params, use_ema):
    train, val = _ds(dataset_dir, case)
    jt = JTrainer(jax_build_model(_model_cfg(case)), optim_cfg=optim, trainer_cfg=trainer_cfg, loss_type="l1",
                  use_ema=use_ema, mesh=make_mesh(1))
    loader = jfactory.build_dataloader(train)
    jt.setup_optimization(num_samples=len(loader.dataset), batch_size=2)
    jt.state = JTrainState.create(params, jt._tx, ema=use_ema)
    losses = []
    _recording(jt, losses)
    history = jt.fit(loader, jfactory.build_dataloader(val))
    return losses, history, jt.validate(jfactory.build_dataloader(val)), jt.test(jfactory.build_dataloader(val))


def _run_port(case, dataset_dir, trainer_cfg, optim, params, use_ema, stages=None):
    train, val = _ds(dataset_dir, case)
    model = build_model(_model_cfg(case), device="cpu")
    model.load_state_dict(cirim_params_from_jax(params))
    tt = Trainer(model, optim_cfg=optim, trainer_cfg=trainer_cfg, loss_type="l1", use_ema=use_ema, device="cpu")
    loader = factory.build_dataloader({**train, **(stages or {})}, device="cpu")
    tt.setup_optimization(num_samples=len(loader.dataset), batch_size=2)
    tt.init_state()
    losses = []
    _recording(tt, losses)
    history = tt.fit(loader, factory.build_dataloader(val, device="cpu"))
    return losses, history, tt.validate(factory.build_dataloader(val, device="cpu")), tt.test(
        factory.build_dataloader(val, device="cpu"))


def _params(case, dataset_dir):
    train, _ = _ds(dataset_dir, case)
    batch = next(iter(factory.build_dataloader(train, device="cpu")))
    return _jax_params(_model_cfg(case), batch["masked_kspace"], batch["sensitivity_maps"], batch["mask"], seed=11)


FIT_CASES = {
    # the YAML's train_ds as written (poisson2d, full DC), two epochs
    "yaml_full": dict(trainer_cfg={"max_epochs": 2, "log_every_n_steps": 2}, optim=OPTIM, ema=False),
    # psf1d DC; the knobs: a step limit across epochs, batch limits, mid-epoch
    # validation, a sanity check, validation every other epoch, a plateau
    # schedule that halves the rate, EMA weights evaluated
    "psf1d_knobs_plateau_ema": dict(trainer_cfg={
        "max_epochs": 4, "max_steps": 5, "limit_train_batches": 2, "limit_val_batches": 2, "val_check_interval": 2,
        "num_sanity_val_steps": 1, "check_val_every_n_epoch": 2, "log_every_n_steps": 1}, optim=PLATEAU, ema=True),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_validate_and_test_match_jax(dataset_dir, case):
    spec = FIT_CASES[case]
    params = _params(case.split("_")[0], dataset_dir)
    mode = "psf1d" if case.startswith("psf1d") else "yaml"
    want = _run_jax(mode, dataset_dir, spec["trainer_cfg"], spec["optim"], params, spec["ema"])
    got = _run_port(mode, dataset_dir, spec["trainer_cfg"], spec["optim"], params, spec["ema"])
    (g_losses, g_hist, g_val, (g_recons, g_test)), (w_losses, w_hist, w_val, (w_recons, w_test)) = got, want
    assert len(g_losses) == len(w_losses) > 0
    _close(g_losses, w_losses)
    assert [sorted(h) for h in g_hist] == [sorted(h) for h in w_hist]
    for gh, wh in zip(g_hist, w_hist):
        _close([gh[k] for k in sorted(wh)], [wh[k] for k in sorted(wh)])
    assert sorted(g_val) == sorted(w_val) and sorted(g_test) == sorted(w_test)
    _close([g_val[k] for k in sorted(w_val)], [w_val[k] for k in sorted(w_val)])
    _close([g_test[k] for k in sorted(w_test)], [w_test[k] for k in sorted(w_test)])
    assert sorted(g_recons) == sorted(w_recons)
    for k in w_recons:
        _close(g_recons[k], w_recons[k])


STAGES = {
    "prefetch_workers": {"num_workers": 2, "prefetch_batches": 2},
    "device_prefetch": {"device_prefetch": True},
    "device_cache": {"device_cache_dataset": True},
    "device_cache_prefetched": {"device_cache_dataset": True, "device_prefetch": True, "num_workers": 2},
}


@pytest.mark.parametrize("stages", sorted(STAGES))
def test_fit_through_loader_stages_equals_the_plain_loader(dataset_dir, stages):
    cfg = {"max_epochs": 2, "log_every_n_steps": 50}
    params = _params("psf1d", dataset_dir)
    plain = _run_port("psf1d", dataset_dir, cfg, OPTIM, params, False)
    staged = _run_port("psf1d", dataset_dir, cfg, OPTIM, params, False, STAGES[stages])
    assert staged[0] == plain[0] and staged[1] == plain[1] and staged[2] == plain[2]


def test_fit_reads_the_loss_only_on_logging_steps(dataset_dir, monkeypatch):
    """The trainer calls ``.item()`` (a host wait for the card) once per
    logging step, and nowhere else in the training loop."""
    train, _ = _ds(dataset_dir, "psf1d")
    model = build_model(_model_cfg("psf1d"), device="cpu")
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg={"max_epochs": 2, "log_every_n_steps": 4}, device="cpu")
    calls = []
    item = torch.Tensor.item

    def spy(self):
        if sys._getframe(1).f_code.co_filename == trainer_module.__file__:
            calls.append(1)
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", spy)
    tt.fit(factory.build_dataloader(train, device="cpu"))
    assert tt.state.step == 6 and len(calls) == 1


def test_fit_initialises_from_a_first_batch_like_jax(dataset_dir):
    """Without a state, fit takes a first batch of a fresh iteration (as the
    JAX trainer does), so a shuffled loader's first training epoch is its
    second order."""
    train, _ = _ds(dataset_dir, "psf1d")
    tt = Trainer(build_model(_model_cfg("psf1d"), device="cpu"), optim_cfg=OPTIM, trainer_cfg={"max_steps": 1},
                 device="cpu")
    loader = factory.build_dataloader(train, device="cpu")
    seen = []
    step = tt.training_batch
    tt.training_batch = lambda b: seen.append(list(b["sample_indices"])) or step(b)
    tt.fit(loader)
    probe = factory.build_dataloader(train, device="cpu")
    list(probe)
    assert seen == [list(next(iter(probe))["sample_indices"])]


def test_unported_hooks_raise_with_their_roadmap_item():
    """The exp_manager hooks are ported (M7): a Trainer takes one. The SSDU
    branch and gradient accumulation are ported too (M5): a Trainer takes
    them, and ``fit`` runs max_steps optimizer steps, k micro-steps each."""
    model = build_model(_model_cfg("psf1d"), device="cpu")
    em = object()
    assert Trainer(model, exp_manager=em, device="cpu").exp_manager is em
    assert Trainer(model, ssdu=True, device="cpu").ssdu
    tt = Trainer(model, trainer_cfg={"accumulate_grad_batches": 2, "max_steps": 1}, device="cpu")
    y, sens, mask = _data(16, 16, seed=3)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": y[:, 0]}
    tt.fit([batch] * 4)
    assert (tt.state.step, tt.state.gradient_step) == (2, 1)


def test_batch_leaves_already_on_the_device_are_taken_as_they_are():
    tt = Trainer(build_model(_model_cfg("psf1d"), device="cpu"), device="cpu")
    x = torch.randn(2, 3, 4, 4, 2)
    assert tt._tensor(x) is x
    half = x.to(torch.bfloat16)
    up = tt._tensor(half)
    assert up.dtype == torch.float32 and torch.equal(up, half.float())
    assert tt._tensor(np.ones((2, 2), np.float32)).device.type == "cpu"


def test_prediction_runs_in_eval_mode_without_gradients(dataset_dir):
    train, _ = _ds(dataset_dir, "psf1d")
    model = build_model(_model_cfg("psf1d"), device="cpu")
    tt = Trainer(model, device="cpu")
    modes = []
    model.register_forward_pre_hook(lambda m, a: modes.append((m.training, torch.is_grad_enabled())))
    model.train()
    out = tt.predict_batch(next(iter(factory.build_dataloader(train, device="cpu"))))
    assert modes == [(False, False)] and model.training and out.dtype == np.float32


def test_chip_smoke_data_per_step_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.py's D2 runs (the config's uncentered backward FFT, batches
    from its phantom source through the loader) call each kernel's plain
    version as often as ``data_per_step`` says: phase 8's ``PER_STEP`` less
    the SENSE init, which the batch's initial prediction replaces."""
    from pathlib import Path

    from mridc_tpu_torch.data.loaders import BatchLoader
    from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
    from mridc_tpu_torch.kernels import k2_full_dc as k2
    from mridc_tpu_torch.kernels import k3_indrnn as k3
    from mridc_tpu_torch.kernels import k4_conv_epilogue as k4

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    counts = {}

    def count(mod, name, symbols):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            for sym in symbols(*a):
                counts[sym] = counts.get(sym, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    count(k1, "psf1d_dc_plain", lambda e, s, *a: [k1.SYMBOLS[s.dtype]])
    count(k1, "psf1d_dc_bwd_plain", lambda g, s, *a: [k1.BWD_SYMBOLS[s.dtype]])
    count(k2, "full_dc_plain", lambda *a: ["k2_expand", "k2_residual", "k2_reduce"])
    count(k2, "full_dc_bwd_plain", lambda *a: ["k2_expand", "k2_mask", "k2_reduce_acc"])
    count(k2, "sens_reduce_plain", lambda *a: ["k2_load", "k2_reduce"])
    count(k3, "indrnn_plain", lambda x, *a: [k3.SYMBOLS[x.dtype]])
    count(k3, "indrnn_bwd_plain", lambda g, x, *a: [k3.BWD_SYMBOLS[x.dtype]])
    count(k4, "edge_pad_plain", lambda x, *a, **kw: [k4.PAD_SYMBOLS[x.dtype]])
    count(k4, "edge_pad_bwd_plain", lambda g, *a, **kw: [k4.PAD_BWD_SYMBOLS[g.dtype]])
    count(k4, "bias_act_plain", lambda y, *a, **kw: [k4.ACT_SYMBOLS[y.dtype]])
    count(k4, "bias_act_bwd_plain",
          lambda g, out, act, want_db: [k4.ACT_BWD_SYMBOLS[g.dtype]] if act or want_db else [])

    for name, (ds, over, _, p8) in chip_smoke.D2_RUNS.items():  # p8: phase 8's run
        cfg = chip_smoke.flagship_cfg(fft_centered=ds["fft_centered"], fft_normalization=ds["fft_normalization"],
                                      conv_filters=[16, 16, 2], recurrent_filters=[16, 16, 0], **over)
        assert cfg["num_cascades"] == 5 and cfg["time_steps"] == 8 and not cfg["fft_centered"]
        src = chip_smoke.PhantomSource(chip_smoke.d_volumes("d2", 1, 2, 3, 12, 12, seed=0),
                                       factory.build_transforms(ds))
        batch = next(iter(BatchLoader(src, batch_size=2)))
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, optim_cfg=chip_smoke.TRAIN_OPTIM, trainer_cfg=chip_smoke.TRAIN_CFG, device="cpu")
        counts.clear()
        trainer.training_batch(batch)
        assert "initial_prediction" in batch
        assert counts == chip_smoke.data_per_step(name), name
        assert {k: v for k, v in counts.items() if not k.startswith("k2_")} == {
            k: v for k, v in chip_smoke.PER_STEP[p8].items() if not k.startswith("k2_")}


def _hooked_trainer(dataset_dir, tmp_path, trainer_cfg, exp=True, writer=None):
    """A small CIRIM trainer on the psf1d fixture data with an experiment
    manager in ``tmp_path`` (its writer replaced by ``writer``)."""
    from mridc_tpu_torch.train.exp_manager import ExpManager

    train, val = _ds(dataset_dir, "psf1d")
    cfg = _model_cfg("psf1d")
    em = ExpManager(exp_dir=str(tmp_path), name="cirim", model_config=cfg) if exp else None
    if writer is not None:
        em.writer = writer
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg=trainer_cfg, exp_manager=em, log_images_limit=1, device="cpu")
    return tt, factory.build_dataloader(train, device="cpu"), factory.build_dataloader(val, device="cpu")


def test_sigterm_ends_fit_returns_its_history_and_saves_last(dataset_dir, tmp_path):
    """SIGTERM during step 1 (sent in this process): fit ends after that step,
    returns its history, saves ``last`` at step 1, and puts the previous
    handler back (F4)."""
    import os
    import signal

    from mridc_tpu_torch.train.checkpoints import StepCheckpointer

    tt, train, val = _hooked_trainer(dataset_dir, tmp_path, {"max_epochs": 2})
    step = tt.training_batch
    tt.training_batch = lambda b: (os.kill(os.getpid(), signal.SIGTERM), step(b))[1]
    before = signal.getsignal(signal.SIGTERM)
    history = tt.fit(train, val)
    assert history == [] and tt.state.step == 1
    assert signal.getsignal(signal.SIGTERM) is before
    ckpt = StepCheckpointer(tt.exp_manager.checkpoint_dir)
    assert int(ckpt.restore_last()["step"]) == 1
    assert (tt.exp_manager.log_dir / "cirim.mridc").exists()


def test_profile_dir_writes_a_trace(dataset_dir, tmp_path):
    """trainer.profile_dir traces steps [profile_start_step, + profile_steps)
    into a Chrome trace there, on the CPU too (F4)."""
    tt, train, _ = _hooked_trainer(dataset_dir, tmp_path, {
        "max_steps": 3, "profile_dir": str(tmp_path / "profile"), "profile_start_step": 1, "profile_steps": 1},
        exp=False)
    tt.fit(train)
    traces = list((tmp_path / "profile").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


class _Writer:
    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images.append((tag, img.shape, int(step)))

    def flush(self):
        pass


def test_exp_manager_logs_scalars_images_and_checkpoints(dataset_dir, tmp_path):
    """With an experiment manager: train_loss on every logging step, the
    validation metrics and a top-k checkpoint at each validation, image
    triplets of the first log_images_limit batches, and at the end ``last``
    and the archive of the best weights."""
    writer = _Writer()
    tt, train, val = _hooked_trainer(dataset_dir, tmp_path, {"max_epochs": 1, "log_every_n_steps": 1},
                                     writer=writer)
    tt.fit(train, val)
    steps = tt.state.step
    assert [s for t, _, s in writer.scalars if t == "train_loss"] == list(range(1, steps + 1))
    val_tags = {t for t, _, s in writer.scalars if s == steps and t != "train_loss"}
    assert val_tags == {"val_loss", "val_MSE", "val_NMSE", "val_PSNR", "val_SSIM"}
    assert writer.images and all(t.startswith("val/batch0_") and shape[0] == 1 for t, shape, _ in writer.images)
    ckpts = sorted(p.name for p in tt.exp_manager.checkpoint_dir.iterdir())
    assert ckpts == sorted([str(steps), "last"])
    from mridc_tpu_torch.train.checkpoints import restore_model

    model, _, cfg = restore_model(tt.exp_manager.log_dir / "cirim.mridc", device="cpu")
    assert cfg == _model_cfg("psf1d")
    for k, v in tt.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
