"""Port parity: the training path of mridc_tpu_torch against mridc_tpu's on the
CPU — the SSIM and reconstruction losses, the learning-rate schedules, CIRIM's
train-mode loss and gradients under every remat_mode, and Trainer steps with
Adam — with the same weights and numpy inputs on both sides.

Tolerance rtol 2e-3 / atol 2e-4 (of the largest magnitude) for the model and
the trainer, the one ``tests/test_torch_parity.py`` holds the JAX package to;
rtol 1e-5 for the losses (float32, one reduction order apart); schedules to
5 float32 ulps.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.losses.ssim import ssim_loss as jssim
from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.models.base import ModelOutput as JOut
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train import schedulers as jsched
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu.train.trainer import TrainState as JTrainState
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch.losses.ssim import ssim_loss
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.models.base import ModelOutput
from mridc_tpu_torch.train import schedulers as tsched
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.optim import get_optimizer
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import cirim_params_from_jax
from test_torch_port_cirim import _cfg, _jax_params

RTOL, ATOL = 2e-3, 2e-4
B, C, H, W = 2, 3, 16, 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _data(seed=0, h=H, w=W):
    """Unit-RSS maps, a 1D column mask (exact for both dc_modes), masked
    k-space and a complex target, as real views."""
    rng = np.random.default_rng(seed)
    shape = (B, C, h, w)
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = np.zeros((B, 1, h, w), np.float32)
    mask[..., ::3] = 1.0
    mask[..., w // 2 - 2 : w // 2 + 2] = 1.0
    target = (rng.standard_normal((B, h, w)) + 1j * rng.standard_normal((B, h, w))).astype(np.complex64)
    rv = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)  # noqa: E731
    return rv(y * mask), rv(sens), mask, rv(target)


# ---- losses ----


def test_ssim_loss_value_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    x, y = rng.random((2, 1, 21, 19)).astype(np.float32), rng.random((2, 1, 21, 19)).astype(np.float32)
    rng_ = np.array([1.0, 0.7], np.float32)
    want, want_g = jax.value_and_grad(lambda a: jssim(a, jnp.asarray(y), jnp.asarray(rng_)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = ssim_loss(tx, torch.from_numpy(y), torch.from_numpy(rng_))
    got.backward()
    _close(got, want, 1e-5, 1e-6)
    _close(tx.grad, want_g, 1e-4, 1e-6)


LOSS_CASES = {
    "l1": dict(loss="l1"),
    "l2": dict(loss="l2"),
    "ssim": dict(loss="ssim"),
    "l1_prediction_only": dict(loss="l1", intermediates=False),
    "kspace_l2": dict(loss="l2", kspace=True),
    "kspace_l1_loss_mask": dict(loss="l1", kspace=True, loss_mask=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_process_reconstruction_loss_value_and_gradient_match_jax(case):
    spec = LOSS_CASES[case]
    _, sens, mask, target = _data(2)
    rng = np.random.default_rng(3)
    inter = rng.standard_normal((2, 3, B, H, W, 2)).astype(np.float32)
    loss_mask = (rng.random((B, 1, H, W)) < 0.5).astype(np.float32) if spec.get("loss_mask") else None
    with_inter = spec.get("intermediates", True)
    kw = dict(loss_type=spec["loss"], regularization_factor=0.5, kspace_loss=spec.get("kspace", False),
              fft_centered=True, fft_normalization="ortho")

    def jfn(a):
        out = JOut(prediction=a[-1, -1], intermediates=a if with_inter else None)
        return jloss(out, jnp.asarray(target), loss_mask=None if loss_mask is None else jnp.asarray(loss_mask),
                     sensitivity_maps=jnp.asarray(sens), **kw)

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(inter))
    ti = torch.from_numpy(inter).requires_grad_(True)
    out = ModelOutput(prediction=ti[-1, -1], intermediates=ti if with_inter else None)
    got = process_reconstruction_loss(out, torch.from_numpy(target),
                                      loss_mask=None if loss_mask is None else torch.from_numpy(loss_mask),
                                      sensitivity_maps=torch.from_numpy(sens), **kw)
    got.backward()
    _close(got, want, 1e-5, 1e-6)
    _close(ti.grad, want_g, 1e-4, 1e-6)


def test_norm_mag_ties_share_the_gradient():
    """Tied maxima split the gradient of the max normalisation, as in JAX.
    The pixel (1, 0) is 0: JAX's gradient there is NaN (sqrt's at 0), the
    port's is 0 (``train/losses.py:_mag``); every other entry as in JAX."""
    x = np.zeros((1, 2, 2, 2), np.float32)
    x[0, 0, 0, 0] = x[0, 1, 1, 0] = 2.0
    x[0, 0, 1, 1] = 1.0
    t = np.full((1, 2, 2, 2), 0.3, np.float32)
    want_g = np.asarray(jax.grad(lambda a: jloss(JOut(prediction=a), jnp.asarray(t), "l2"))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    process_reconstruction_loss(ModelOutput(prediction=tx), torch.from_numpy(t), "l2").backward()
    zero = np.zeros(x.shape, bool)
    zero[0, 1, 0] = True
    assert np.isnan(want_g[zero]).all() and np.isfinite(want_g[~zero]).all()
    assert (tx.grad.numpy()[zero] == 0).all()
    _close(tx.grad.numpy()[~zero], want_g[~zero], 1e-5, 1e-7)


# ---- schedules ----


def _schedule_kwargs(name):
    kw = {"max_steps": 40, "warmup_steps": 5, "min_lr": 1e-5}
    if name in ("NoamHoldAnnealing", "WarmupHoldPolicy", "PolynomialHoldDecayAnnealing"):
        kw["hold_steps"] = 6
    if name == "CosineAnnealing":
        kw["constant_steps"] = 4
    if name == "CyclicLR":
        kw = {"step_size_up": 7, "mode": "triangular2"}
    if name in ("StepLR", "ExponentialLR"):
        kw = {"gamma": 0.8} if name == "ExponentialLR" else {"step_size": 6, "gamma": 0.5}
    return kw


@pytest.mark.parametrize("name", sorted(jsched.AVAILABLE_SCHEDULERS))
def test_schedule_matches_jax_over_50_steps(name):
    kw = _schedule_kwargs(name)
    want_sched = jsched.get_scheduler(name, 1e-3, **kw)
    got_sched = tsched.get_scheduler(name, 1e-3, **kw)
    if name == "ReduceLROnPlateau":
        for metric in (1.0, 0.9, 0.95, 0.96, 0.97, 0.98):
            assert want_sched.update(metric) == got_sched.update(metric)
    want = np.array([np.float32(want_sched(k)) for k in range(50)])
    got = np.array([np.float32(got_sched(k)) for k in range(50)])
    assert got.dtype == np.float32
    # float32 throughout; XLA's and numpy's float32 cos, sqrt and pow round a
    # few ulps apart (read: 4.0e-7 relative, CosineAnnealing), so 5 ulps
    np.testing.assert_allclose(got, want, rtol=6e-7, atol=0)


def test_prepare_lr_schedule_infers_max_steps_like_jax():
    optim = {"name": "adam", "lr": 3e-3, "sched": {"name": "InverseSquareRootAnnealing", "warmup_ratio": 0.1}}
    trainer_cfg = {"max_epochs": 3}
    want = jsched.prepare_lr_schedule(dict(optim), 40, 4, trainer_cfg)
    got = tsched.prepare_lr_schedule(dict(optim), 40, 4, trainer_cfg)
    np.testing.assert_allclose([got(k) for k in range(35)], [float(want(k)) for k in range(35)], rtol=6e-7)
    assert tsched.compute_max_steps(5, 2, 1.0, 0, 100, 10, False) == 25


# ---- CIRIM in train mode ----

CIRIM_CASES = [(dc, remat) for dc in ("psf1d", "full") for remat in ("step+cascade", "cascade", "step", "none")]


def _jax_loss_and_grads(cfg, params, y, sens, mask, target):
    model = jax_build_model(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(y), jnp.asarray(sens), jnp.asarray(mask), train=True)
        return jloss(out, jnp.asarray(target), "l1")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), cirim_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(cfg, params, y, sens, mask, target):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(cirim_params_from_jax(params))
    out = model(*(torch.from_numpy(a) for a in (y, sens, mask)), train=True)
    loss = process_reconstruction_loss(out, torch.from_numpy(target), "l1")
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dc_mode,remat_mode", CIRIM_CASES)
def test_cirim_train_loss_and_gradients_match_jax_grad(dc_mode, remat_mode):
    cfg = _cfg(dc_mode=dc_mode, remat_mode=remat_mode)
    y, sens, mask, target = _data(4)
    params = _jax_params(cfg, y, sens, mask, seed=7)
    want_loss, want = _jax_loss_and_grads(cfg, params, y, sens, mask, target)
    got_loss, got = _port_loss_and_grads(cfg, params, y, sens, mask, target)
    assert sorted(got) == sorted(want)
    _close(got_loss, want_loss)
    for k in want:
        assert float(want[k].abs().max()) > 0, k
        _close(got[k], want[k].numpy())


def test_cirim_soft_dc_trains_on_the_cpu_like_jax():
    """The soft-DC tail's SENSE reduction is plain autograd on the CPU."""
    cfg = _cfg(dc_mode="full", remat_mode="step", no_dc=False)
    y, sens, mask, target = _data(5, 16, 15)
    params = _jax_params(cfg, y, sens, mask, seed=8)
    want_loss, want = _jax_loss_and_grads(cfg, params, y, sens, mask, target)
    got_loss, got = _port_loss_and_grads(cfg, params, y, sens, mask, target)
    _close(got_loss, want_loss)
    assert any(k.endswith("dc_weight") for k in want)
    for k in want:
        if got[k] is None:
            # the loss reads the steps' estimates, not the soft-DC output, nor
            # does the detached chaining: jax.grad gives exact zeros there
            assert k.endswith("dc_weight") and float(want[k].abs().max()) == 0, k
            continue
        _close(got[k], want[k].numpy())


def test_cirim_train_mode_runs_the_dc_in_train_dc_dtype():
    """train_dc_dtype (bf16) only in train mode; inference keeps infer_dc_dtype."""
    from mridc_tpu_torch.kernels import k1_psf1d_dc as k1

    y, sens, mask, _ = _data(6)
    cfg = _cfg(dc_mode="psf1d", train_dc_dtype="bfloat16", infer_dc_dtype=None, num_cascades=1, time_steps=1)
    model = build_model(cfg, device="cpu")
    seen = []
    orig = k1.psf1d_dc_plain
    k1.psf1d_dc_plain = lambda eta, *a: (seen.append(eta.dtype), orig(eta, *a))[1]
    try:
        args = [torch.from_numpy(a) for a in (y, sens, mask)]
        model(*args, train=True)
        with torch.no_grad():
            model(*args)
    finally:
        k1.psf1d_dc_plain = orig
    assert seen == [torch.bfloat16, torch.float32]


# ---- the launch counts chip_smoke.py asserts, on the CPU path ----


def test_chip_smoke_per_step_counts_hold_on_the_cpu_path(monkeypatch):
    """chip_smoke.PER_STEP derives the kernel launches of a flagship training
    step (5 x 8, remat step+cascade) from the checkpoint structure; the CPU
    path calls each kernel's plain version in the same places, so counting
    those calls in one training step must give the same table."""
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

    y, sens, mask, target = _data(9, 12, 12)
    cfgs = {
        "train_bf16_psf1d": chip_smoke.flagship_cfg(conv_filters=[16, 16, 2], recurrent_filters=[16, 16, 0]),
        "train_f32_psf1d": chip_smoke.flagship_cfg(conv_filters=[8, 8, 2], recurrent_filters=[8, 8, 0],
                                                   compute_dtype=None),
        "train_f32_full": chip_smoke.flagship_cfg(conv_filters=[8, 8, 2], recurrent_filters=[8, 8, 0],
                                                  compute_dtype=None, dc_mode="full"),
    }
    for name, cfg in cfgs.items():
        assert cfg["num_cascades"] == 5 and cfg["time_steps"] == 8 and cfg.get("remat_mode") is None
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, optim_cfg=chip_smoke.TRAIN_OPTIM, trainer_cfg=chip_smoke.TRAIN_CFG, device="cpu")
        counts.clear()
        trainer.training_batch({"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target})
        assert counts == chip_smoke.PER_STEP[name], name


# ---- Trainer against mridc_tpu's ----

TRAINER_CASES = {
    "adam_isr": dict(trainer_cfg={"max_steps": 30}, ema=False),
    "adam_isr_clip_ema": dict(trainer_cfg={"max_steps": 30, "gradient_clip_val": 0.05}, ema=True),
}
OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
         "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_three_trainer_steps_give_optax_parameters(case):
    spec = TRAINER_CASES[case]
    cfg = _cfg(dc_mode="psf1d", num_cascades=1)
    y, sens, mask, target = _data(10)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    params = _jax_params(cfg, y, sens, mask, seed=11)

    jt = JTrainer(jax_build_model(cfg), optim_cfg=OPTIM, trainer_cfg=spec["trainer_cfg"], loss_type="l1",
                  use_ema=spec["ema"], mesh=make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    jt.state = JTrainState.create(params, jt._tx, ema=spec["ema"])
    want_losses = [float(jt.training_batch(batch)["loss"]) for _ in range(3)]

    model = build_model(cfg, device="cpu")
    model.load_state_dict(cirim_params_from_jax(params))
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg=spec["trainer_cfg"], loss_type="l1", use_ema=spec["ema"],
                 device="cpu")
    tt.setup_optimization()
    tt.init_state(batch)
    got = [tt.training_batch(batch) for _ in range(3)]
    _close([float(m["loss"]) for m in got], want_losses)
    assert tt.state.step == 3 and int(jt.state.step) == 3

    want_params = cirim_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for k, p in model.named_parameters():
        _close(p, want_params[k].numpy())
    if spec["ema"]:
        want_ema = cirim_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.ema_params))
        for k, e in tt.state.ema_params.items():
            _close(e, want_ema[k].numpy())
        pred = tt.predict_batch(batch, use_ema=True)
        want_pred = np.asarray(jt.predict_batch(batch, use_ema=True))
        _close(pred, want_pred)


def test_trainer_schedule_counts_updates_from_zero():
    """Update k runs at sched(k), k = 0, 1, ...: optax's count semantics."""
    cfg = _cfg(dc_mode="psf1d", num_cascades=1, time_steps=1)
    y, sens, mask, target = _data(12)
    tt = Trainer(build_model(cfg, device="cpu"), optim_cfg=OPTIM, trainer_cfg={"max_steps": 30}, device="cpu")
    seen = []
    step = tt.init_state().optimizer.step

    def spy(*a, **kw):
        seen.append(tt.state.optimizer.param_groups[0]["lr"])
        return step(*a, **kw)

    tt.state.optimizer.step = spy
    for _ in range(4):
        tt.training_batch({"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target})
    assert seen == [float(tt.schedule(k)) for k in range(4)]
    assert seen[0] == pytest.approx(1e-3 * 1 / 4)


# ---- entry points and what is not ported ----


def test_trainer_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(_cfg(num_cascades=1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model)
    assert Trainer(model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["sgd", "adamw", "adadelta", "adamax", "adagrad", "rmsprop", "rprop", "novograd",
                                  "adafactor", "radam", "lamb"])
def test_unported_optimizers_raise_with_their_roadmap_item(name):
    """The 11 optimizers that raised until M5 was ported now build and step
    (each is held against optax in test_torch_port_selfsup.py)."""
    p = torch.ones(2, requires_grad=True)
    opt = get_optimizer(name, [p], 1e-1)
    assert isinstance(opt, torch.optim.Optimizer)
    for _ in range(2):  # rprop applies the previous iteration's step
        p.grad = torch.tensor([1.0, -2.0])
        opt.step()
    assert not torch.equal(p.detach(), torch.ones(2))


def test_unported_training_branches_raise():
    """The SSDU and noise2recon branches and gradient accumulation that raised
    until M5 was ported now run a CIRIM step each (each is held against the
    JAX trainer in test_torch_port_selfsup.py)."""
    model = build_model(_cfg(num_cascades=1), device="cpu")
    y, sens, mask, target = _data(13)
    batch = {"masked_kspace": y, "sensitivity_maps": sens, "mask": mask, "target": target}
    ssdu = {**batch, "mask": np.stack([mask, 1 - mask], 1)}
    assert np.isfinite(float(Trainer(model, ssdu=True, device="cpu").training_batch(ssdu)["loss"]))
    n2r = {**batch, "n2r_masked_kspace": y, "n2r_mask": mask}
    assert np.isfinite(float(Trainer(model, device="cpu").training_batch(n2r)["loss"]))
    tt = Trainer(model, trainer_cfg={"accumulate_grad_batches": 2}, device="cpu")
    tt.setup_optimization()
    assert np.isfinite(float(tt.training_batch(batch)["loss"])) and tt.state.mini_step == 1
