"""Port parity: the self-supervised training branches, gradient accumulation,
the optimizers and a parameterless model's step, against mridc_tpu on the
CPU; and ``python -m mridc_tpu_torch run -c`` of
projects/unselfsupervised/conf's SSDU and Noise2Recon configs against
``mridc_tpu.launch.run_from_config``.

- SSDU (ResNet with its CG DC, the k-space loss on the loss mask),
  Noise2Recon (UNet; the supervised term, the consistency term, and
  base_n2r_fullunsup_train.yaml's ssdu + n2r) and accumulation at 2 over 4
  micro-steps (UNet; clipping, a schedule and EMA on, as optax.MultiSteps
  orders them): per-step losses and the parameters after 3-4 ``Trainer``
  steps against the JAX trainer's, from the same weights (carried across by
  the ``*_params_from_jax`` functions), at rtol 2e-3 / atol 2e-4 of the
  largest magnitude (``tests/test_torch_parity.py:131``). Dropout is 0, as
  in every ``projects/`` config (its random draws cannot match bit for bit).
- Each of the 11 optimizers besides adam: three steps against optax, with
  its defaults and with the hyperparameters its builder reads (weight decay,
  momentum, a schedule), at rtol 1e-4 / atol 1e-6 of the largest magnitude.
- ZF: the JAX trainer's loss and a ``grad_norm`` of 0.
- The config runs: the YAMLs cut to size by overrides (4 coils, 32 x 32, one
  epoch of 6 steps, narrow models; the fixture's fastMRI layout in place of
  stanford_knees'; seeded validation masks), on ``tests/fixtures.py`` h5
  volumes, both packages starting from one ``pretrained: true`` archive that
  ``mridc_tpu`` wrote; per-step losses at rtol 2e-3.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mridc_tpu import launch as jlaunch
from mridc_tpu.data import factory as jfactory
from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import config as jconfig
from mridc_tpu.train import optim as joptim
from mridc_tpu.train.trainer import TrainState as JTrainState
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch import cli
from mridc_tpu_torch.data import factory
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.train import optim
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import resnet_params_from_jax, unet_params_from_jax

from fixtures import create_dataset

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "projects/unselfsupervised/conf"
RTOL, ATOL = 2e-3, 2e-4
B, C, H, W = 2, 4, 32, 32
OPTIM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 1e-4,
         "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}
RESNET = {"model_name": "ResNet", "unrolled_iterations": 2, "residual_blocks": 2, "channels": 8,
          "regularization_factor": 1.0, "penalization_weight": 0.0, "conjugate_gradient_dc": True,
          "conjugate_gradient_iterations": 4, "fft_centered": True, "fft_normalization": "ortho"}
UNET = {"model_name": "UNet", "channels": 8, "pooling_layers": 2, "fft_centered": True, "fft_normalization": "ortho"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1e-30, float(np.abs(want).max())),
                               err_msg=what)


def _batch(seed, ssdu=False, n2r=False, supervised=(False, False)):
    """A centered-ortho batch: unit-RSS maps, a random 2D mask (an SSDU
    batch carries [train, loss] masks [B, 2, 1, H, W] that split it),
    masked k-space, a complex target; with ``n2r`` the noisier k-space, its
    mask and the slices' ``n2r_supervised`` attributes."""
    rng = np.random.default_rng(seed)
    shape = (B, C, H, W)
    rv = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)  # noqa: E731
    sens = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = (rng.random((B, 1, H, W)) < 0.4).astype(np.float32)
    mask[..., H // 2 - 3 : H // 2 + 3, W // 2 - 3 : W // 2 + 3] = 1
    kspace = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    batch = {"sensitivity_maps": rv(sens), "target": rv(rng.standard_normal((B, H, W)) + 0j),
             "attrs": [{"n2r_supervised": s} for s in supervised]}
    train = mask
    if ssdu:
        split = (rng.random(mask.shape) < 0.6).astype(np.float32)
        train = mask * split
        batch["mask"] = np.stack([train, mask * (1 - split)], 1)
    else:
        batch["mask"] = mask
    batch["masked_kspace"] = rv(kspace * train)
    if n2r:
        noisy = (rng.random(mask.shape) < 0.7).astype(np.float32) * train
        batch["n2r_mask"] = noisy
        batch["n2r_masked_kspace"] = rv((kspace + 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
                                        * noisy)
    return batch


def _params(cfg, seed):
    """Numpy leaves in the flax tree's shapes: kernels normal with variance
    1 / fan-in, biases small, mu at 0.01."""
    y = np.zeros((B, C, H, W, 2), np.float32)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), y, y, np.ones((B, 1, H, W), np.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if path[-1].key == "mu":
            return np.full(s.shape, 0.01, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes.get("params", {}))


def _to_port(cfg, params):
    name = cfg["model_name"].upper()
    state = unet_params_from_jax(params) if name == "UNET" else (
        resnet_params_from_jax(params) if name == "RESNET" else {})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    return model, state


def _run_both(cfg, batches, trainer_cfg=None, **kw):
    """Per-step losses and final parameters (and EMA weights) of the JAX and
    the port trainers over ``batches`` from the same weights."""
    params = _params(cfg, seed=3)
    jt = JTrainer(jax_build_model(cfg), optim_cfg=OPTIM, trainer_cfg=dict(trainer_cfg or {}), loss_type="l1",
                  mesh=make_mesh(1), **kw)
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batches[0])
    jt.state = JTrainState.create(params, jt._tx, ema=jt.use_ema)
    jlosses = [float(jt.training_batch(b)["loss"]) for b in batches]
    model, _ = _to_port(cfg, jax.tree_util.tree_map(np.asarray, params))
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg=dict(trainer_cfg or {}), loss_type="l1", device="cpu", **kw)
    tt.setup_optimization()
    tt.init_state(batches[0])
    tlosses = [float(tt.training_batch(b)["loss"]) for b in batches]
    _close(tlosses, jlosses, what="per-step losses")
    fn = unet_params_from_jax if cfg["model_name"] == "UNet" else resnet_params_from_jax
    want = fn(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for k, p in model.named_parameters():
        _close(p, want[k].numpy(), what=k)
    return jt, tt


# ---- the training branches against the JAX trainer ----


def test_ssdu_steps_match_jax():
    """SSDU: the model takes the train mask, the k-space loss gates with the
    loss mask (mask[:, 1]); mu starts at 0 in the CG."""
    batches = [_batch(s, ssdu=True) for s in range(3)]
    jt, tt = _run_both(RESNET, batches, ssdu=True, kspace_reconstruction_loss=True)
    assert tt.state.step == int(jt.state.step) == 3


@pytest.mark.parametrize("branch", ["consistency", "supervised", "ssdu+n2r"])
def test_noise2recon_steps_match_jax(branch):
    """Noise2Recon: the consistency term (a second forward on the noisier
    k-space against the first's prediction, n2r_loss_weight 0.1), the
    supervised term when any slice is n2r-supervised, and, with ssdu, the
    k-space supervised term on the loss mask (base_n2r_fullunsup_train.yaml)."""
    sup = (True, False) if branch == "supervised" else (False, False)
    batches = [_batch(10 + s, ssdu=branch == "ssdu+n2r", n2r=True, supervised=sup) for s in range(3)]
    _run_both(UNET, batches, trainer_cfg={"n2r_loss_weight": 0.1}, loss_regularization_factor=0.9,
              ssdu=branch == "ssdu+n2r")



def test_noise2recon_step_on_an_empty_noise_mask_stays_finite():
    """The configs' noise std is 0, so the n2r masker's draw (probability
    0.2) masks the noisier input to nothing: from the flax init (zero biases)
    the second forward predicts exactly 0. The JAX package's magnitude takes
    sqrt's gradient there and every gradient is NaN; the port's is 0 there.
    The loss equals the JAX trainer's, and each gradient equals ``jax.grad``
    of the same consistency loss with the (constant) zero prediction as its
    input, elementwise at RTOL / ATOL x max."""
    from mridc_tpu.models.base import ModelOutput as JModelOutput
    from mridc_tpu.train.losses import process_reconstruction_loss as jloss

    batch = _batch(10, n2r=True)
    batch["n2r_mask"] = np.zeros_like(batch["n2r_mask"])
    batch["n2r_masked_kspace"] = np.zeros_like(batch["n2r_masked_kspace"])
    jmodel = jax_build_model(UNET)
    jt = JTrainer(jmodel, optim_cfg=OPTIM, trainer_cfg={"n2r_loss_weight": 0.1}, loss_type="l1",
                  mesh=make_mesh(1), loss_regularization_factor=0.9)
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    want_loss = float(jt.training_batch(batch)["loss"])
    y, sens, mask = (jnp.asarray(batch[k]) for k in ("masked_kspace", "sensitivity_maps", "mask"))
    zero = jnp.zeros(y.shape[:1] + y.shape[2:])

    def consistency(p):
        out = jmodel.apply({"params": p}, y, sens, mask, train=True)
        return 0.1 * jloss(JModelOutput(prediction=zero), out.prediction, "l1", 0.9, sensitivity_maps=sens,
                           fft_centered=True, fft_normalization="ortho")

    want = unet_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(consistency)(params)))
    model, _ = _to_port(UNET, params)
    with torch.no_grad():
        noisy = model(*(torch.as_tensor(batch[k]) for k in ("n2r_masked_kspace", "sensitivity_maps", "n2r_mask")))
    assert not noisy.prediction.any()
    tt = Trainer(model, optim_cfg=OPTIM, trainer_cfg={"n2r_loss_weight": 0.1}, loss_type="l1", device="cpu",
                 loss_regularization_factor=0.9)
    tt.setup_optimization()
    got = tt.training_batch(batch)
    _close(float(got["loss"]), want_loss, what="loss")
    assert np.isfinite(float(got["grad_norm"])) and float(got["grad_norm"]) > 0
    for k, p in model.named_parameters():
        assert torch.isfinite(p).all(), k
        _close(p.grad, want[k].numpy(), what=k)

def test_gradient_accumulation_matches_optax_multisteps():
    """accumulate_grad_batches=2 over 4 micro-steps: 2 optimizer steps on the
    running mean of their micro-steps' gradients, clipped there (the clip
    bites), at the schedule's rate for the optimizer step; state.step and the
    EMA advance every micro-step, as in optax.MultiSteps and the JAX tail."""
    cfg = {"gradient_clip_val": 0.05, "accumulate_grad_batches": 2, "max_steps": 10}
    batches = [_batch(20 + s) for s in range(4)]
    jt, tt = _run_both(UNET, batches, trainer_cfg=cfg, use_ema=True, ema_decay=0.9)
    assert tt.state.step == int(jt.state.step) == 4
    assert tt.state.gradient_step == int(jt.state.opt_state.gradient_step) == 2
    assert tt.state.mini_step == int(jt.state.opt_state.mini_step) == 0
    want = unet_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.ema_params))
    for k, e in tt.state.ema_params.items():
        _close(e, want[k].numpy(), what=f"ema {k}")


def test_accumulation_steps_only_every_k_micro_steps():
    model = build_model(UNET, device="cpu")
    tt = Trainer(model, optim_cfg={"name": "sgd", "lr": 0.1}, trainer_cfg={"accumulate_grad_batches": 3},
                 device="cpu")
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    moved = []
    for s in range(3):
        tt.training_batch(_batch(30 + s))
        moved.append(any(not torch.equal(p, start[k]) for k, p in model.named_parameters()))
    assert moved == [False, False, True]
    assert (tt.state.step, tt.state.gradient_step, tt.state.mini_step) == (3, 1, 0)
    state = tt.state_dict()
    assert state["gradient_step"] == 1 and state["mini_step"] == 0 and len(state["acc_grads"]) == len(start)


def test_parameterless_model_trains_to_the_jax_loss():
    """ZF (base_zf_train.yaml): the loss of the JAX trainer's step on its
    empty parameter tree, and optax.global_norm of no gradients, 0."""
    cfg = {"model_name": "ZF", "fft_centered": True, "fft_normalization": "ortho"}
    batch = _batch(40)
    jt = JTrainer(jax_build_model(cfg), optim_cfg=OPTIM, loss_type="l1", mesh=make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    want = jt.training_batch(batch)
    tt = Trainer(build_model(cfg, device="cpu"), optim_cfg=OPTIM, loss_type="l1", device="cpu", use_ema=True)
    got = tt.training_batch(batch)
    _close(float(got["loss"]), float(want["loss"]))
    assert float(got["grad_norm"]) == float(want["grad_norm"]) == 0.0
    assert tt.state.optimizer is None and tt.state.step == 1
    assert tt.state_dict()["optimizer"] is None


# ---- the optimizers against optax ----

OPT_KWARGS = {
    "sgd": {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-2},
    "adamw": {"betas": [0.8, 0.95], "eps": 1e-7, "weight_decay": 5e-2},
    "adadelta": {"rho": 0.8, "eps": 1e-5, "weight_decay": 1e-2},
    "adamax": {"betas": [0.8, 0.95], "eps": 1e-6, "weight_decay": 1e-2},
    "adagrad": {"eps": 1e-8, "weight_decay": 1e-2},
    "rmsprop": {"alpha": 0.9, "eps": 1e-6, "momentum": 0.9, "weight_decay": 1e-2},
    "rprop": {"etas": [0.4, 1.3]},
    "novograd": {"betas": [0.9, 0.95], "eps": 1e-6, "weight_decay": 1e-2},
    "adafactor": {"weight_decay": 1e-2},
    "radam": {"betas": [0.9, 0.99], "eps": 1e-7, "weight_decay": 1e-2},
    "lamb": {"betas": [0.8, 0.95], "eps": 1e-5, "weight_decay": 1e-2},
}


@pytest.mark.parametrize("kwargs", ["defaults", "set"])
@pytest.mark.parametrize("name", sorted(OPT_KWARGS))
def test_optimizer_matches_optax(name, kwargs):
    """Three steps on a conv kernel that adafactor factors (HWIO 3x3x128x160
    in optax, OIHW in the port), a bias and a small matrix, from random
    gradients, at a rate that changes every step (rprop: its constant
    initial step size, as optax takes it)."""
    kw = OPT_KWARGS[name] if kwargs == "set" else {}
    rng = np.random.default_rng(len(name))
    shapes = {"kernel": (3, 3, 128, 160), "bias": (160,), "matrix": (5, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    rate = lambda k: 1e-2 * (k + 1) / 3  # noqa: E731
    tx = joptim.get_optimizer(name, 1e-2 if name == "rprop" else (lambda c: rate(c)), **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    to_port = {"kernel": lambda a: np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))}
    tp = {k: torch.from_numpy(to_port.get(k, lambda a: a)(v).copy()).requires_grad_(True) for k, v in params.items()}
    opt = optim.get_optimizer(name, list(tp.values()), 1e-2, **kw)
    for step, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(to_port.get(k, lambda a: a)(g[k]).copy())
        for group in opt.param_groups:
            group["lr"] = 1e-2 if name == "rprop" else rate(step)
        opt.step()
        for k, p in tp.items():
            _close(p, to_port.get(k, lambda a: a)(np.asarray(jp[k])), 1e-4, 1e-6, what=f"{name} step {step} {k}")


def test_every_optimizer_name_of_the_jax_registry_builds():
    assert sorted(optim.AVAILABLE_OPTIMIZERS) == sorted(joptim.AVAILABLE_OPTIMIZERS)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optim.get_optimizer("adamm", [torch.zeros(2, requires_grad=True)], 1e-3)


# ---- the config runs against mridc_tpu.launch ----


def _seeded_transforms(monkeypatch):
    """Both packages' transforms draw the SSDU split and the Noise2Recon mask
    from a seeded RandomState (the configs leave them to fresh ones)."""
    for mod in (factory, jfactory):
        orig = mod.build_transforms

        def build(*a, _orig=orig, **kw):
            tfm = _orig(*a, **kw)
            for name, seed in (("ssdu_masking", 6), ("n2r_masking", 5)):
                if getattr(tfm, name, None) is not None:
                    getattr(tfm, name).rng = np.random.RandomState(seed)
            return tfm

        monkeypatch.setattr(mod, "build_transforms", build)


RUNS = {
    "base_ssdu_train": ["model.unrolled_iterations=2", "model.residual_blocks=1", "model.channels=8",
                        "model.conjugate_gradient_iterations=4"],
    "base_n2r_train": ["model.channels=8", "model.pooling_layers=2"],
}


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """3 training volumes (so that the n2r-supervised rate 0.2 picks one) and
    1 validation volume, 2 slices each, 4 coils, 32 x 32."""
    root = tmp_path_factory.mktemp("port_selfsup")
    create_dataset(root / "train", n_files=3, slices=2, coils=4, h=32, w=32, seed=0)
    create_dataset(root / "val", n_files=1, slices=2, coils=4, h=32, w=32, seed=1)
    return root


@pytest.mark.parametrize("name", sorted(RUNS))
def test_config_run_matches_jax(name, volumes, monkeypatch):
    """``cli.main(["run", "-c", <yaml>, ...])`` against the JAX launcher: the
    YAML passes both schemas' checks (``validate_config``), the per-step losses
    agree, the run dirs hold the same names, and the n2r loss weight reaches
    the trainer (``n2r_loss_regularization_factor``)."""
    from mridc_tpu.train import schemas as jschemas
    from mridc_tpu_torch.train import schemas

    yaml_path = CONF / f"{name}.yaml"
    raw = yaml.safe_load(yaml_path.read_text())
    assert schemas.validate_config(raw, strict=False) == jschemas.validate_config(raw, strict=False) == []
    root = volumes
    common = RUNS[name] + [
        "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "trainer.accelerator=cpu",
        f"model.train_ds.data_path={root / 'train'}", f"model.validation_ds.data_path={root / 'val'}",
        "model.validation_ds.use_seed=true", "model.validation_ds.mask_args.use_seed=true",
        # the fixture volumes are fastMRI's layout, [S, C, H, W]; stanford_knees' is [S, H, W, C]
        "model.train_ds.dataset_format=null", "model.validation_ds.dataset_format=null"]
    cfg = jconfig.load_config(yaml_path, common)
    model = jax_build_model(cfg["model"])
    y = np.zeros((1, 4, 32, 32, 2), np.float32)
    params = model.init(jax.random.PRNGKey(3), y, y + 1, np.ones((1, 1, 32, 32), np.float32))["params"]
    archive = jckpt.save_archive(root / f"{name}.mridc", cfg["model"], jax.tree_util.tree_map(np.asarray, params))
    common += ["pretrained=true", f"checkpoint={archive}"]
    runs = {}
    for who, cls, run in (
        ("jax", JTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(yaml_path, o))),
        ("port", Trainer, lambda o: cli.main(["run", "-c", str(yaml_path), *o])),
    ):
        losses, trainers = [], []
        with monkeypatch.context() as m:
            _seeded_transforms(m)
            step = cls.training_batch

            def recording(self, batch, _step=step, _losses=losses, _tr=trainers):
                out = _step(self, batch)
                _losses.append(float(out["loss"]))
                _tr.append(self)
                return out

            m.setattr(cls, "training_batch", recording)
            run(common + [f"exp_manager.exp_dir={root / who / name}"])
        runs[who] = (losses, trainers[0])
    (jl, jt), (pl, pt) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 6  # 3 volumes x 2 slices at batch 1
    _close(pl, jl, what="per-step losses")
    assert pt.trainer_cfg.get("n2r_loss_weight") == jt.trainer_cfg.get("n2r_loss_weight")
    if name == "base_n2r_train":
        assert pt.trainer_cfg["n2r_loss_weight"] == 0.1
    jdir, pdir = (next((root / who / name).glob("*/*")) for who in ("jax", "port"))
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())


def test_chip_smoke_selfsup_configs_are_the_yamls():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for name, cfg in (("base_ssdu_train", chip_smoke.SSDU_CFG), ("base_n2r_train", chip_smoke.N2R_CFG)):
        assert cfg == yaml.safe_load((CONF / f"{name}.yaml").read_text()), name
