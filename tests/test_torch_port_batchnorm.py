"""Port parity of BatchNorm with torch semantics: the frozen mode (running
statistics as parameters, never updated, that the optimizer moves as optax
moves a parameter with a zero gradient) and the live mode (the
``train_batch_stats`` knob: running statistics as buffers, updated in train
mode with the unbiased batch variance), against mridc_tpu's TorchBatchNorm
and its trainer's ``batch_stats``; the statistics through the trainer's
state, step checkpoints and ``.mridc`` archives of both packages; and the
refusals the JAX package makes.

Inputs from a seed with numpy; CascadeNet at 2 cascades of 8 channels, 4
coils, 32x32. Limits: rtol 2e-3 / atol 2e-4 of the largest magnitude
(``tests/test_torch_parity.py:131``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.nn import mwcnn as jmwcnn
from mridc_tpu.nn.layers import TorchBatchNorm
from mridc_tpu.parallel.mesh import make_mesh
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train.trainer import TrainState as JTrainState
from mridc_tpu.train.trainer import Trainer as JTrainer
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.nn import mwcnn as tmwcnn
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train.trainer import Trainer
from mridc_tpu_torch.utils.params import _mwcnn_pairs, zoo2_params_from_jax, zoo2_params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_zoo2 import _block_state, _close, _data, _leaf, _t  # noqa: E402

CCNN = {"model_name": "CascadeNet", "num_cascades": 2, "hidden_channels": 8, "n_convs": 3, "batchnorm": True,
        "fft_centered": False, "fft_normalization": "backward"}
LIVE = {**CCNN, "train_batch_stats": True}
ADAM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.0,
        "sched": {"name": "InverseSquareRootAnnealing", "min_lr": 0.0, "warmup_ratio": 0.1}}
SGD = {"name": "sgd", "lr": 0.05}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return (1.5 + 2.0 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _bn_vars(jmod, x, seed):
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(seed)), dict(shapes))


def _port_bn(v, live, momentum=0.1):
    p = v["params"]
    bn = tlayers.BatchNorm(p["scale"].shape[0], 1e-4, momentum, live)
    src = v["batch_stats"] if live else p
    state = {"weight": p["scale"], "bias": p["bias"], ("running_mean" if live else "mean"): src["mean"],
             ("running_var" if live else "var"): src["var"]}
    bn.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in state.items()})
    return bn


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frozen_batchnorm_matches_jax_in_train_and_eval(dtype):
    """Train mode normalises with the batch's biased statistics, eval with
    the stored ones; nothing is updated; the statistics run in float32 and the
    output comes back in the input's dtype."""
    x = _x((3, 5, 4, 6), 1)
    jmod = TorchBatchNorm(eps=1e-4)
    v = _bn_vars(jmod, x, 2)
    bn = _port_bn(v, live=False)
    before = {k: t.clone() for k, t in bn.state_dict().items()}
    xt = _nchw(x).to(dtype)
    for train in (True, False):
        want = np.asarray(jmod.apply(v, jnp.asarray(xt.float().permute(0, 2, 3, 1).numpy()), train))
        got = bn(xt, train)
        assert got.dtype == dtype
        _close(got.float().permute(0, 2, 3, 1), want, *((2e-3, 2e-4) if dtype == torch.float32 else (2e-2, 2e-2)))
    assert all(torch.equal(before[k], t) for k, t in bn.state_dict().items())


@pytest.mark.parametrize("momentum", [0.1, 0.95])
def test_live_batchnorm_updates_with_the_unbiased_variance(momentum):
    x = _x((2, 3, 5, 4), 3)
    jmod = TorchBatchNorm(eps=1e-4, momentum=momentum, live=True)
    v = _bn_vars(jmod, x, 4)
    bn = _port_bn(v, live=True, momentum=momentum)
    r_mean, r_var = bn.running_mean.clone(), bn.running_var.clone()
    got = bn(_nchw(x), True)
    want, mut = jmod.apply(v, x, True, mutable=["batch_stats"])
    _close(got.permute(0, 2, 3, 1), np.asarray(want))
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    _close(bn.running_mean, (1 - momentum) * r_mean.numpy() + momentum * flat.mean(0))
    _close(bn.running_var, (1 - momentum) * r_var.numpy() + momentum * flat.var(0, ddof=1))
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        _close(getattr(bn, name), np.asarray(mut["batch_stats"][k]))
    # eval mode normalises with the running statistics and updates nothing
    stats = bn.running_var.clone()
    _close(bn(_nchw(x), False).permute(0, 2, 3, 1), np.asarray(jmod.apply({**v, **mut}, x, False)))
    assert torch.equal(stats, bn.running_var)


def test_live_mwcnn_statistics_at_momentum_095_match_jax_after_two_steps():
    """MWCNN's BatchNorm (momentum 0.95) in train mode, twice: the running
    statistics of every block against the JAX package's ``batch_stats``."""
    x1, x2 = _x((2, 12, 10, 2), 5), _x((2, 12, 10, 2), 6)
    jmod = jmwcnn.MWCNN(input_channels=2, first_conv_hidden_channels=4, num_scales=2, batchnorm=True, live_bn=True)
    v = _bn_vars(jmod, x1, 7)
    mod = tmwcnn.MWCNN(2, 4, 2, batchnorm=True, live_bn=True)
    state, left = _block_state(mod, _mwcnn_pairs, v)
    assert not left["params"] and not left["batch_stats"]
    mod.load_state_dict(state)
    variables = dict(v)
    for x in (x1, x2):
        want, mut = jmod.apply(variables, x, False, True, mutable=["batch_stats"])
        variables = {**variables, **mut}
        got = mod(torch.from_numpy(x), False, True)
        _close(got, np.asarray(want))
    flat = {"/".join(p.key for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(variables["batch_stats"])[0]}
    for coll, f, p, kind in _mwcnn_pairs(mod, "", ""):
        if coll == "batch_stats":
            _close(mod.state_dict()[p], flat[f])


def _batches(n, seed=0):
    out = []
    for i in range(n):
        y, sens, mask, target = _data(seed=seed + i)
        out.append({"masked_kspace": y, "sensitivity_maps": sens, "mask": mask,
                    "target": np.sqrt((target ** 2).sum(-1))})
    return out


def _run_both(cfg, optim, batches):
    """Per-step losses, and the variables after every step, of the JAX and the
    port trainers from the same weights and statistics."""
    y, sens, mask = (batches[0][k] for k in ("masked_kspace", "sensitivity_maps", "mask"))
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), y, sens, mask)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(11)), dict(shapes))
    jt = JTrainer(jax_build_model(cfg), optim_cfg=optim, trainer_cfg={"max_steps": 20}, loss_type="l1",
                  mesh=make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batches[0])
    jt.state = JTrainState.create(v["params"], jt._tx, batch_stats=v.get("batch_stats"))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(v, cfg))
    tt = Trainer(model, optim_cfg=optim, trainer_cfg={"max_steps": 20}, loss_type="l1", device="cpu")
    tt.setup_optimization()
    tt.init_state()
    steps = []
    for b in batches:
        jl = float(jt.training_batch(b)["loss"])
        tl = float(tt.training_batch(b)["loss"])
        variables = {"params": jax.tree_util.tree_map(np.asarray, jt.state.params)}
        if jt.state.batch_stats is not None:
            variables["batch_stats"] = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
        steps.append((jl, tl, zoo2_params_from_jax(variables, cfg), {k: t.clone() for k, t in
                                                                      model.state_dict().items()},
                      {k: p.grad.clone() for k, p in model.named_parameters()}))
    return jt, tt, steps


def _noise(grads):
    """Parameters whose gradient is roundoff (a conv bias that feeds a
    train-mode BatchNorm: the batch mean removes it), below 1e-6 of the
    largest gradient and not exactly 0; Adam's first step turns its sign into
    a full step of either direction."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if 0 < float(g.abs().max()) < 1e-6 * top}


def test_live_statistics_match_the_jax_trainers_batch_stats_after_two_steps():
    """CascadeNet with ``train_batch_stats`` (momentum 0.1) trained two steps
    by both trainers: the losses, every parameter and the running mean and
    variance after each step; then the evaluation forward with them. SGD, so
    that the conv biases before the BatchNorms (whose gradients are roundoff,
    see :func:`_noise`) stay where they are and the second step's statistics
    are a function of well-posed numbers."""
    batches = _batches(2)
    jt, tt, steps = _run_both(LIVE, SGD, batches)
    for jl, tl, want, got, _ in steps:
        _close(tl, jl)
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 12 and sorted(want) == sorted(got)
        for k in want:
            _close(got[k], want[k].numpy())
    init = {k: t for k, t in build_model(LIVE, device="cpu").state_dict().items() if k.endswith("running_var")}
    assert not all(torch.equal(init[k], steps[-1][3][k]) for k in init)
    b = batches[0]
    _close(tt.predict_batch(b), np.asarray(jt.predict_batch(b)))


def test_frozen_statistics_take_adamw_weight_decay_as_in_optax():
    """Frozen BatchNorm: the running mean and variance are parameters the loss
    does not reach; the trainer hands them a zero gradient, so one adamw step
    with weight decay moves them by -lr * wd * p, as optax does, and leaves
    them at their values under plain Adam."""
    adamw = {**ADAM, "name": "adamw", "weight_decay": 0.1}
    batches = _batches(1, seed=5)
    for optim, moves in ((adamw, True), (ADAM, False)):
        _, tt, steps = _run_both(CCNN, optim, batches)
        jl, tl, want, got, grads = steps[0]
        _close(tl, jl)
        noise = {k for k in want if ".convs." in k and k.endswith(".bias")}
        top = max(float(g.abs().max()) for g in grads.values())
        assert _noise(grads) <= noise and all(float(grads[k].abs().max()) < 1e-4 * top for k in noise)
        for k in want:
            if k in noise:  # a sign step of roundoff: lr * (1 + wd) at most, either way
                assert float((got[k] - want[k]).abs().max()) <= 2.2 * optim["lr"], k
            else:
                _close(got[k], want[k].numpy())
        frozen = [k for k in want if k.endswith((".mean", ".var"))]
        assert len(frozen) == 12
        start = {k: t for k, t in zoo2_params_from_jax(
            jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(11)), dict(jax.eval_shape(
                jax_build_model(CCNN).init, jax.random.PRNGKey(0), *(batches[0][k] for k in (
                    "masked_kspace", "sensitivity_maps", "mask"))))), CCNN).items()}
        assert all(torch.equal(got[k], start[k]) for k in frozen) != moves


def test_trainer_state_and_step_checkpoints_keep_the_statistics(tmp_path):
    batches = _batches(2, seed=7)
    model = build_model(LIVE, device="cpu", generator=torch.Generator().manual_seed(0))
    tt = Trainer(model, optim_cfg=ADAM, device="cpu")
    tt.training_batch(batches[0])
    ck = checkpoints.StepCheckpointer(tmp_path / "ck", max_to_keep=1, map_location="cpu")
    ck.save(1, tt.state_dict(), {"val_loss": 1.0})
    ck.save_last(tt.state_dict())
    saved = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    tt.training_batch(batches[1])
    assert not all(torch.equal(saved[k], model.state_dict()[k]) for k in saved)
    for state in (ck.restore_best(), ck.restore_last()):
        fresh = Trainer(build_model(LIVE, device="cpu"), optim_cfg=ADAM, device="cpu")
        fresh.load_state_dict(state)
        assert all(torch.equal(saved[k], fresh.model.state_dict()[k]) for k in saved)


def test_archives_with_batch_stats_restore_across_the_packages(tmp_path):
    """A port archive of a live-BatchNorm model is the JAX package's flax
    msgpack of {"params", "batch_stats"}: ``mridc_tpu`` restores it with its
    statistics, and the port restores ``mridc_tpu``'s, both to the same
    numbers; a model without live statistics keeps the torch format."""
    model = build_model(LIVE, device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(len(name))))
    state = model.state_dict()
    checkpoints.save_archive(tmp_path / "port.mridc", LIVE, state)
    jmodel, variables, jcfg = jckpt.restore_model_variables(tmp_path / "port.mridc")
    assert set(variables) == {"params", "batch_stats"} and jcfg == LIVE
    want = zoo2_params_to_jax(state, LIVE)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a), b),
                                                         dict(variables), want))
    jckpt.save_archive(tmp_path / "jax.mridc", jcfg, variables["params"], batch_stats=variables["batch_stats"])
    back, _, _ = checkpoints.restore_model(tmp_path / "jax.mridc", device="cpu")
    assert all(torch.equal(state[k], back.state_dict()[k]) for k in state)
    y, sens, mask, _ = _data(seed=9)
    with torch.no_grad():
        got = back(*_t(y, sens, mask)).prediction
    _close(got, np.asarray(jmodel.apply(variables, y, sens, mask).prediction))
    checkpoints.save_archive(tmp_path / "frozen.mridc", CCNN, build_model(CCNN, device="cpu").state_dict())
    import tarfile

    with tarfile.open(tmp_path / "frozen.mridc") as tar:
        assert checkpoints.WEIGHTS_NAME in [m.name for m in tar.getmembers()]


@pytest.mark.parametrize("cfg", [
    {"model_name": "XPDNet", "scan_iterations": True, "mwcnn_batchnorm": True},
    {"model_name": "KIKINet", "scan_iterations": True, "kspace_model_architecture": "CONV",
     "kspace_conv_batchnorm": True},
    {"model_name": "KIKINet", "scan_iterations": True, "image_mwcnn_batchnorm": True},
    {"model_name": "LPDNet", "scan_iterations": True, "dual_model_architecture": "CONV",
     "kspace_conv_batchnorm": True},
])
def test_scan_iterations_with_batchnorm_is_refused(cfg):
    y, sens, mask, _ = _data(b=1, c=2, h=16, w=16, seed=1)
    with pytest.raises(ValueError, match="scan_iterations does not support batchnorm"):
        jax_build_model(cfg).init(jax.random.PRNGKey(0), y, sens, mask)
    with pytest.raises(ValueError, match="scan_iterations does not support batchnorm"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("name", ["CRNNet", "CRNN"])
def test_train_batch_stats_is_refused_for_crnnet(name):
    cfg = {"model_name": name, "batchnorm": True, "train_batch_stats": True}
    with pytest.raises(ValueError, match="train_batch_stats"):
        jax_build_model(cfg)
    with pytest.raises(ValueError, match="train_batch_stats"):
        build_model(cfg, device="cpu")


def test_crnn_runs_its_batchnorm_in_eval_mode_while_training():
    """CRNNet's cascade is called without ``train`` (as in the JAX package):
    its frozen BatchNorm normalises with the stored statistics in a training
    forward too."""
    cfg = {"model_name": "CRNNet", "num_iterations": 2, "hidden_channels": 4, "n_convs": 2, "batchnorm": True}
    y, sens, mask, _ = _data(seed=3)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0), y, sens, mask)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(4)), dict(shapes))
    want = np.asarray(jax_build_model(cfg).apply(v, y, sens, mask, train=True).prediction)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(v, cfg))
    with torch.no_grad():
        _close(model(*_t(y, sens, mask), train=True).prediction, want)
        _close(model(*_t(y, sens, mask), train=False).prediction, want)
