"""Port parity: data parallelism across processes (``mridc_tpu_torch/parallel/
mesh.py`` and the trainers' step) against one process on the joined batch and
against ``mridc_tpu``'s step on it, on the CPU.

Two processes joined in one gloo group (one pool for the file,
``torch_port_dp_workers.py``) each take half of a batch of 8 (4 + 4). Their
step must equal one process's step on all 8 rows and the JAX package's
``jax.grad``/optax step over them (``tests/test_multidevice_equivalence.py``
holds the JAX package's own 8-device step equal to its 1-device step):
loss rtol 1e-5, gradients and SGD deltas rtol 1e-4 / atol 1e-6, that test's
limits. The batch-coupled reductions of the losses (the magnitude
normalisation's maximum, a live BatchNorm's statistics) must see the joined
batch: one case gives the two shards maxima apart by 100x, another trains a
CascadeNet with live BatchNorm, two more ResNet's conjugate gradient (its
inner products over every sample) and MTLRS's segmentation normalised by its
maximum; gradient accumulation takes two micro-steps.
"""

import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mridc_tpu.models import build_model as jax_build_model
from mridc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu.train.losses import process_reconstruction_loss as jloss
from mridc_tpu_torch.parallel import mesh as pmesh
from mridc_tpu_torch.utils.params import cirim_params_from_jax, zoo2_params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_dp_workers as workers  # noqa: E402
from test_torch_port_cirim import _jax_params  # noqa: E402
from test_torch_port_seg import jax_vars  # noqa: E402

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
B, C, H, W = 8, 2, 16, 16
CIRIM = {"model_name": "CIRIM", "num_cascades": 2, "time_steps": 2, "recurrent_layer": "IndRNN",
         "conv_filters": [8, 8, 2], "conv_kernels": [5, 3, 3], "conv_dilations": [1, 2, 1],
         "recurrent_filters": [8, 8, 0], "recurrent_kernels": [1, 1, 0], "recurrent_dilations": [1, 1, 0],
         "fft_centered": True, "fft_normalization": "ortho"}
SEG_UNET = {"model_name": "SegmentationUNet", "segmentation_module_output_channels": 2,
            "segmentation_module_channels": 4, "segmentation_module_pooling_layers": 2}
CCNN_LIVE = {"model_name": "CascadeNet", "num_cascades": 2, "hidden_channels": 8, "n_convs": 3, "batchnorm": True,
             "train_batch_stats": True, "fft_centered": False, "fft_normalization": "backward"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    """Two spawned processes in one gloo group; ``run(case, [kwargs of rank
    0, kwargs of rank 1])`` returns their results."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    inboxes, outbox = [ctx.Queue() for _ in range(2)], ctx.Queue()
    procs = [ctx.Process(target=workers.serve, args=(r, 2, port, inboxes[r], outbox)) for r in range(2)]
    for p in procs:
        p.start()

    def run(case, per_rank):
        for q, kw in zip(inboxes, per_rank):
            q.put((case, kw))
        res = dict(outbox.get(timeout=300) for _ in range(2))
        for r in range(2):
            assert "error" not in res[r], res[r]["error"]
        return [res[0], res[1]]

    yield run
    for q in inboxes:
        q.put(None)
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()


def _halves(batch):
    """Rows 0:4 and 4:8 of every leaf."""
    return [{k: v[i * B // 2:(i + 1) * B // 2] for k, v in batch.items()} for i in range(2)]


def _rv(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _recon_batch(seed=0):
    """``tests/test_multidevice_equivalence.py``'s inputs: unit-RSS maps, a
    column mask, masked k-space and a complex target."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((B, C, H, W)) + 1j * rng.standard_normal((B, C, H, W))).astype(np.complex64)
    sens = (rng.standard_normal((B, C, H, W)) + 1j * rng.standard_normal((B, C, H, W))).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(1, keepdims=True))
    mask = np.zeros((B, 1, H, W), np.float32)
    mask[..., ::3] = 1.0
    mask[..., W // 2 - 2: W // 2 + 2] = 1.0
    target = (rng.standard_normal((B, H, W)) + 1j * rng.standard_normal((B, H, W))).astype(np.complex64)
    return {"masked_kspace": _rv(y), "sensitivity_maps": _rv(sens), "mask": mask, "target": _rv(target)}


def _close(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max abs err {np.abs(got - want).max()}")


def _same_step(two, one, keys=None):
    """Both ranks' losses, gradient norms and gradients equal one process's
    on the joined batch, and both ranks end with one state."""
    for r in two:
        _close(r["loss"], one["loss"], LOSS_RTOL, 0.0, "loss")
        _close(r["grad_norm"], one["grad_norm"], GRAD_RTOL, GRAD_ATOL, "grad_norm")
        assert sorted(r["grads"]) == sorted(one["grads"])
        for k in keys or one["grads"]:
            _close(r["grads"][k], one["grads"][k], GRAD_RTOL, GRAD_ATOL, f"grad {k}")
        for k, v in one["state"].items():
            _close(r["state"][k], v, GRAD_RTOL, GRAD_ATOL, f"state {k}")
    for k, v in two[0]["state"].items():
        np.testing.assert_array_equal(two[1]["state"][k], v, err_msg=k)


def _cirim_case(batch):
    """The two-process step, the one-process step on the joined batch and
    ``jax.value_and_grad`` of the JAX CIRIM's ``l1`` loss on it."""
    y, sens, mask, target = (jnp.asarray(batch[k]) for k in ("masked_kspace", "sensitivity_maps", "mask", "target"))
    params = _jax_params(CIRIM, batch["masked_kspace"], batch["sensitivity_maps"], batch["mask"], 0)
    model = jax_build_model(CIRIM)

    def loss_fn(p):
        return jloss(model.apply({"params": p}, y, sens, mask, train=True), target, "l1")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    state = {k: v.numpy() for k, v in cirim_params_from_jax(params).items()}
    kw = dict(cfg=CIRIM, state=state, optim={"name": "sgd", "lr": 0.1})
    want = {k: v.numpy() for k, v in cirim_params_from_jax(grads).items()}
    return kw, float(loss), want


def _check_against_jax(one, jax_loss, jax_grads):
    _close(one["loss"][0], jax_loss, LOSS_RTOL, 0.0, "loss against jax")
    for k, v in jax_grads.items():
        _close(one["grads"][k], v, GRAD_RTOL, GRAD_ATOL, f"grad {k} against jax.grad")


@pytest.mark.parametrize("case", ["as_generated", "shard_maxima_apart"])
def test_recon_loss_and_grads_match_across_processes(pool, case):
    """CIRIM's ``l1`` loss and gradients (``test_multidevice_equivalence.py``
    :54): two processes on 4 + 4 rows equal one on 8 and ``jax.grad``. In
    ``shard_maxima_apart`` the first shard's target is 10x and the second's
    k-space 0.1x, so each shard alone would normalise its magnitudes by
    another maximum than the joined batch's."""
    batch = _recon_batch()
    if case == "shard_maxima_apart":
        batch["target"][: B // 2] *= 10.0
        batch["masked_kspace"][B // 2:] *= 0.1
    kw, jax_loss, jax_grads = _cirim_case(batch)
    two = pool("train_steps", [{**kw, "batches": [h]} for h in _halves(batch)])
    one = workers.train_steps(**kw, batches=[batch])
    _same_step(two, one)
    _check_against_jax(one, jax_loss, jax_grads)
    for r in two:
        _check_against_jax(r, jax_loss, jax_grads)


def test_seg_trainer_step_matches_across_processes(pool):
    """One ``SegmentationTrainer`` SGD step (``test_multidevice_equivalence.py``
    :100): loss and parameter deltas of two processes on 4 + 4 rows equal one
    process's on 8 and the JAX trainer's on 8."""
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, H, W, 1)).astype(np.float32),
             "segmentation": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, H, W))]}
    v = jax_vars(SEG_UNET, batch["image"].shape, seed=5)
    jt = jtt.SegmentationTrainer(jax_build_model(SEG_UNET), optim_cfg={"name": "sgd", "lr": 0.1},
                                 mesh=jax_make_mesh(1))
    jt.setup_optimization()
    jt.init_state(jax.random.PRNGKey(0), batch)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(params=params, opt_state=jt._tx.init(params))
    jax_loss = float(jt.training_batch(batch)["loss"])
    after = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jt.state.params)}, SEG_UNET)
    state = {k: t.numpy() for k, t in zoo2_params_from_jax(v, SEG_UNET).items()}
    kw = dict(cfg=SEG_UNET, state=state, optim={"name": "sgd", "lr": 0.1}, task="segmentation")
    two = pool("train_steps", [{**kw, "batches": [h]} for h in _halves(batch)])
    one = workers.train_steps(**kw, batches=[batch])
    _same_step(two, one)
    for r in (one, *two):
        _close(r["loss"][0], jax_loss, LOSS_RTOL, 0.0, "loss against the JAX trainer")
        for k, want in after.items():
            _close(r["state"][k] - state[k], want.numpy() - state[k], GRAD_RTOL, GRAD_ATOL, f"sgd delta {k}")


def test_live_batchnorm_takes_the_joined_batch_statistics(pool):
    """CascadeNet with live BatchNorm, two SGD steps: the statistics of the
    joined batch normalise every process's rows and update one set of
    running statistics, equal to one process's on all 8 rows."""
    batches = [_recon_batch(1), _recon_batch(2)]
    for b in batches:
        b["target"] = np.sqrt((b["target"] ** 2).sum(-1))
    kw = dict(cfg=CCNN_LIVE, optim={"name": "sgd", "lr": 0.05})
    halves = [_halves(b) for b in batches]
    two = pool("train_steps", [{**kw, "batches": [h[r] for h in halves]} for r in range(2)])
    one = workers.train_steps(**kw, batches=batches)
    _same_step(two, one)
    stats = [k for k in one["state"] if k.endswith("running_var")]
    assert len(stats) == 6 and not all(np.array_equal(one["state"][k], one["before"][k]) for k in stats)


@pytest.mark.parametrize("case", ["resnet_cg", "mtlrs_normalised_segmentation", "n2r_one_shard_supervised"])
def test_batch_coupled_model_reductions_join_the_processes(pool, case):
    """The models' own batch-wide reductions, which the JAX package computes
    over its mesh's global batch: the conjugate gradient's inner products
    (ResNet's CG DC: a sum over every sample) and MTLRS's normalisation of
    its segmentation by the maximum of the whole tensor; and Noise2Recon's
    choice of its loss term, supervised when any slice of the joined batch
    is (here a slice of the first shard only). Two SGD steps of two
    processes equal one process's on the joined batches."""
    batches = [_recon_batch(5), _recon_batch(6)]
    if case == "n2r_one_shard_supervised":
        kw = dict(cfg={"model_name": "UNet", "channels": 4, "pooling_layers": 1, "fft_centered": True,
                       "fft_normalization": "ortho"})
        noise = np.random.default_rng(8).standard_normal(batches[0]["masked_kspace"].shape).astype(np.float32)
        for i, b in enumerate(batches):  # the first batch supervised by one slice, the second not
            b["target"] = np.sqrt((b["target"] ** 2).sum(-1))
            b["n2r_masked_kspace"] = b["masked_kspace"] + noise * b["mask"][..., None]
            b["n2r_mask"] = b["mask"]
            b["attrs"] = [{"n2r_supervised": i == 0 and j == 1} for j in range(B)]
    elif case == "resnet_cg":
        kw = dict(cfg={"model_name": "ResNet", "unrolled_iterations": 2, "residual_blocks": 2, "channels": 8,
                       "conjugate_gradient_dc": True, "conjugate_gradient_iterations": 4,
                       "penalization_weight": 0.05, "fft_centered": True, "fft_normalization": "ortho"})
        for b in batches:
            b["target"] = np.sqrt((b["target"] ** 2).sum(-1))
    else:
        rng = np.random.default_rng(7)
        kw = dict(cfg={"model_name": "MTLRS", "joint_reconstruction_segmentation_module_cascades": 2,
                       "reconstruction_module_time_steps": 2, "reconstruction_module_conv_filters": [8, 8, 2],
                       "reconstruction_module_recurrent_filters": [8, 8, 0], "segmentation_module_channels": 4,
                       "segmentation_module_pooling_layers": 2, "normalize_segmentation_output": True,
                       "fft_centered": True, "fft_normalization": "ortho"}, task="multitask")
        for b in batches:
            b["segmentation"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, H, W))]
    kw["optim"] = {"name": "sgd", "lr": 0.05}
    halves = [_halves(b) for b in batches]
    two = pool("train_steps", [{**kw, "batches": [h[r] for h in halves]} for r in range(2)])
    one = workers.train_steps(**kw, batches=batches)
    _same_step(two, one)


def test_accumulated_steps_match_across_processes(pool):
    """``accumulate_grad_batches: 2`` under Adam: two micro-steps of 4 + 4 rows
    each on two processes equal one process's two micro-steps of 8."""
    batches = [_recon_batch(3), _recon_batch(4)]
    kw = dict(cfg={**CIRIM, "num_cascades": 1}, optim={"name": "adam", "lr": 1e-3},
              trainer_cfg={"accumulate_grad_batches": 2})
    halves = [_halves(b) for b in batches]
    two = pool("train_steps", [{**kw, "batches": [h[r] for h in halves]} for r in range(2)])
    one = workers.train_steps(**kw, batches=batches)
    _same_step(two, one)
    assert not all(np.array_equal(one["state"][k], one["before"][k]) for k in one["state"])


def test_shard_batch_replicates_declared_non_batch_leaves(pool):
    """``shard_batch`` (``tests/test_multihost.py:75``) at two processes: the
    echo times (3 of them, not divisible by 2) are declared whole and not
    warned about, a batch leaf of 3 rows is, file names pass through, and
    every array lands on the process's device as a tensor."""
    batch = {"kspace": np.zeros((3, 2, 4, 4, 2), np.float32), "image": np.ones((4, 4, 4), np.float32),
             "TEs": np.asarray([3.0, 11.5, 20.0], np.float32), "fname": ["a"] * 3}
    for rank, r in enumerate(pool("shard_batch", [{"batch": batch}] * 2)):
        assert r["mesh"] == ({"data": 2}, rank, True)
        assert r["warned"] == ["kspace"]
        assert r["kinds"]["TEs"] == ("Tensor", "cpu") and r["kinds"]["fname"] == ("list", None)
        np.testing.assert_array_equal(r["values"]["TEs"], batch["TEs"])
        assert r["values"]["fname"] == batch["fname"]


def test_mesh_without_a_process_group():
    """One process and no group: a one-member ``data`` axis that reduces
    nothing; a mesh of another size raises, and so does a trainer given a
    mesh that is not the group's; ``gather`` and the reductions are the
    identity; the shardings name their axes."""
    from mridc_tpu_torch.train.trainer import _group_mesh

    m = pmesh.make_mesh()
    assert dict(m.shape) == {"data": 1} and m.rank == 0 and not m.distributed and m.size == 1
    assert pmesh.make_mesh(shape=(1, 1), axis_names=("data", "model")).axis_names == ("data", "model")
    with pytest.raises(ValueError, match="process group holds 1"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="inconsistent"):
        pmesh.make_mesh(2, shape=(1,))
    x = torch.ones(4, 3, requires_grad=True)
    assert not pmesh.joins_processes()
    assert pmesh.gather(x) is x and pmesh.all_reduce_sum(x) is x
    assert _group_mesh(None) == m and _group_mesh(m) is m
    with pytest.raises(ValueError, match="make_mesh"):
        _group_mesh(pmesh.Mesh(shape={"data": 2}, distributed=True))
    repl, shard = pmesh.data_parallel_shardings(m)
    assert repl.spec == () and shard.spec == ("data",) and shard.mesh is m
    out = pmesh.shard_batch({"TEs": np.arange(3.0), "y": np.zeros((2, 3)), "fname": ["a", "b"]}, m)
    assert isinstance(out["y"], torch.Tensor) and out["fname"] == ["a", "b"]
    before = dict(pmesh.COLLECTIVES)
    pmesh.all_reduce_gradients([torch.nn.Parameter(torch.ones(2))])
    assert pmesh.COLLECTIVES == before
