"""Port parity: qVarNet, the quantitative data path and the quantitative
launch of mridc_tpu_torch against mridc_tpu's on the CPU (the signal model,
qCIRIM and the trainer: ``test_torch_port_qcirim.py``).

qVN runs at 3 coils, 3 echoes and 17x13 (odd FFT sizes, NormUnet padding),
with weights drawn with numpy in the flax tree's shapes and carried over
(``qvn_params_from_jax``): forward at rtol 2e-3 / atol 2e-4 of the largest
magnitude; the loss likewise; gradients per parameter at relative l2 1e-2
(random NormUnets: LeakyReLU kinks flip between the packages, ROADMAP.md's
NormUnet trap). The host data path (phase unwrap, map fit, transforms, the
AHEAD-format dataset and ``QBatchLoader``) is numpy on both sides and must
match bit for bit. The launch runs ``base_qcirim_train.yaml`` on fixture h5
volumes against ``mridc_tpu.launch`` from one archive.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu import launch as jlaunch
from mridc_tpu.data import qtransforms as jqt
from mridc_tpu.data import seg_pipeline as jsp
from mridc_tpu.data import task_loaders as jtl
from mridc_tpu.data.subsample import create_masker as jcreate_masker
from mridc_tpu.ops import unwrap as junwrap
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import config as jconfig
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu_torch import cli, launch
from mridc_tpu_torch.data import qtransforms as tqt
from mridc_tpu_torch.data import seg_pipeline as tsp
from mridc_tpu_torch.data import task_loaders as ttl
from mridc_tpu_torch.data.subsample import create_masker as tcreate_masker
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.models.quantitative.qvn import BF16_REFUSAL
from mridc_tpu_torch.ops import unwrap as tunwrap
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train import task_trainers as ttt
from mridc_tpu_torch.utils.params import qvn_params_from_jax, zoo2_params_to_jax

import test_torch_port_qcirim as q1
from fixtures import create_qmri_dataset

ROOT = Path(__file__).resolve().parent.parent
GRAD_REL_L2 = 1e-2
H, W = 17, 13
QVN = {"model_name": "qVN", "quantitative_module_num_cascades": 2, "quantitative_module_channels": 4,
       "quantitative_module_pooling_layers": 2, "TEs": [3.0, 11.5, 20.0]}
_close, _t = q1._close, q1._t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- qVN against mridc_tpu ----


@pytest.fixture(scope="module")
def qvn_case():
    d = q1.qdata(h=H, w=W, seed=30)
    inputs = q1._inputs(d)
    return d, inputs, q1.jax_vars(QVN, inputs, seed=31)


def test_qvn_complex_forward_matches_jax(qvn_case):
    """Complex map threading (the default): the echo-axis sum keeping the
    coils as the regulariser's 2C channels, the clamp on R2*'s real and
    imaginary parts, |maps| * gamma."""
    _, inputs, v = qvn_case
    want = q1.jax_out(QVN, v, inputs)
    m = q1.port(QVN, v)
    assert m.regs[0].unet.down_sample_layers[0].layers[0].weight.shape[1] == 2 * 3
    with torch.no_grad():
        got = m(*_t(*inputs))
    _close(got.prediction, want.prediction)
    _close(got.intermediates, want.intermediates)


def test_qvn_loss_and_gradients_match_jax_grad(qvn_case):
    d, inputs, v = qvn_case
    head = np.ones((q1.B, H, W), np.float32)

    def jloss(p):
        out = q1._jm(QVN).apply({"params": p}, *inputs, train=True)
        return jtt.quantitative_loss_fn(d[4], out.prediction[None, None], head, jnp.ones(4), "l1")[0]

    want_loss, grads = jax.jit(jax.value_and_grad(jloss))(v["params"])
    want = qvn_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}, QVN)
    m = q1.port(QVN, v)
    out = m(*_t(*inputs), train=True)
    loss, _ = ttt.quantitative_loss_fn(*_t(d[4]), out.prediction[None, None], *_t(head), torch.ones(4), "l1")
    loss.backward()
    _close(float(loss.detach()), float(want_loss))
    got = {k: p.grad for k, p in m.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in got:
        assert q1._rel_l2(got[k], want[k].numpy()) < GRAD_REL_L2, k


def test_qvn_real_threading_matches_jax(qvn_case):
    """``map_threading: real``: the echo residuals (K2's ``normal_op`` form)
    stacked into 2E channels, 4 out."""
    _, inputs, _ = qvn_case
    cfg = {**QVN, "quantitative_module_map_threading": "real"}
    v = q1.jax_vars(cfg, inputs, seed=32)
    with torch.no_grad():
        got = q1.port(cfg, v)(*_t(*inputs)).prediction
    _close(got, q1.jax_out(cfg, v, inputs).prediction)


def test_qvn_reconstruction_module_matches_jax(qvn_case):
    """One set of VarNet blocks (flax's ``_VarNetBlock_{j}``) serves every
    echo; y is replaced by the masked expansion of the echoes and the maps
    are re-fitted."""
    _, inputs, _ = qvn_case
    cfg = {**QVN, "use_reconstruction_module": True, "reconstruction_module_num_cascades": 2,
           "reconstruction_module_channels": 4, "reconstruction_module_pooling_layers": 2}
    v = q1.jax_vars(cfg, inputs, seed=33)
    assert sorted(k for k in v["params"] if k.startswith("_VarNet")) == ["_VarNetBlock_0", "_VarNetBlock_1"]
    m = q1.port(cfg, v)
    assert len(m.recon) == 2
    with torch.no_grad():
        got = m(*_t(*inputs)).prediction
    _close(got, q1.jax_out(cfg, v, inputs).prediction)


def test_qvn_bf16_is_refused_unless_allowed():
    with pytest.raises(ValueError) as exc:
        build_model({**QVN, "compute_dtype": "bfloat16"}, device="cpu")
    assert str(exc.value) == BF16_REFUSAL
    with pytest.raises(ValueError) as jexc:
        q1._jm({**QVN, "compute_dtype": "bfloat16"})
    assert str(jexc.value) == BF16_REFUSAL
    m = build_model({**QVN, "compute_dtype": "bfloat16", "quantitative_module_allow_bf16": True}, device="cpu")
    m.materialize(6)
    assert m.regs[0].unet.down_sample_layers[0].layers[0].compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="map_threading"):
        build_model({**QVN, "quantitative_module_map_threading": "both"}, device="cpu")


def test_qvn_regularisers_take_their_width_from_the_data(qvn_case):
    """Built at the first batch (the trainer's ``init_state``) or from the
    weights' shapes; a batch of another coil count is refused after."""
    d, inputs, v = qvn_case
    m = build_model(QVN, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not m.materialized and len(list(m.parameters())) == 2
    trainer = ttt.QuantitativeTrainer(m, optim_cfg={"name": "adam", "lr": 1e-3}, device="cpu")
    batch = {"kspace": d[0], "sensitivity_maps": d[1], "mask": d[2], "maps_init": d[3], "maps_target": d[4],
             "TEs": d[5]}
    trainer.init_state(batch)
    assert m.materialized and len(trainer.state.optimizer.param_groups[0]["params"]) == len(list(m.parameters()))
    again = build_model(QVN, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        again(*_t(*inputs))
    for (k, a), (_, b) in zip(m.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k  # the same weights from the same generator
    with pytest.raises(ValueError, match="channels"):
        m.materialize(8)
    with pytest.raises(ValueError, match="init_state needs a batch"):
        ttt.QuantitativeTrainer(build_model(QVN, device="cpu"), device="cpu").init_state()


@pytest.mark.parametrize("recon", [False, True])
def test_qvn_params_carry_every_leaf_both_ways_and_archives(recon, qvn_case, tmp_path):
    _, inputs, _ = qvn_case
    cfg = {**QVN, "use_reconstruction_module": True, "reconstruction_module_num_cascades": 2,
           "reconstruction_module_channels": 4, "reconstruction_module_pooling_layers": 2} if recon else QVN
    v = q1.jax_vars(cfg, inputs, seed=34)
    state = qvn_params_from_jax(v, cfg)
    back = zoo2_params_to_jax(state, cfg)
    flat = lambda t: {"/".join(p.key for p in path): np.asarray(a)  # noqa: E731
                      for path, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(v["params"]), flat(back["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if not recon:
        path = checkpoints.save_archive(tmp_path / "port.mridc", cfg, state)
        _, params, _ = jckpt.restore_model(path)
        assert all(np.array_equal(a, b) for a, b in zip(flat(params).values(), want.values()))
        jpath = jckpt.save_archive(tmp_path / "jax.mridc", cfg, jax.tree_util.tree_map(np.asarray, v["params"]))
        restored, _, _ = checkpoints.restore_model(jpath, device="cpu")
        for k, x in restored.state_dict().items():
            assert torch.equal(x, state[k]), k


# ---- the host data path, bit for bit ----


def _wrapped_phase(seed, h=24, w=20):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    phase = 0.9 * xx + 0.5 * yy + 2 * np.sin(yy / 3.0) + 0.1 * rng.standard_normal((h, w))
    return np.angle(np.exp(1j * phase)).astype(np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("fn", ["unwrap_phase_2d", "unwrap_phase_dct"])
def test_phase_unwrap_is_bit_identical(fn):
    p = _wrapped_phase(40)
    mod_t, mod_j = (tqt, jqt) if fn == "unwrap_phase_dct" else (tunwrap, junwrap)
    _same(getattr(mod_t, fn)(p), getattr(mod_j, fn)(p))
    vol = np.stack([_wrapped_phase(41), _wrapped_phase(42)])
    _same(tunwrap.unwrap_phase(vol), junwrap.unwrap_phase(vol))


@pytest.mark.parametrize("brain", [False, True])
def test_fit_quantitative_maps_is_bit_identical(brain):
    d = q1.qdata(b=1, e=4, h=16, w=16, seed=43)
    echoes = np.fft.ifft2((d[0][..., 0] + 1j * d[0][..., 1])[0], axes=(-2, -1))
    combined = (echoes * np.conj(d[1][0, ..., 0] + 1j * d[1][0, ..., 1])[None]).sum(1).astype(np.complex64)
    mask_brain = (np.random.default_rng(44).random((16, 16)) < 0.7).astype(np.float32) if brain else None
    got, want = tqt.fit_quantitative_maps(combined, d[5], mask_brain), jqt.fit_quantitative_maps(combined, d[5],
                                                                                               mask_brain)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])


def test_qtransforms_shared_mask_draw_and_unnormalised_fit_are_bit_identical():
    rng = np.random.default_rng(45)
    e, c, h, w = 4, 3, 16, 16
    k = (rng.standard_normal((e, c, h, w)) + 1j * rng.standard_normal((e, c, h, w))).astype(np.complex64)
    sens = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))).astype(np.complex64)
    outs = []
    for mod, masker in ((tqt, tcreate_masker), (jqt, jcreate_masker)):
        tfm = mod.qMRIDataTransforms(TEs=[3.0, 11.5, 20.0, 28.5], mask_func=[masker("random1d", [0.16], [2])],
                                     normalize_inputs=True, normalization_type="max", fft_centered=True,
                                     fft_normalization="ortho", coil_combination_method="SENSE", use_seed=True)
        outs.append(tfm(k, sens, None, None, None, {}, "qfile.h5", 0))
    got, want = outs
    masked = got[1][0] if isinstance(got[1], list) else got[1]
    assert all(np.array_equal(np.abs(masked[i]) > 0, np.abs(masked[0]) > 0) for i in range(e))
    for i in (0, 1, 2, 3, 4, 5):
        for a, b in zip(np.atleast_1d(got[i]) if isinstance(got[i], list) else [got[i]],
                        np.atleast_1d(want[i]) if isinstance(want[i], list) else [want[i]]):
            _same(a, b)
    for key, x in want[9]["quantitative_maps_init"].items():
        _same(got[9]["quantitative_maps_init"][key], x)


@pytest.fixture(scope="module")
def qroot(tmp_path_factory):
    """AHEAD-format fixtures: a 3-slice volume with maps and targets, one with
    a precomputed file mask and no maps (the RSS branch), and the launch's
    train and validation splits."""
    root = tmp_path_factory.mktemp("qdata")
    create_qmri_dataset(root / "maps", n_files=1, slices=3, echoes=3, coils=2, h=16, w=16, seed=1)
    rng = np.random.default_rng(2)
    (root / "nomaps").mkdir()
    with h5py.File(root / "nomaps" / "q.h5", "w") as f:
        f["kspace"] = (rng.standard_normal((2, 3, 2, 16, 16))
                       + 1j * rng.standard_normal((2, 3, 2, 16, 16))).astype(np.complex64)
        f["mask"] = (rng.random((2, 16, 16)) < 0.4).astype(np.float32)
    for split, seed in (("train", 3), ("val", 4)):
        create_qmri_dataset(root / split, n_files=1, slices=2, echoes=4, coils=3, h=16, w=16, seed=seed)
    return root


def _batches(mod_tl, mod_sp, root, tes, **kw):
    ds = mod_tl.qMRIDataset(root=root, consecutive_slices=kw.pop("consecutive_slices", 1))
    return list(mod_sp.QBatchLoader(ds, tes=tes, **kw))


@pytest.mark.parametrize("case", ["mask_func", "file_mask_rss", "consecutive", "compute_target", "workers"])
def test_qmri_dataset_and_qbatchloader_are_bit_identical(case, qroot):
    """``qMRIDataset`` and ``QBatchLoader`` on h5 fixtures against
    ``mridc_tpu.data``: the masker's draw seeded by the file name;
    without a masker the file's mask, and without maps the RSS combination
    and uniform maps; consecutive slices folded; the per-echo target only
    with ``compute_target``; worker threads in order."""
    tes3 = [3.0, 11.5, 20.0]
    if case == "mask_func":
        args = dict(root=qroot / "maps", tes=tes3, batch_size=2, fft_centered=True, fft_normalization="ortho")
        kw_t, kw_j = (dict(mask_func=m("random1d", [0.25], [2])) for m in (tcreate_masker, jcreate_masker))
    elif case == "file_mask_rss":
        args = dict(root=qroot / "nomaps", tes=tes3, batch_size=2)
        kw_t = kw_j = {}
    elif case == "consecutive":
        # the JAX package's fold of consecutive slices fails (it extends its
        # list with a sample dict's keys); the port's yields each slice's
        # sample, which must equal the JAX package's single-slice sample
        with pytest.raises(TypeError):
            _batches(jtl, jsp, root=qroot / "maps", tes=tes3, batch_size=1, consecutive_slices=2)
        got = _batches(ttl, tsp, root=qroot / "maps", tes=tes3, batch_size=1, consecutive_slices=2)
        single = _batches(jtl, jsp, root=qroot / "maps", tes=tes3, batch_size=1)
        assert [int(b["slice_idx"][0]) for b in got] == [0, 1, 1, 2]
        for g in got:
            w = single[int(g["slice_idx"][0])]
            assert sorted(g) == sorted(w) and g["fname"] == w["fname"]
            for k in w:
                if k != "fname":
                    _same(g[k], w[k])
        return
    elif case == "compute_target":
        args = dict(root=qroot / "maps", tes=tes3, batch_size=3, compute_target=True)
        kw_t = kw_j = {}
    else:
        args = dict(root=qroot / "maps", tes=tes3, batch_size=2, num_workers=2, shuffle=True, seed=5)
        kw_t = kw_j = {}
    got = _batches(ttl, tsp, **args, **kw_t)
    want = _batches(jtl, jsp, **args, **kw_j)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "fname":
                assert g[k] == w[k]
            else:
                _same(g[k], w[k])
    if case == "compute_target":
        assert got[0]["target"].shape == (3, 3, 16, 16, 2)
    else:
        assert "target" not in got[0]


def test_quantitative_data_modules_import_without_h5py(tmp_path):
    """In a fresh interpreter where jax, h5py and PyYAML cannot be imported:
    the quantitative data modules, models, trainer and launcher import; the
    dataset raises an ImportError naming h5py."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "h5py", "yaml"):
    sys.modules[name] = None
import mridc_tpu_torch.data.qtransforms, mridc_tpu_torch.data.seg_pipeline, mridc_tpu_torch.ops.unwrap
import mridc_tpu_torch.models.quantitative, mridc_tpu_torch.train.task_trainers, mridc_tpu_torch.launch
from mridc_tpu_torch.data.task_loaders import qMRIDataset
try:
    qMRIDataset({str(tmp_path)!r})
except ImportError as exc:
    assert "h5py" in str(exc), exc
else:
    raise AssertionError("no ImportError")
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


# ---- the launch ----

YAML = ROOT / "projects/quantitative/conf/base_qcirim_train.yaml"
RUN_YAML = ROOT / "projects/quantitative/conf/base_qcirim_run.yaml"
SMALL = ["model.quantitative_module_num_cascades=1", "model.quantitative_module_time_steps=2",
         "model.quantitative_module_conv_filters=[8,8,4]", "model.quantitative_module_recurrent_filters=[8,8,0]",
         "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "trainer.accelerator=cpu"]


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


def test_config_run_matches_jax_and_tests_from_its_archive(qroot, monkeypatch):
    """``python -m mridc_tpu_torch run -c base_qcirim_train.yaml`` (cut to 1
    cascade x 2 steps x 8 filters; the YAML's poisson2d masker, seeded by the
    file name) against ``mridc_tpu.launch`` from one JAX archive: the per-step
    losses and the initial and final validation metrics; then
    ``base_qcirim_run.yaml`` (``mode: test``) on the archive the port's run
    wrote writes each volume's maps, [S, H, W, 4], equal to the trainer's
    predictions."""
    data = [f"model.train_ds.data_path={qroot / 'train'}", f"model.validation_ds.data_path={qroot / 'val'}",
            f"model.test_ds.data_path={qroot / 'val'}"]
    cfg = jconfig.load_config(YAML, SMALL + data)
    d = q1.qdata(b=1, e=4, c=3, seed=46)
    v = q1.jax_vars(cfg["model"], q1._inputs(d), seed=47)
    archive = jckpt.save_archive(qroot / "jq.mridc", cfg["model"], v["params"])
    common = SMALL + data + ["pretrained=true", f"checkpoint={archive}"]
    runs = {}
    for name, cls, run in (
        ("jax", jtt.QuantitativeTrainer, lambda o: jlaunch.run_from_config(jconfig.load_config(YAML, o))),
        ("port", ttt.QuantitativeTrainer, lambda o: cli.main(["run", "-c", str(YAML), *o])),
    ):
        losses, vals = [], []
        with monkeypatch.context() as m:
            q1_exp = qroot / "exp" / name
            _recording(m, cls, losses, vals)
            run(common + [f"exp_manager.exp_dir={q1_exp}"])
        runs[name] = (losses, vals)
    (jl, jv), (pl, pv) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 2
    _close(np.asarray(pl), np.asarray(jl))
    assert len(pv) == len(jv) == 2
    for p, j in zip(pv, jv):
        assert sorted(p) == sorted(j)
        for k in j:
            _close(p[k], j[k])
    (run_dir,) = (qroot / "exp" / "port" / "qcirim").iterdir()
    trained = run_dir / "qcirim.mridc"
    overrides = [f"model.test_ds.data_path={qroot / 'val'}", f"checkpoint={trained}", "trainer.accelerator=cpu",
                 f"exp_manager.exp_dir={qroot / 'exp' / 'test'}", *SMALL[:4]]
    cli.main(["run", "-c", str(RUN_YAML), *overrides])
    (test_dir,) = (qroot / "exp" / "test" / "qcirim").iterdir()
    (written,) = (test_dir / "reconstructions").iterdir()
    with h5py.File(written, "r") as f:
        maps = f["reconstruction"][()]
    model, _, mcfg = checkpoints.restore_model(trained, device="cpu")
    loader = launch._build_task_loader("quantitative", jconfig.load_config(RUN_YAML, overrides)["model"]["test_ds"],
                                       mcfg, False, "cpu")
    trainer = ttt.QuantitativeTrainer(model, device="cpu")
    want = np.concatenate([trainer.predict_batch(b) for b in loader])
    assert maps.shape == (2, 16, 16, 4)
    np.testing.assert_array_equal(maps, want)


@pytest.mark.parametrize("name", ["base_qcirim_train", "base_qcirim_run", "base_qvn_train", "base_qvn_run"])
def test_quantitative_yamls_build_through_the_launcher(name):
    """Each projects/quantitative/conf YAML's model block builds on the CPU
    through ``_auto_dc_mode`` and ``build_model`` (which leave it as the JAX
    launcher does), and its task is the JAX launcher's."""
    model = jconfig.load_config(ROOT / f"projects/quantitative/conf/{name}.yaml")["model"]
    cfg = launch._auto_dc_mode(dict(model))
    assert cfg == jlaunch._auto_dc_mode(dict(model)) == model
    assert launch.model_task(model["model_name"]) == jlaunch.model_task(model["model_name"]) == "quantitative"
    assert type(build_model(cfg, device="cpu")).__name__ in ("qCIRIM", "qVarNet")
