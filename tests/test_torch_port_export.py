"""Port parity: model export (``mridc_tpu_torch/utils/export.py``) and the
custom ops that carry the hand kernels through it, on the CPU.

``export_model`` of a function round-trips as ``mridc_tpu``'s does
(``tests/test_utils_aux.py:77``). CIRIM in both ``dc_mode``s and VarNet in
both export, load and run: the loaded program equals the eager forward (the
same plain versions run on the CPU, rtol 1e-6) and its graph holds the
``mridc_tpu_torch::`` ops of the kernels the eager forward launches on the
card (``chip_smoke.PER_FORWARD``/``VN_PER_FORWARD``'s kernels); the
exported CIRIM also equals ``mridc_tpu``'s forward on the same weights at
the port's parity tolerance (rtol 2e-3 / atol 2e-4). Each op's fake
implementation gives the real one's shapes, dtypes and strides
(``torch.library.opcheck``), and its CPU implementation equals its kernel's
plain version bit for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mridc_tpu_torch.kernels import k1_psf1d_dc as k1
from mridc_tpu_torch.kernels import k2_full_dc as k2
from mridc_tpu_torch.kernels import k3_indrnn as k3
from mridc_tpu_torch.kernels import k4_conv_epilogue as k4
from mridc_tpu_torch.models import build_model
from mridc_tpu_torch.utils.export import export_model, load_exported, verify_runtime
from mridc_tpu_torch.utils.params import cirim_params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_cirim import _cfg as cirim_cfg  # noqa: E402
from test_torch_port_cirim import _jax_forward, _jax_params  # noqa: E402

B, C, H, W = 2, 3, 16, 20
OPS = {  # the kernels each forward launches on the card, as ops
    ("CIRIM", "full"): {"k2_expand", "k2_residual", "k2_load", "k2_reduce", "k3_indrnn", "k4_edge_pad", "k4_bias_act"},
    ("CIRIM", "psf1d"): {"k1_psf1d_dc", "k2_load", "k2_reduce", "k3_indrnn", "k4_edge_pad", "k4_bias_act"},
    ("VN", "full"): {"k2_expand", "k2_load", "k2_reduce"},
    ("VN", "psf1d"): {"k1_psf1d_dc", "k2_load", "k2_reduce"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, H, W, 2)).astype(np.float32)
    sens = rng.standard_normal((B, C, H, W, 2)).astype(np.float32)
    sens /= np.sqrt((sens ** 2).sum((1, 4), keepdims=True))
    mask = np.zeros((B, 1, H, W), np.float32)
    mask[..., ::3] = 1.0
    mask[..., W // 2 - 2: W // 2 + 2] = 1.0
    return y * mask[..., None], sens, mask


def _model_cfg(name, dc_mode):
    if name == "CIRIM":
        return cirim_cfg(dc_mode=dc_mode)
    return {"model_name": "VN", "num_cascades": 2, "channels": 8, "pooling_layers": 2, "fft_centered": True,
            "fft_normalization": "ortho", "dc_mode": dc_mode}


def _graph_ops(program):
    return {str(n.target).split(".")[1] for n in program.graph.nodes if str(n.target).startswith("mridc_tpu_torch.")}


def test_export_roundtrip(tmp_path):
    """A function's program (``tests/test_utils_aux.py:77``), and a stale
    artifact verified against another function raises."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32))

    def fn(x, w):
        return torch.tanh(x @ w)

    path = export_model(fn, (x, w), tmp_path / "model.pt2")
    assert path.exists() and path.stat().st_size > 0
    assert verify_runtime(fn, (x, w), path)
    with pytest.raises(AssertionError, match="structure mismatch"):
        verify_runtime(lambda x, w: (fn(x, w), x), (x, w), path)


@pytest.mark.parametrize("name,dc_mode", sorted(OPS))
def test_exported_models_keep_the_kernel_ops_and_match_eager(name, dc_mode, tmp_path):
    y, sens, mask = (torch.from_numpy(a) for a in _data())
    model = build_model(_model_cfg(name, dc_mode), device="cpu", generator=torch.Generator().manual_seed(1)).eval()
    path = export_model(model, (y, sens, mask), tmp_path / f"{name}_{dc_mode}.pt2")
    loaded = load_exported(path)
    assert _graph_ops(loaded.program) == OPS[(name, dc_mode)]
    got = loaded(y, sens, mask)
    with torch.no_grad():
        want = model(y, sens, mask)
    np.testing.assert_allclose(got.prediction.numpy(), want.prediction.numpy(), rtol=1e-6, atol=1e-7)
    assert verify_runtime(model, (y, sens, mask), path)


def test_exported_normal_operator_keeps_the_in_place_mask_stage(tmp_path):
    """The conjugate-gradient normal operator (the zoo's ResNet) exports with
    its expand, in-place mask and reduce stages, in order: the program equals
    the operator."""
    y, sens, mask = (torch.from_numpy(a) for a in _data(3))
    x = y[:, 0].contiguous()

    def fn(x, sens, mask):
        return k2.normal_op(x, sens, mask, 0.5, True, "ortho")

    path = export_model(fn, (x, sens, mask), tmp_path / "normal_op.pt2")
    loaded = load_exported(path)
    assert _graph_ops(loaded.program) == {"k2_expand", "k2_mask", "k2_reduce"}
    np.testing.assert_allclose(loaded(x, sens, mask).numpy(), fn(x, sens, mask).numpy(), rtol=1e-6, atol=1e-6)


def test_exported_cirim_matches_the_jax_forward(tmp_path):
    y, sens, mask = _data(2)
    cfg = cirim_cfg(dc_mode="full")
    params = _jax_params(cfg, y, sens, mask, 4)
    want, _ = _jax_forward(cfg, params, y, sens, mask)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(cirim_params_from_jax(params))
    args = tuple(torch.from_numpy(a) for a in (y, sens, mask))
    got = load_exported(export_model(model.eval(), args, tmp_path / "cirim.pt2"))(*args).prediction.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(want).max())))


def _op_cases(dtype):
    """(op, args, the plain version's result) of every op at small shapes."""
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    eta, z0, sens = t(B, H, W, 2), t(B, H, W, 2), t(B, C, H, W, 2)
    mats = t(B, 3, W, W)
    mask = (torch.rand(B, 1, H, W, generator=torch.Generator().manual_seed(3)) < 0.5).float()
    kc = torch.complex(t(B, C, H, W), t(B, C, H, W))
    y = t(B, C, H, W, 2)
    x = t(B, 16, 4, 6).contiguous(memory_format=torch.channels_last)
    h = t(B, 8, 4, 6).contiguous(memory_format=torch.channels_last)
    wt, bias, hh = t(8, 16, 1, 1), t(8), t(1, 8, 1, 1).abs()
    cast = lambda *a: [v.to(dtype) for v in a]  # noqa: E731
    cases = [
        (k1.psf1d_dc_op, (*cast(eta, sens, mats, z0), 0.7), k1.psf1d_dc_plain(*cast(eta, sens, mats, z0), 0.7)),
        (k3.indrnn_op, (*cast(x, h, wt, bias, hh),), k3.indrnn_plain(*cast(x, h, wt, bias, hh))),
        (k3.indrnn_op, (*cast(x, h, wt), None, *cast(hh)), k3.indrnn_plain(*cast(x, h, wt), None, *cast(hh))),
        *[(k4.edge_pad_op, (*cast(v), 2), k4.edge_pad_plain(*cast(v), 2)) for v in (x, x.contiguous())],
        *[(k4.bias_act_op, (*cast(h), b, act), k4.bias_act_plain(*cast(h), b, act))
          for b in (*cast(bias), None) for act in (1, 2)],
        (k4.bias_act_op, (*cast(h, bias), 0), k4.bias_act_plain(*cast(h, bias), 0)),
    ]
    if dtype == torch.float32:
        cases += [
            (k2.expand_op, (eta, sens, True), k2.expand_plain(eta, sens, True)),
            (k2.load_op, (y, mask, True, False), k2.load_plain(y, mask, True, False)),
            (k2.load_op, (y, None, True, True), k2.load_plain(y, None, True, True)),
            (k2.reduce_op, (kc, sens, eta, True, 0.5), k2.reduce_plain(kc, sens, eta, True, 0.5)),
            (k2.reduce_op, (kc, sens, None, False, 1.0), k2.reduce_plain(kc, sens, None, False, 1.0)),
            (k2.residual_op, (kc.clone(), y, mask, True), k2.residual_plain(kc, y, mask, True)),
            (k2.apply_mask_op, (kc.clone(), mask, False), k2.apply_mask_plain(kc, mask, False)),
        ]
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ops_fake_implementations_and_cpu_results(dtype):
    """``opcheck``'s schema and fake-tensor checks (the fake output's shape,
    dtype and strides against the real one's), then each op's CPU result
    against its kernel's plain version bit for bit (the in-place stages:
    their first argument after the call)."""
    for op, args, want in _op_cases(dtype):
        torch.library.opcheck(op, [a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                              test_utils=("test_schema", "test_faketensor"))
        got = op(*args)
        got = args[0] if got is None else got
        assert got.dtype == want.dtype and got.shape == want.shape, op
        assert torch.equal(got, want), op


def test_wrappers_take_their_launch_outside_an_export():
    """Outside an export no wrapper calls an op: the eager forward (and its
    backward) dispatch no ``mridc_tpu_torch::`` op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    y, sens, mask = (torch.from_numpy(a) for a in _data())
    for name, dc_mode in sorted(OPS):
        model = build_model(_model_cfg(name, dc_mode), device="cpu")
        with Record():
            model(y, sens, mask).prediction.sum().backward()
    assert seen and not [f for f in seen if f.startswith("mridc_tpu_torch")]
