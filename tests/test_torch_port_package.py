"""Package rules of mridc_tpu_torch: it imports neither JAX (nor ml_dtypes) nor the JAX
package, its entry points never move to the CPU on their own, and every model
name of the JAX registry either builds or names the ROADMAP item that ports it.

The import rule is checked on the source (an AST scan): a ``sys.modules``
check cannot work in a process where JAX is already imported.
"""

import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mridc_tpu_torch
from mridc_tpu_torch.kernels import binding
from mridc_tpu.models import available_models as jax_models
from mridc_tpu_torch.models import PENDING_MODELS, available_models, build_model

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "mridc_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sources():
    files = sorted(Path(mridc_tpu_torch.__file__).parent.rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", sorted(binding.SOURCES))
def test_bound_entry_points_match_their_c_declarations(name):
    """ctypes passes what ``argtypes`` says, whatever the C function takes: each
    entry point of ``binding.SOURCES`` (plus the trailing stream) and
    ``binding.QUERIES`` takes as many arguments, pointers where pointers, as its
    ``extern "C"`` declaration in ``csrc/<name>.cu``."""
    src = (binding.CSRC / f"{name}.cu").read_text()
    decls = {m.group(1): [a.strip() for a in m.group(2).split(",")]
             for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    symbols = {**{s: (*a, ctypes.c_void_p) for s, a in binding.SOURCES[name].items()},
               **binding.QUERIES.get(name, {})}
    for sym, argtypes in symbols.items():
        assert sym in decls, f"{sym} is not declared in {name}.cu"
        params = decls[sym]
        assert len(params) == len(argtypes), f"{sym}: {len(params)} C parameters, {len(argtypes)} argtypes"
        for p, a in zip(params, argtypes):
            pointer = a is ctypes.c_void_p or issubclass(a, ctypes._Pointer)
            assert ("*" in p) == pointer, f"{sym}: {p!r} bound as {a.__name__}"


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model({"model_name": "CIRIM"})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model({"model_name": "CIRIM"}, device="cuda")
    assert next(build_model({"model_name": "CIRIM", "num_cascades": 1}, device="cpu").parameters()).device.type == "cpu"


def test_every_jax_model_name_builds_or_names_its_roadmap_item():
    assert available_models() == ["CASCADENET", "CCNN", "CIRIM", "CRNN", "CRNNET", "CS", "DUNET", "E2EVN", "IDSLR",
                                  "IDSLRUNET", "JOINTICNET", "JRSCIRIM", "KIKINET", "LPD", "LPDNET", "MTLRS", "MULTIDOMAIN",
                                  "MULTIDOMAINNET", "PG", "PICS", "PROXIMALGRADIENT", "QCIRIM", "QRIM", "QVARNET",
                                  "QVN", "RECSEGNET", "RECSEGUNET", "RECURRENTVARNET", "RESNET", "RIM", "RVN",
                                  "SEGMENTATION2DUNET", "SEGMENTATION3DUNET", "SEGMENTATIONATTENTIONUNET",
                                  "SEGMENTATIONDYNUNET", "SEGMENTATIONLAMBDAUNET", "SEGMENTATIONUNET",
                                  "SEGMENTATIONUNETR", "SEGMENTATIONVNET", "SEGNET", "SERANET", "UNET", "VARNET", "VN",
                                  "VSNET", "XPDNET", "ZF"]
    for name in jax_models():
        if name in available_models():
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP M"):
            build_model({"model_name": name}, device="cpu")
    assert set(jax_models()) == set(available_models()) | set(PENDING_MODELS)


def test_config_errors_are_loud():
    with pytest.raises(ValueError, match="Unknown model_name"):
        build_model({"model_name": "NOPE"}, device="cpu")
    with pytest.raises(ValueError, match="dc_mode"):
        build_model({"model_name": "CIRIM", "dc_mode": "fast"}, device="cpu")
    with pytest.raises(ValueError, match="remat_mode"):
        build_model({"model_name": "CIRIM", "remat_mode": "all"}, device="cpu")
    with pytest.raises(ValueError, match="use_sens_net is not supported for QCIRIM"):
        build_model({"model_name": "QCIRIM", "use_sens_net": True}, device="cpu")
    wrapped = build_model({"model_name": "CIRIM", "use_sens_net": True}, device="cpu")
    assert type(wrapped).__name__ == "CIRIMWithSensNet" and hasattr(wrapped, "sens_net")


def test_weights_come_from_the_generator_alone():
    cfg = {"model_name": "CIRIM", "num_cascades": 2, "conv_filters": [8, 8, 2], "recurrent_filters": [8, 8, 0]}
    state = torch.random.get_rng_state()
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert torch.equal(state, torch.random.get_rng_state())
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(p.is_contiguous(memory_format=torch.channels_last) for k, p in a.items() if p.ndim == 4)


def test_launch_modules_import_without_h5py_yaml_msgpack_or_tensorboard(tmp_path):
    """In a fresh interpreter where jax, h5py, PyYAML, msgpack and tensorboard
    cannot be imported (optional packages a GPU host may lack): the
    launch path's modules import; configs the port writes (JSON text) read
    back; JSON override values parse; an experiment manager asked for
    TensorBoard warns and logs nowhere; a torch archive saves and restores;
    and each optional package, where it is needed, raises an ImportError that
    names it."""
    code = f"""
import sys, tarfile, io, logging
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "h5py", "yaml", "msgpack", "tensorboard"):
    sys.modules[name] = None
import mridc_tpu_torch.launch, mridc_tpu_torch.cli, mridc_tpu_torch.evaluate, mridc_tpu_torch.utils.logging
import mridc_tpu_torch.train.schemas
from mridc_tpu_torch.train import checkpoints, config
from mridc_tpu_torch.train.exp_manager import ExpManager
from pathlib import Path
tmp = Path({str(tmp_path)!r})
cfg = config.apply_overrides({{"a": {{"b": 1}}}}, ['a.b=1e-3', 'a.c="x/y"', 'a.d=[1, 2]', 'a.e=null', 'a.f=true'])
assert cfg == {{"a": {{"b": 1e-3, "c": "x/y", "d": [1, 2], "e": None, "f": True}}}}, cfg
config.save_config(cfg, tmp / "c.yaml")
assert config.load_config(tmp / "c.yaml") == cfg
em = ExpManager(exp_dir=str(tmp), name="x", create_tensorboard_logger=True, model_config={{"model_name": "CIRIM"}})
assert em.writer is None and (em.log_dir / "hparams.yaml").exists()
from mridc_tpu_torch.models import build_model
import torch
model = build_model({{"model_name": "CIRIM", "num_cascades": 1, "time_steps": 1, "conv_filters": [4, 4, 2],
                      "recurrent_filters": [4, 4, 0]}}, device="cpu")
path = checkpoints.save_archive(tmp / "m.mridc", {{"model_name": "CIRIM", "num_cascades": 1, "time_steps": 1,
                                "conv_filters": [4, 4, 2], "recurrent_filters": [4, 4, 0]}}, model.state_dict())
restored, _, _ = checkpoints.restore_model(path, device="cpu")
assert all(torch.equal(restored.state_dict()[k], v) for k, v in model.state_dict().items())
def raises(fn, word):
    try:
        fn()
    except ImportError as exc:
        assert word in str(exc), exc
    else:
        raise AssertionError("no ImportError for " + word)
(tmp / "y.yaml").write_text("a: b\\n")
raises(lambda: config.load_config(tmp / "y.yaml"), "PyYAML")
raises(lambda: config.parse_value("plain words"), "PyYAML")
raises(lambda: mridc_tpu_torch.evaluate.evaluate(tmp, tmp), "h5py")
with tarfile.open(tmp / "f.mridc", "w:gz") as tar:
    for n, d in (("model_config.yaml", b'{{"model_name": "CIRIM"}}'), ("model_weights.msgpack", b"x")):
        info = tarfile.TarInfo(n); info.size = len(d); tar.addfile(info, io.BytesIO(d))
raises(lambda: checkpoints.load_archive(tmp / "f.mridc"), "msgpack")
assert not any(sys.modules.get(m) is not None for m in ("jax", "h5py", "yaml", "msgpack", "tensorboard"))
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env,
                         cwd=tmp_path)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
