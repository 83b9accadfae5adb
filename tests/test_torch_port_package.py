"""Package rules of mridc_tpu_torch: it imports neither JAX nor the JAX
package, its entry points never move to the CPU on their own, and every model
name of the JAX registry either builds or names the ROADMAP item that ports it.

The import rule is checked on the source (an AST scan): a ``sys.modules``
check cannot work in a process where JAX is already imported.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest
import torch

import mridc_tpu_torch
from mridc_tpu_torch.kernels import binding
from mridc_tpu.models import available_models as jax_models
from mridc_tpu_torch.models import PENDING_MODELS, available_models, build_model

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mridc_tpu")


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
    assert available_models() == ["CIRIM", "E2EVN", "RIM", "VARNET", "VN"]
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
    with pytest.raises(NotImplementedError, match="M8"):
        build_model({"model_name": "CIRIM", "use_sens_net": True}, device="cpu")


def test_weights_come_from_the_generator_alone():
    cfg = {"model_name": "CIRIM", "num_cascades": 2, "conv_filters": [8, 8, 2], "recurrent_filters": [8, 8, 0]}
    state = torch.random.get_rng_state()
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert torch.equal(state, torch.random.get_rng_state())
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(p.is_contiguous(memory_format=torch.channels_last) for k, p in a.items() if p.ndim == 4)
