"""The run's rule on JAX: compared by whole top-level module name, and not
met by anything the harness, the references or the program's run path load."""

import subprocess
import sys

from mribench.spec import BENCH


def _run_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run", BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_whole_names():
    run = _run_module()
    assert run.loaded_forbidden({"mridc_tpu_torch": 1, "mridc_tpu_torch.kernels": 1, "jaxtyping": 1}) == []
    assert run.loaded_forbidden({"mridc_tpu.nn.dc": 1}) == ["mridc_tpu"]
    assert run.loaded_forbidden({"jaxlib.xla_client": 1, "flax": 1, "ml_dtypes": 1}) == ["flax", "jaxlib", "ml_dtypes"]


def test_run_path_loads_no_jax():
    """A fresh interpreter that imports what a run imports (the harness, the
    references, the program's trainer and models) holds none of the names."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch, mribench.cell, mribench.devtrace, calibrate\n"
        "from mribench.spec import load_cell\n"
        "[load_cell(w) for w in ('cirim_psf1d_bf16_serve', 'varnet_psf1d_bf16_serve', 'cirim_full_f32_train')]\n"
        "import mridc_tpu_torch.kernels, mridc_tpu_torch.train.trainer, mridc_tpu_torch.models\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', %r); m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m); print(m.loaded_forbidden())\n"
    ) % (str(BENCH), str(BENCH.parent), str(BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
