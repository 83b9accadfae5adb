"""The benchmark's own tests (CPU; the one card test skips without a card).

    python -m pytest benchmark/tests -q

They put ``benchmark/`` and the repository root on the import path, as
``benchmark/run.py`` does, and run torch on one thread."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_cell(name: str, batch: int = 2):
    """Cell ``name`` at a size the CPU runs in seconds: 3 coils, 32 x 32, two
    cascades (CIRIM two steps each, VarNet 4 channels and 2 pools), batch
    ``batch``, four pool batches; a bank mask becomes the 1D mask."""
    from mribench.spec import load_cell

    c = load_cell(name)
    c.cfg, c.mix = copy.deepcopy(c.cfg), copy.deepcopy(c.mix)
    c.cfg.update(coils=3, height=32, width=32)
    m = c.cfg["model"]
    if m["model_name"] == "CIRIM":
        m.update(num_cascades=2, time_steps=2)
    else:
        m.update(num_cascades=2, channels=4, pooling_layers=2)
    c.mix.update(batch=batch, pool_batches=4, sample_batches=3, trace_calls=2)
    if c.mix["mask"]["type"] == "bank":
        c.mix["mask"] = {"type": "equispaced1d", "acceleration": 4, "center_fraction": 0.08}
    return c


@pytest.fixture
def tiny():
    return tiny_cell
