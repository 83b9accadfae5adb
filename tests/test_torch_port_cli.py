"""Port parity: the command line. ``python -m mridc_tpu_torch run -c
projects/reconstruction/conf/base_cirim_train.yaml mode=test ...`` in a
process of its own writes the reconstructions ``mridc_tpu``'s launcher writes
from the same archive (rtol 2e-3 / atol 2e-4); the commands that are not
ported raise, naming their ROADMAP.md item. The fixture volumes, the archive
and the overrides are ``test_torch_port_launch.py``'s.
"""

import os
import subprocess
import sys

import pytest

from mridc_tpu import launch as jlaunch
from mridc_tpu.train import config as jconfig
from mridc_tpu_torch import cli

from test_torch_port_launch import ROOT, SMALL, YAML, _close, _run_dir, setup  # noqa: F401  (setup: a fixture)


def test_test_mode_writes_the_jax_reconstructions(setup, tmp_path):
    """``mode=test`` through ``python -m mridc_tpu_torch`` in a process of its
    own, against the JAX launcher in this one, from the same archive."""
    import h5py

    root, common = setup
    over = SMALL + common + ["mode=test"]
    jlaunch.run_from_config(jconfig.load_config(YAML, over + [f"exp_manager.exp_dir={tmp_path / 'jax'}"]))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-m", "mridc_tpu_torch", "run", "-c", str(YAML), *over,
                    f"exp_manager.exp_dir={tmp_path / 'port'}"], check=True, cwd=tmp_path, env=env, timeout=300)
    jrec, prec = _run_dir(tmp_path / "jax") / "reconstructions", _run_dir(tmp_path / "port") / "reconstructions"
    names = sorted(p.name for p in jrec.iterdir())
    assert names and names == sorted(p.name for p in prec.iterdir())
    for n in names:
        with h5py.File(jrec / n) as j, h5py.File(prec / n) as p:
            _close(p["reconstruction"][()], j["reconstruction"][()], n)


@pytest.mark.parametrize("command", ["sweep", "app"])
def test_unported_commands_raise_naming_m13(command):
    args = ["sweep", "-c", str(YAML)] if command == "sweep" else ["app"]
    with pytest.raises(NotImplementedError, match="M13"):
        cli.main(args)
