"""Port parity: the command line. ``python -m mridc_tpu_torch run -c
projects/reconstruction/conf/base_cirim_train.yaml mode=test ...`` in a
process of its own writes the reconstructions ``mridc_tpu``'s launcher writes
from the same archive (rtol 2e-3 / atol 2e-4); ``sweep`` runs its jobs and
``app`` serves its page. The fixture volumes, the archive and the overrides
are ``test_torch_port_launch.py``'s.
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
def test_unported_commands_raise_naming_m13(command, monkeypatch, tmp_path):
    """``sweep`` expands ``--set`` into two jobs of the port's launcher on the
    config and runs them (each as a dry interpreter run in place of the
    training) and exits 0 when both do; ``app`` serves the run-builder's page
    from a process of its own. (The name is the one the test had while both
    commands raised.)"""
    if command == "sweep":
        from mridc_tpu_torch.utils import sweep

        seen, real = [], sweep.subprocess.Popen

        def popen(cmd, env):
            seen.append(cmd)
            return real([sys.executable, "-c", "pass"])

        monkeypatch.setattr(sweep.subprocess, "Popen", popen)
        with pytest.raises(SystemExit) as done:
            cli.main(["sweep", "-c", str(YAML), "--set", "trainer.max_epochs=1,2"])
        assert done.value.code == 0
        assert seen == [[sys.executable, "-m", "mridc_tpu_torch.launch", "--config-path", str(YAML.parent),
                         "--config-name", YAML.name, f"trainer.max_epochs={n}"] for n in (1, 2)]
        return
    import socket
    import time
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-m", "mridc_tpu_torch", "app", "--port", str(port)], cwd=tmp_path,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline, page = time.time() + 120, None
        while page is None and time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as r:
                    page = r.read()
            except OSError:
                time.sleep(0.2)
        assert page is not None and b"mridc_tpu_torch run builder" in page, proc.poll()
    finally:
        proc.kill()
        proc.wait(timeout=30)
