"""Offline reconstruction evaluation (counterpart of ``mridc_tpu/evaluate.py``):
metrics over dumped h5 reconstructions against the target volumes, on the
port's ``metrics/reconstruction.py``. h5py is imported where a file is read.

Usage:
    python -m mridc_tpu_torch.evaluate --targets /data/test --reconstructions out/recons
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from mridc_tpu_torch.metrics.reconstruction import METRIC_FUNCS, ReconstructionMetrics


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading h5 volumes needs h5py (pip install h5py)") from e
    return h5py


def _load_target(path: Path) -> np.ndarray:
    with _h5py().File(path, "r") as hf:
        for key in ("reconstruction_rss", "reconstruction_sense", "reconstruction", "target"):
            if key in hf:
                return np.abs(np.asarray(hf[key]))
    raise KeyError(f"No target volume found in {path}")


def evaluate(targets_dir, recons_dir, normalize: bool = True):
    h5py = _h5py()
    metrics = ReconstructionMetrics(METRIC_FUNCS)
    recons_dir = Path(recons_dir)
    n = 0
    for tfile in sorted(Path(targets_dir).glob("*.h5")):
        rfile = recons_dir / tfile.name
        if not rfile.exists():
            continue
        target = _load_target(tfile)
        with h5py.File(rfile, "r") as hf:
            recon = np.abs(np.asarray(hf["reconstruction"]))
        if target.ndim == 2:
            target = target[None]
        if recon.ndim == 2:
            recon = recon[None]
        hh = min(target.shape[-2], recon.shape[-2])
        ww = min(target.shape[-1], recon.shape[-1])
        target = target[..., :hh, :ww]
        recon = recon[..., :hh, :ww]
        if normalize:
            target = target / max(target.max(), 1e-12)
            recon = recon / max(recon.max(), 1e-12)
        metrics.push(target, recon)
        n += 1
    return metrics, n


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate dumped reconstructions against targets")
    parser.add_argument("--targets", required=True)
    parser.add_argument("--reconstructions", required=True)
    parser.add_argument("--no-normalize", action="store_true")
    args = parser.parse_args(argv)
    metrics, n = evaluate(args.targets, args.reconstructions, normalize=not args.no_normalize)
    print(f"{n} volumes evaluated")
    print(repr(metrics))


if __name__ == "__main__":
    main()
