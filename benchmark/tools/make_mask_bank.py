"""Draw a bank of 2D variable-density Poisson-disc masks with the package's own
masker and store them packed, for traffic mixes that name the bank.

The Poisson-disc masker throws darts in Python (about a minute a 320x320 mask
on one core), so a run cannot draw its masks during set-up; it picks them
from this bank by its seed instead. The masks are stored centred (k-space
centre in the middle), as the masker draws them; a mix with an uncentred FFT
shifts them as the data pipeline's ``shift_mask`` does.

    python3 benchmark/tools/make_mask_bank.py --out benchmark/traffic/masks/poisson2d_a10_cf07_s002_320.npz \
        --count 16 --acceleration 10 --center-fraction 0.7 --scale 0.02 --size 320 320 --workers 4
"""

from __future__ import annotations

import argparse
import multiprocessing
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def draw(args):
    seed, acceleration, center_fraction, scale, h, w = args
    sys.path.insert(0, str(ROOT))
    from mridc_tpu_torch.data.subsample import Poisson2DMaskFunc

    mask, _ = Poisson2DMaskFunc([center_fraction], [acceleration])((1, h, w, 2), seed=seed, scale=scale)
    return np.asarray(mask).reshape(h, w) > 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--count", type=int, default=16)
    p.add_argument("--acceleration", type=float, default=10)
    p.add_argument("--center-fraction", type=float, default=0.7)
    p.add_argument("--scale", type=float, default=0.02)
    p.add_argument("--size", type=int, nargs=2, default=(320, 320))
    p.add_argument("--workers", type=int, default=4)
    a = p.parse_args()
    h, w = a.size
    jobs = [(seed, a.acceleration, a.center_fraction, a.scale, h, w) for seed in range(a.count)]
    with multiprocessing.get_context("spawn").Pool(a.workers) as pool:
        masks = np.stack(pool.map(draw, jobs))
    np.savez_compressed(a.out, bits=np.packbits(masks, axis=-1), shape=np.array(masks.shape),
                        seeds=np.arange(a.count), acceleration=a.acceleration, center_fraction=a.center_fraction,
                        scale=a.scale)
    print(f"{a.out}: {a.count} masks {h}x{w}, sampled share {masks.mean():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
