"""The one generator of the benchmark's inputs: a pool of distinct multicoil
slices drawn from the seed, as a mix file describes it, handed to the
program as host numpy batches (as the data loaders hand them).

A slice is a smooth phantom (a body ellipse and three blobs, a slow phase
ramp) times coil maps of unit root-sum-of-squares (Gaussian coil profiles
placed round the field of view, each with its own phase ramp), plus complex
noise, taken to k-space with the mix's FFT convention, scaled so that its
root-sum-of-squares image peaks at 1 (the pipeline's max normalisation), and
masked. Every seed gives the same sizes; only the values differ.

Masks: ``equispaced1d`` (fastMRI's equispaced column mask: the centre
columns, then columns at the spacing that gives the acceleration, from an
offset drawn per slice) or ``bank`` (masks drawn once by the package's
masker and stored, picked per slice from the seed; see
``benchmark/tools/make_mask_bank.py``). With an uncentred FFT the masks are
shifted into the FFT's order (the pipeline's ``shift_mask``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from mribench.spec import ROOT

__all__ = ["Pool", "make_pool", "equispaced1d", "bank_masks", "seed_stream"]


def seed_stream(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` (weights, data, sampling) of the run seed."""
    return int(np.random.SeedSequence([int(seed) % 2**63, stream]).generate_state(2, np.uint32).view(np.uint64)[0]
               >> np.uint64(1))


@dataclass
class Pool:
    """``batches[i]``: the i-th distinct batch, {key: host numpy array}."""

    batches: List[Dict[str, np.ndarray]]

    def batch(self, i: int) -> Dict[str, np.ndarray]:
        return self.batches[i % len(self.batches)]


def equispaced1d(w: int, acceleration: float, center_fraction: float, offsets: torch.Tensor) -> torch.Tensor:
    """[N, W] float masks: fastMRI's equispaced column mask, one offset a row."""
    low = int(round(w * center_fraction))
    adjusted = acceleration * (low - w) / (low * acceleration - w)
    cols = torch.arange(w, device=offsets.device, dtype=torch.float64)
    n = torch.arange(math.ceil(w / adjusted) + 1, device=offsets.device, dtype=torch.float64)
    raw = offsets[:, None].double() + n[None] * adjusted  # np.arange(offset, w - 1, adjusted), then rounded
    picks = torch.where(raw < w - 1, torch.round(raw), torch.full_like(raw, -1))  # [N, K]
    mask = (cols[None, None, :] == picks[:, :, None]).any(1)
    pad = (w - low + 1) // 2
    mask[:, pad:pad + low] = True
    return mask.float()


def bank_masks(path: str, device) -> torch.Tensor:
    """The bank's masks [M, H, W] (float, centred)."""
    z = np.load(ROOT / path)
    h, w = (int(v) for v in z["shape"][1:])
    bits = np.unpackbits(z["bits"], axis=-1)[..., :w]
    return torch.from_numpy(bits.astype(np.float32)).to(device).reshape(-1, h, w)


def _masks(mix: dict, n: int, h: int, w: int, centered: bool, g: torch.Generator, device) -> torch.Tensor:
    spec = mix["mask"]
    if spec["type"] == "equispaced1d":
        low = int(round(w * spec["center_fraction"]))
        adjusted = spec["acceleration"] * (low - w) / (low * spec["acceleration"] - w)
        offsets = torch.randint(0, round(adjusted), (n,), generator=g, device=device)
        m = equispaced1d(w, spec["acceleration"], spec["center_fraction"], offsets)[:, None, :].expand(n, h, w)
    elif spec["type"] == "bank":
        bank = bank_masks(spec["file"], device)
        m = bank[torch.randint(0, bank.shape[0], (n,), generator=g, device=device)]
    else:
        raise ValueError(f"unknown mask type {spec['type']!r}")
    if not centered:
        m = torch.fft.fftshift(m, dim=(-2, -1))
    return m.contiguous()


def _phantom(n: int, h: int, w: int, g: torch.Generator, device) -> torch.Tensor:
    """[n, H, W] complex images: a body ellipse, three blobs, a phase ramp."""
    yy = torch.linspace(-1, 1, h, device=device)[None, :, None]
    xx = torch.linspace(-1, 1, w, device=device)[None, None, :]
    u = torch.rand(n, 18, generator=g, device=device)
    ry, rx = 0.55 + 0.3 * u[:, 0, None, None], 0.45 + 0.3 * u[:, 1, None, None]
    cy, cx = 0.2 * (u[:, 2, None, None] - 0.5), 0.2 * (u[:, 3, None, None] - 0.5)
    img = torch.sigmoid(40 * (1 - ((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2))
    for k in range(3):
        by, bx = 0.8 * (u[:, 4 + k, None, None] - 0.5), 0.8 * (u[:, 7 + k, None, None] - 0.5)
        s = 0.03 + 0.08 * u[:, 10 + k, None, None]
        img = img + (0.3 + 0.7 * u[:, 13 + k, None, None]) * torch.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * s * s))
    phase = math.pi * (u[:, 16, None, None] * yy + u[:, 17, None, None] * xx)
    return img * torch.exp(1j * phase)


def _coil_maps(n: int, c: int, h: int, w: int, g: torch.Generator, device) -> torch.Tensor:
    """[n, C, H, W] complex maps of unit root-sum-of-squares."""
    yy = torch.linspace(-1, 1, h, device=device)[None, None, :, None]
    xx = torch.linspace(-1, 1, w, device=device)[None, None, None, :]
    u = torch.rand(n, c, 4, generator=g, device=device)
    ang = 2 * math.pi * (torch.arange(c, device=device)[None] / c + 0.05 * u[..., 0])
    py, px = (1.2 * torch.sin(ang))[..., None, None], (1.2 * torch.cos(ang))[..., None, None]
    width = (0.6 + 0.4 * u[..., 1])[..., None, None]
    mag = torch.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * width * width))
    phase = math.pi * ((u[..., 2, None, None] - 0.5) * yy + (u[..., 3, None, None] - 0.5) * xx)
    maps = mag * torch.exp(1j * phase)
    return maps / torch.sqrt((maps.abs() ** 2).sum(1, keepdim=True))


def _fft2(x: torch.Tensor, centered: bool, norm: str) -> torch.Tensor:
    if centered:
        x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.fft2(x, norm=norm)
    return torch.fft.fftshift(x, dim=(-2, -1)) if centered else x


def make_pool(cfg: dict, program_cfg: dict, mix: dict, seed: int, device) -> Pool:
    """``mix["pool_batches"]`` distinct batches of ``mix["batch"]`` slices at
    the configuration's coils and size, from the seed, made on ``device`` a
    batch at a time and copied to the host."""
    c, h, w, b = int(cfg["coils"]), int(cfg["height"]), int(cfg["width"]), int(mix["batch"])
    centered, norm = bool(program_cfg["fft_centered"]), str(program_cfg["fft_normalization"])
    g = torch.Generator(device=device)
    g.manual_seed(seed_stream(seed, 1))
    rv = lambda z: torch.view_as_real(z.to(torch.complex64)).cpu().numpy()  # noqa: E731
    batches = []
    for _ in range(int(mix["pool_batches"])):
        img = _phantom(b, h, w, g, device)
        maps = _coil_maps(b, c, h, w, g, device)
        coil = img[:, None] * maps
        noise = torch.randn(b, c, h, w, 2, generator=g, device=device)
        coil = coil + float(mix.get("noise", 0.01)) * torch.view_as_complex(noise)
        rss = torch.sqrt((coil.abs() ** 2).sum(1))
        scale = 1.0 / rss.amax(dim=(-2, -1), keepdim=True)
        mask = _masks(mix, b, h, w, centered, g, device)
        kspace = _fft2(coil, centered, norm) * scale[:, None] * mask[:, None]
        batch = {"masked_kspace": rv(kspace), "sensitivity_maps": rv(maps), "mask": mask[:, None].cpu().numpy()}
        if mix["mode"] == "train":
            batch["target"] = (rss * scale).float().cpu().numpy()
        batches.append(batch)
    return Pool(batches)
