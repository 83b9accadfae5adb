"""Quantitative (multi-echo) preprocessing: map initialization + transforms
(counterpart of ``mridc_tpu/data/qtransforms.py``, the same numpy code).

Functional parity with reference:
mridc/collections/quantitative/parts/transforms.py (``qMRIDataTransforms`` :21,
``precompute_quantitative_maps`` :553-589 — least-squares fits over the echo
train, phase unwrapping) and qrim/utils.py's
``R2star_B0_real_S0_complex_mapping``.

Phase unwrapping uses our numpy implementation of skimage's own algorithm
(Herraez reliability-sorted region merging, ``ops/unwrap.py``) —
algorithmic parity with the reference's ``skimage.restoration.unwrap_phase``.
The previous Ghiglia–Romero DCT Poisson solver remains available as
``unwrap_phase_dct`` (least-squares approximation).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy.fft import dctn, idctn

from mridc_tpu_torch.data.transforms import MRIDataTransforms, _np_ifft2

from mridc_tpu_torch.ops.unwrap import unwrap_phase_2d  # noqa: F401 (Herraez, skimage-equivalent)

__all__ = ["unwrap_phase_2d", "unwrap_phase_dct", "fit_quantitative_maps", "qMRIDataTransforms"]

SCALING = 1e-3


def unwrap_phase_dct(phase: np.ndarray) -> np.ndarray:
    """Ghiglia-Romero DCT-based 2D phase unwrapping (least-squares)."""
    h, w = phase.shape

    def wrap(x):
        return np.angle(np.exp(1j * x))

    dy = wrap(np.vstack([np.diff(phase, axis=0), np.zeros((1, w))]))
    dx = wrap(np.hstack([np.diff(phase, axis=1), np.zeros((h, 1))]))
    rho = np.vstack([dy[:1], np.diff(dy, axis=0)]) + np.hstack([dx[:, :1], np.diff(dx, axis=1)])

    dct_rho = dctn(rho, norm="ortho")
    yy, xx = np.mgrid[:h, :w]
    denom = 2 * (np.cos(np.pi * yy / h) + np.cos(np.pi * xx / w) - 2)
    denom[0, 0] = 1.0
    phi = dct_rho / denom
    phi[0, 0] = 0.0
    out = idctn(phi, norm="ortho")
    # the Poisson solve loses the absolute offset; restore it circularly so the
    # temporal phase evolution (B0) survives for spatially smooth phases
    offset = np.angle(np.exp(1j * (phase - out)).mean())
    return (out + offset).astype(np.float32)


def fit_quantitative_maps(
    echo_images: np.ndarray,
    tes: Sequence[float],
    mask_brain: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Least-squares init of (R2*, S0, B0, phi) from multi-echo images.

    echo_images: [E, H, W] complex; tes in ms (reference scaling 1e-3).
    Magnitude: log-linear fit -> R2*, |S0|; phase: linear fit of unwrapped
    phase over TEs -> B0 (slope), phi (intercept treated as the imaginary S0
    component, matching the reference's complex-S0 convention).
    """
    tes = np.asarray(tes, np.float64) * SCALING
    e = len(tes)
    mag = np.abs(echo_images).astype(np.float64) + 1e-8
    logm = np.log(mag)

    # weighted least squares over echoes: log|S| = log|S0| - TE * R2*
    t_mean = tes.mean()
    t_var = ((tes - t_mean) ** 2).sum()
    slope = ((tes - t_mean)[:, None, None] * (logm - logm.mean(0))).sum(0) / t_var
    r2star = np.clip(-slope, 0, None)
    log_s0 = logm.mean(0) - slope * t_mean
    # clamp: a log-linear fit on noise voxels can put the intercept at +-60,
    # exploding exp() into 1e26-scale S0 inits that destabilize training
    s0 = np.exp(np.clip(log_s0, -30.0, 30.0))

    phases = np.stack([unwrap_phase_2d(np.angle(echo_images[i])) for i in range(e)])
    ph_slope = ((tes - t_mean)[:, None, None] * (phases - phases.mean(0))).sum(0) / t_var
    b0 = -ph_slope  # signal model rotates by exp(-i TE s B0)
    phi0 = phases.mean(0) - ph_slope * t_mean
    # complex S0 split (reference: S0_real = |S0| cos(phi), S0_imag = |S0| sin(phi))
    s0_real = s0 * np.cos(phi0)
    s0_imag = s0 * np.sin(phi0)

    maps = {
        "R2star_map": r2star.astype(np.float32),
        "S0_map": s0_real.astype(np.float32),
        "B0_map": b0.astype(np.float32),
        "phi_map": s0_imag.astype(np.float32),
    }
    if mask_brain is not None:
        for k in maps:
            maps[k] = maps[k] * np.asarray(mask_brain, np.float32)
    return maps


class qMRIDataTransforms(MRIDataTransforms):
    """Multi-echo transform pipeline: applies the base pipeline per echo and
    precomputes the quantitative map initialization (reference
    quantitative/parts/transforms.py:21)."""

    def __init__(self, TEs: Sequence[float], precompute_quantitative_maps: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.TEs = list(TEs)
        self.precompute_quantitative_maps = precompute_quantitative_maps

    def __call__(self, kspace, sensitivity_map, mask, *args, **kwargs):
        """kspace: [E, C, H, W] complex. Returns the base 10-tuple plus a dict
        of initial quantitative maps appended to attrs.

        The base single-echo pipeline runs per echo, but with ONE shared mask
        draw: all echoes are seeded identically (the reference masks the whole
        echo stack once), so the returned mask/acc describe every echo even
        with ``use_seed=False``.
        """
        fname = args[3] if len(args) > 3 else kwargs.get("fname", "")
        salt = int(np.random.randint(0, 2**31 - 1)) if not self.use_seed else 0
        self._seed_override = (salt,) + tuple(map(ord, str(fname)))
        try:
            echoes = []
            for e in range(kspace.shape[0]):
                echoes.append(super().__call__(kspace[e], sensitivity_map, mask, *args, **kwargs))
        finally:
            self._seed_override = None
        # stack per-echo outputs along a leading echo axis where arraylike
        (k, mk, s, m, pred, tgt, fname, sidx, acc, attrs) = echoes[0]
        kspaces = np.stack([e[0] for e in echoes], 0)
        masked = [np.stack([e[1][i] for e in echoes], 0) for i in range(len(mk))] if isinstance(mk, list) else np.stack([e[1] for e in echoes], 0)
        preds = [np.stack([np.asarray(e[4][i]) for e in echoes], 0) for i in range(len(pred))] if isinstance(pred, list) else np.stack([np.asarray(e[4]) for e in echoes], 0)
        targets = np.stack([np.asarray(e[5]) for e in echoes], 0)
        # keep every echo's pre-normalization vars (echo 0's attrs alone could
        # not unnormalize echoes 1..E-1)
        attrs = dict(attrs)
        attrs["per_echo_attrs"] = [dict(e[9]) for e in echoes]

        if self.precompute_quantitative_maps:
            echo_imgs = _np_ifft2(kspaces, self.fft_centered, self.fft_normalization, self.spatial_dims)
            if self.normalization.enabled:
                # per-echo normalization flattens the inter-echo decay the
                # R2* fit measures — undo each echo's affine (applied in image
                # domain by the base pipeline) before fitting
                restored = []
                for e_idx, e_out in enumerate(echoes):
                    ea = e_out[9]
                    img = echo_imgs[e_idx]
                    ntype = str(self.normalization.normalization_type)
                    if ntype == "max":
                        img = img * ea.get("kspace_max", 1.0)
                    elif ntype == "mean":
                        img = img * ea.get("kspace_std", 1.0) + ea.get("kspace_mean", 0.0)
                    elif ntype == "minmax":
                        span = ea.get("kspace_max", 1.0) - ea.get("kspace_min", 0.0)
                        img = img * span + ea.get("kspace_min", 0.0)
                    restored.append(img)
                echo_imgs = np.stack(restored, 0)
            sens_e = np.asarray(s)[None]
            if self.coil_combination_method == "SENSE" and sens_e.size > 1:
                combined = (echo_imgs * np.conj(sens_e)).sum(axis=1)
            else:
                combined = np.sqrt((np.abs(echo_imgs) ** 2).sum(axis=1)).astype(np.complex64, copy=False)
            attrs["quantitative_maps_init"] = fit_quantitative_maps(combined, self.TEs)
            attrs["TEs"] = list(self.TEs)

        return (kspaces, masked, s, m, preds, targets, fname, sidx, acc, attrs)
