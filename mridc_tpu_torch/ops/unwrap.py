"""2D phase unwrapping, Herraez et al. 2002 (counterpart of
``mridc_tpu/ops/unwrap.py``, the same numpy code): the algorithm behind
``skimage.restoration.unwrap_phase``, which the reference's quantitative
transforms import, as reliability-sorted region merging in pure numpy on the
host.

Algorithm (matching skimage's unwrap_2d_ljmu.c, not just the paper): each
pixel gets the value H^2 + V^2 + D1^2 + D2^2 of its wrapped second
differences (SMALLER = more reliable; no sqrt/reciprocal — the C code sorts
raw squared sums), border pixels get a huge value so their edges merge last,
and edges between 4-neighbors are processed in ASCENDING order of summed
pixel values, merged with union-find, shifting the joining group by the 2-pi
multiple that makes the joining edge continuous.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unwrap_phase_2d", "unwrap_phase"]

_TWO_PI = 2.0 * np.pi


def _wrap(d: np.ndarray) -> np.ndarray:
    return (d + np.pi) % _TWO_PI - np.pi


_BORDER_VALUE = 1e8  # skimage initializes border pixels to ~9999999 (+rand)


def _reliability(p: np.ndarray) -> np.ndarray:
    """Per-pixel H^2 + V^2 + D1^2 + D2^2 of wrapped second differences
    (smaller = more reliable); image-border pixels get ``_BORDER_VALUE`` so
    their edges merge last — both matching skimage's C implementation."""
    c = p[1:-1, 1:-1]
    h = _wrap(p[1:-1, :-2] - c) - _wrap(c - p[1:-1, 2:])
    v = _wrap(p[:-2, 1:-1] - c) - _wrap(c - p[2:, 1:-1])
    d1 = _wrap(p[:-2, :-2] - c) - _wrap(c - p[2:, 2:])
    d2 = _wrap(p[:-2, 2:] - c) - _wrap(c - p[2:, :-2])
    out = np.full(p.shape, _BORDER_VALUE, dtype=np.float64)
    out[1:-1, 1:-1] = h * h + v * v + d1 * d1 + d2 * d2
    return out


def unwrap_phase_2d(phase: np.ndarray) -> np.ndarray:
    """Unwrap a 2D wrapped phase image (radians)."""
    p = np.asarray(phase, dtype=np.float64)
    hgt, wid = p.shape
    n = hgt * wid
    rel = _reliability(p).ravel()
    flat = p.ravel()

    # edges between 4-neighbors, most reliable (smallest summed value) first
    idx = np.arange(n).reshape(hgt, wid)
    ea = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    eb = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    er = rel[ea] + rel[eb]
    order = np.argsort(er, kind="stable")
    ea, eb = ea[order], eb[order]

    # union-find where shift[i] is i's 2-pi multiple relative to its parent
    parent = np.arange(n)
    size = np.ones(n, dtype=np.int64)
    shift = np.zeros(n, dtype=np.int64)

    def find(i):
        """Root of i; path-compresses so shift[i] becomes root-relative."""
        path = []
        while parent[i] != i:
            path.append(i)
            i = parent[i]
        acc = 0
        for node in reversed(path):
            acc += shift[node]
            parent[node] = i
            shift[node] = acc
        return i

    for a, b in zip(ea.tolist(), eb.tolist()):
        ra = find(a)
        rb = find(b)
        if ra == rb:
            continue
        ua = flat[a] + _TWO_PI * shift[a]
        ub = flat[b] + _TWO_PI * shift[b]
        # k: 2-pi increment for b's group so ub + 2*pi*k matches ua
        k = int(np.round((ua - ub) / _TWO_PI))
        if size[ra] < size[rb]:
            parent[ra] = rb
            shift[ra] = -k
            size[rb] += size[ra]
        else:
            parent[rb] = ra
            shift[rb] = k
            size[ra] += size[rb]

    for i in range(n):
        find(i)
    return (flat + _TWO_PI * shift).reshape(hgt, wid)


def unwrap_phase(phase: np.ndarray) -> np.ndarray:
    """Unwrap 2D, or 3D slice-by-slice with inter-slice 2-pi alignment
    (approximation of skimage's full 3D merge for volumetric inputs,
    documented in PARITY.md)."""
    p = np.asarray(phase)
    if p.ndim == 2:
        return unwrap_phase_2d(p)
    if p.ndim == 3:
        out = np.empty(p.shape, dtype=np.float64)
        out[0] = unwrap_phase_2d(p[0])
        for i in range(1, p.shape[0]):
            u = unwrap_phase_2d(p[i])
            k = np.round(np.median(out[i - 1] - u) / _TWO_PI)
            out[i] = u + _TWO_PI * k
        return out
    raise ValueError(f"unwrap_phase supports 2D/3D, got {p.ndim}D")
