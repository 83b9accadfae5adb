"""The numbers that decide ``correct``, each held against its limit.

Serving: ``pred_rel_l2``, the relative l2 gap sqrt(sum ||p - r||^2 /
sum ||r||^2) between the served slices and the reference's, pooled over the
answers sampled from the window (an answer missing or of another shape: inf).

Training, over the first three steps the window's own call took:
``loss_gap``, the largest |L - L_ref| / |L_ref| of the three losses;
``grad_gap``, the first step's gradient, the worst leaf's
|‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖);
``change_gap``, the parameters' change after the three steps, by the same
measure, over the leaves whose reference gradient is more than a thousandth
of the median leaf's (a gradient nought to rounding moves a leaf under Adam
by round-off alone); ``grad_gap_median`` and ``change_gap_median``, the
median leaf's gap of the two, steady from seed to seed where one small
leaf's noise swings the worst.

A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Tuple

__all__ = ["leaf_gaps", "moving_leaves", "training_numbers", "worst_leaves", "verdict"]

STILL = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's takes no part in the change


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: Iterable[str]) -> Dict[str, float]:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)} over ``keys``."""
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys}


def _worst(gaps: Dict[str, float]) -> float:
    return math.nan if any(g != g for g in gaps.values()) else max(gaps.values())


def _median(gaps: Dict[str, float]) -> float:
    return math.nan if any(g != g for g in gaps.values()) else statistics.median(gaps.values())


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v > STILL * median]


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [3], "grad": {leaf: norm}, "change": {leaf: norm}}."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], moving_leaves(ref["grad"]))
    return {"loss_gap": math.nan if any(g != g for g in gaps) else max(gaps),
            "grad_gap": _worst(grad), "change_gap": _worst(change),
            "grad_gap_median": _median(grad), "change_gap_median": _median(change)}


def worst_leaves(prog: dict, ref: dict) -> Dict[str, list]:
    """The leaf behind each worst-leaf number, with its two norms and the
    median leaf's reference norm: [leaf, program, reference, median]."""
    out = {}
    for key, keys in (("grad", list(ref["grad"])), ("change", moving_leaves(ref["grad"]))):
        gaps = leaf_gaps(prog[key], ref[key], keys)
        leaf = max(gaps, key=lambda k: (gaps[k] == gaps[k], gaps[k]))
        out[key] = [leaf, prog[key][leaf], ref[key][leaf], statistics.median(ref[key][k] for k in keys)]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(all numbers within their limits, {name: {"value", "limit"}}); a
    number missing or NaN is not within its limit."""
    out = {k: {"value": numbers.get(k, math.nan), "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in out.values())  # NaN <= x is False
    return ok, out
