"""Host-side segmentation metrics (counterpart of
``mridc_tpu/metrics/segmentation.py``, carried over): Dice, IoU,
precision/recall/F1 and the 95th-percentile Hausdorff distance of binary
masks on numpy and ``scipy.ndimage``'s distance transforms, and
:class:`SegmentationMetrics`, their per-class means over [classes, ...]
masks (the background left out by default; a class absent from one side
only scores the image diagonal as its HD95).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import ndimage

__all__ = [
    "binary_dice",
    "binary_iou",
    "precision_recall_f1",
    "hausdorff_distance_95",
    "SegmentationMetrics",
]


def binary_dice(target: np.ndarray, pred: np.ndarray, smooth: float = 1e-5) -> float:
    t = target.astype(bool)
    p = pred.astype(bool)
    inter = np.logical_and(t, p).sum()
    return float((2 * inter + smooth) / (t.sum() + p.sum() + smooth))


def binary_iou(target: np.ndarray, pred: np.ndarray, smooth: float = 1e-5) -> float:
    t = target.astype(bool)
    p = pred.astype(bool)
    inter = np.logical_and(t, p).sum()
    union = np.logical_or(t, p).sum()
    return float((inter + smooth) / (union + smooth))


def precision_recall_f1(target: np.ndarray, pred: np.ndarray, smooth: float = 1e-5):
    t = target.astype(bool)
    p = pred.astype(bool)
    tp = np.logical_and(t, p).sum()
    precision = (tp + smooth) / (p.sum() + smooth)
    recall = (tp + smooth) / (t.sum() + smooth)
    # precision/recall are already smoothed (never both 0): a smoothed
    # denominator would bias F1 below the true harmonic mean
    f1 = 2 * precision * recall / (precision + recall)
    return float(precision), float(recall), float(f1)


def _surface_distances(target: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Distances from pred surface voxels to the target surface."""
    t = target.astype(bool)
    p = pred.astype(bool)
    if not t.any() or not p.any():
        return np.array([np.inf])
    struct = ndimage.generate_binary_structure(t.ndim, 1)
    t_border = t ^ ndimage.binary_erosion(t, struct)
    p_border = p ^ ndimage.binary_erosion(p, struct)
    if not t_border.any() or not p_border.any():
        return np.array([0.0])
    dt = ndimage.distance_transform_edt(~t_border)
    return dt[p_border]


def hausdorff_distance_95(target: np.ndarray, pred: np.ndarray) -> float:
    """Symmetric 95th-percentile Hausdorff distance."""
    d1 = _surface_distances(target, pred)
    d2 = _surface_distances(pred, target)
    both = np.concatenate([d1, d2])
    if np.isinf(both).any():
        return float("inf")
    return float(np.percentile(both, 95))


class SegmentationMetrics:
    """Per-class averaged metrics over [classes, ...] binary masks."""

    def __init__(self, include_background: bool = False):
        self.include_background = include_background

    def __call__(self, target: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
        start = 0 if self.include_background else 1
        start = min(start, target.shape[0] - 1)
        dices, ious, f1s, hd95s = [], [], [], []
        for c in range(start, target.shape[0]):
            dices.append(binary_dice(target[c], pred[c]))
            ious.append(binary_iou(target[c], pred[c]))
            f1s.append(precision_recall_f1(target[c], pred[c])[2])
            t_any, p_any = np.any(target[c]), np.any(pred[c])
            if not t_any and not p_any:
                continue  # class absent in both: no HD95 contribution
            if t_any and p_any:
                hd95s.append(hausdorff_distance_95(target[c], pred[c]))
            else:
                # one side empty: worst case — the image diagonal (silently
                # dropping the class rewarded models for missing it entirely)
                hd95s.append(float(np.sqrt(sum(d**2 for d in target[c].shape))))
        return {
            "DICE": float(np.mean(dices)) if dices else 0.0,
            "IOU": float(np.mean(ious)) if ious else 0.0,
            "F1": float(np.mean(f1s)) if f1s else 0.0,
            "HD95": float(np.mean(hd95s)) if hd95s else float("inf"),
        }
