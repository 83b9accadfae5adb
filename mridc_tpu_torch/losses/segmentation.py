"""Segmentation losses (counterpart of ``mridc_tpu/losses/segmentation.py``):
MONAI-style Dice and weighted cross-entropy, class axis last ([B, H, W, C]
or [B, D, H, W, C]).

``dice_loss`` returns (score, loss) like the reference's forward: sigmoid or
softmax activation, optional one-hot targets, ``squared_pred``, ``jaccard``,
``smooth_nr``/``smooth_dr``, reduced over the spatial axes (and the batch
with ``batch``), each class's loss averaged. ``cross_entropy_loss`` is the
mean CE of integer targets, with class ``weight``s (a weighted mean, its
denominator floored at 1e-12 by ``torch.maximum``, which splits the gradient
at a tie as JAX's ``maximum`` does) and ``label_smoothing``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["one_hot", "dice_loss", "Dice", "cross_entropy_loss", "CrossEntropyLoss"]


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels [...] -> float32 one-hot [..., C] (out-of-range labels
    give zero rows, as ``jax.nn.one_hot``)."""
    labels = labels.long()
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def dice_loss(target: torch.Tensor, pred: torch.Tensor, include_background: bool = True, to_onehot_y: bool = False,
              sigmoid: bool = True, softmax: bool = False, squared_pred: bool = False, jaccard: bool = False,
              smooth_nr: float = 1e-5, smooth_dr: float = 1e-5, batch: bool = True):
    """(dice score, dice loss), each the mean over the classes (and over the
    batch unless ``batch``); ``target``/``pred`` [B, ..., C]."""
    if sigmoid:
        pred = torch.sigmoid(pred)
    n_ch = pred.shape[-1]
    if softmax and n_ch > 1:
        pred = torch.softmax(pred, dim=-1)
    if to_onehot_y and n_ch > 1:
        target = one_hot(target.argmax(-1) if target.shape[-1] == n_ch else target[..., 0], n_ch)
    if not include_background and n_ch > 1:
        target = target[..., 1:]
        pred = pred[..., 1:]
    spatial = tuple(range(1, target.ndim - 1))
    axes = ((0,) + spatial) if batch else spatial
    intersection = (target * pred).sum(dim=axes)
    ground = (target**2 if squared_pred else target).sum(dim=axes)
    prediction = (pred**2 if squared_pred else pred).sum(dim=axes)
    denom = ground + prediction
    if jaccard:
        denom = 2.0 * (denom - intersection)
    score = (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return score.mean(), (1.0 - score).mean()


class Dice:
    """:func:`dice_loss` with the reference constructor's arguments."""

    def __init__(self, include_background: bool = True, to_onehot_y: bool = False, sigmoid: bool = True,
                 softmax: bool = False, other_act=None, squared_pred: bool = False, jaccard: bool = False,
                 flatten: bool = False, reduction: str = "mean", smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 batch: bool = True):
        del other_act, flatten, reduction
        self.kw = dict(include_background=include_background, to_onehot_y=to_onehot_y, sigmoid=sigmoid,
                       softmax=softmax, squared_pred=squared_pred, jaccard=jaccard, smooth_nr=smooth_nr,
                       smooth_dr=smooth_dr, batch=batch)

    def __call__(self, target, pred):
        return dice_loss(target, pred, **self.kw)


def cross_entropy_loss(target_labels: torch.Tensor, logits: torch.Tensor, weight: Optional[Sequence[float]] = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean (class-weighted) CE of [B, ..., C] logits against integer targets
    [B, ...], with label smoothing."""
    n_classes = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    tgt = one_hot(target_labels, n_classes)
    if label_smoothing:
        tgt = tgt * (1 - label_smoothing) + label_smoothing / n_classes
    ce = -(tgt * logp).sum(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
        pix_w = (tgt * w).sum(-1)
        total = pix_w.sum()
        return (ce * pix_w).sum() / torch.maximum(total, torch.full((), 1e-12, device=total.device))
    return ce.mean()


class CrossEntropyLoss:
    """:func:`cross_entropy_loss` with the reference constructor's arguments
    (its MC sampling reduces to one evaluation of a deterministic net)."""

    def __init__(self, num_samples: int = 50, ignore_index: int = -100, reduction: str = "none",
                 label_smoothing: float = 0.0, weight=None):
        del num_samples, ignore_index, reduction
        self.label_smoothing = label_smoothing
        self.weight = weight

    def __call__(self, target_labels, logits):
        return cross_entropy_loss(target_labels, logits, self.weight, self.label_smoothing)
