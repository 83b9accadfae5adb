"""Weighted loss aggregation (counterpart of ``mridc_tpu/losses/aggregator.py``;
reference: mridc/collections/common/losses/aggregator.py:19 ``AggregatorLoss``,
N losses summed with optional per-loss coefficients).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["AggregatorLoss"]


class AggregatorLoss:
    """Sums several scalar losses into one, with optional weights:
    ``AggregatorLoss(weights=[0.5, 1.0])(l1_loss, ssim_loss)``; the sum runs
    in the inputs' order from a zero of the first one's shape."""

    def __init__(self, num_inputs: int = 2, weights: Optional[Sequence[float]] = None):
        if weights is not None and len(weights) != num_inputs:
            raise ValueError("Length of weights should be equal to the number of inputs (num_inputs)")
        self.num_inputs = num_inputs
        self.weights = None if weights is None else [float(w) for w in weights]

    def __call__(self, *losses):
        if len(losses) != self.num_inputs:
            raise ValueError(f"Expected {self.num_inputs} losses, got {len(losses)}")
        total = torch.zeros_like(torch.as_tensor(losses[0]))
        for i, value in enumerate(losses):
            w = 1.0 if self.weights is None else self.weights[i]
            total = total + w * torch.as_tensor(value)
        return total
