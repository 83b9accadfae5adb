"""Named timers with device synchronization (counterpart of
``mridc_tpu/utils/timers.py``; reference: mridc/utils/timers.py:14
``NamedTimer``): named start/stop accumulators with an optional sliding
buffer. With ``sync_device`` a start and a stop first wait for the card's
queued work (``torch.cuda.synchronize``), so that a timer measures the work
and not its launch; without a card they do not wait.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import torch

__all__ = ["NamedTimer"]


class NamedTimer:
    def __init__(self, reduction: str = "mean", sync_device: bool = False, buffer_size: int = -1):
        self.reduction = reduction
        self.sync_device = sync_device
        self.buffer_size = buffer_size
        self.reset()

    def reset(self, name: Optional[str] = None):
        if name is None:
            self.timers: Dict[str, Dict] = {}
        else:
            self.timers.pop(name, None)

    def _maybe_sync(self, probe=None):
        """Wait for the card: ``probe``'s device (a tensor), else the current
        one."""
        if self.sync_device and torch.cuda.is_available():
            device = probe.device if isinstance(probe, torch.Tensor) and probe.device.type == "cuda" else None
            torch.cuda.synchronize(device)

    def start(self, name: str = ""):
        timer = self.timers.get(name, {})
        if "start" in timer:
            raise RuntimeError(f"Timer = {name} was started twice without stop")
        self._maybe_sync()
        timer["start"] = time.perf_counter()
        self.timers[name] = timer

    def stop(self, name: str = "", probe=None):
        timer = self.timers.get(name)
        if timer is None or "start" not in timer:
            raise RuntimeError(f"Timer = {name} was stopped before start")
        self._maybe_sync(probe)
        dt = time.perf_counter() - timer.pop("start")
        if self.buffer_size > 0:
            timer.setdefault("buffer", deque(maxlen=self.buffer_size)).append(dt)
        else:
            timer["total"] = timer.get("total", 0.0) + dt
            timer["count"] = timer.get("count", 0) + 1
            timer["max"] = max(timer.get("max", dt), dt)
            timer["min"] = min(timer.get("min", dt), dt)

    def get(self, name: str = "") -> float:
        timer = self.timers.get(name, {})
        if self.buffer_size > 0:
            vals = list(timer.get("buffer", []))
            if not vals:
                return 0.0
        else:
            if not timer.get("count"):
                return 0.0
            if self.reduction == "sum":
                return timer["total"]
            if self.reduction == "max":
                return timer["max"]
            if self.reduction == "min":
                return timer["min"]
            return timer["total"] / timer["count"]
        if self.reduction == "sum":
            return sum(vals)
        if self.reduction == "max":
            return max(vals)
        if self.reduction == "min":
            return min(vals)
        return sum(vals) / len(vals)

    @property
    def active_timers(self):
        return [k for k, v in self.timers.items() if "start" in v]

    def export(self) -> Dict[str, float]:
        return {k: self.get(k) for k in self.timers}
