"""Framework exceptions (counterpart of ``mridc_tpu/utils/exceptions.py``).

Parity: reference ``mridc/utils/exceptions.py`` (``MRIDCBaseException``;
its ``LightningNotInstalledException`` has no meaning here).
"""

from __future__ import annotations

__all__ = ["MRIDCBaseException", "CheckpointCompatibilityError"]


class MRIDCBaseException(Exception):
    """Base class for every exception raised by mridc_tpu_torch."""


class CheckpointCompatibilityError(MRIDCBaseException):
    """Raised when a checkpoint/archive cannot be restored into the current
    model (shape mismatch, missing keys, incompatible config)."""
