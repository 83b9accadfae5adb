"""API-lifecycle decorators (counterpart of ``mridc_tpu/utils/decorators.py``).

Parity: reference ``mridc/utils/decorators/deprecated.py`` (``deprecated`` — logs
once per wrapped callable, optional version/explanation) and
``mridc/utils/decorators/experimental.py`` (``experimental`` — warns the class is
not ready for production).
"""

from __future__ import annotations

import functools
from typing import Optional

from mridc_tpu_torch.utils.logging import get_logger

__all__ = ["deprecated", "experimental"]

_DEPRECATION_WARNED: set = set()


def deprecated(wrapped=None, version: Optional[str] = None, explanation: Optional[str] = None):
    """Mark a function/method deprecated; logs a warning on first call only."""
    if wrapped is None:
        return functools.partial(deprecated, version=version, explanation=explanation)

    @functools.wraps(wrapped)
    def wrapper(*args, **kwargs):
        name = getattr(wrapped, "__qualname__", wrapped.__name__)
        if name not in _DEPRECATION_WARNED:
            msg = f"Function/method {name} is deprecated."
            if version:
                msg += f" It will be removed in version {version}."
            if explanation:
                msg += f" {explanation}"
            get_logger().warning(msg)
            _DEPRECATION_WARNED.add(name)
        return wrapped(*args, **kwargs)

    return wrapper


def experimental(cls):
    """Mark a class experimental; logs a warning when it is instantiated."""
    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def init(self, *args, **kwargs):
        get_logger().warning(f"`{cls.__name__}` is experimental and not ready for production.")
        orig_init(self, *args, **kwargs)

    cls.__init__ = init
    return cls
