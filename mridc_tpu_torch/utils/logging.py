"""Process-rank-aware logging (counterpart of ``mridc_tpu/utils/logging.py``):
a stdlib logger whose records carry the process rank, and one log file per
process.

The rank is ``torch.distributed``'s once a process group is initialised, else
the standard cluster env vars; the prefix is evaluated per record, so loggers
created before the group exists show the right rank once it does.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Dict, Optional

__all__ = ["get_logger", "add_file_handler", "is_global_rank_zero"]

_LOGGERS: Dict[str, logging.Logger] = {}
_FILE_HANDLERS: Dict[str, logging.Handler] = {}


def _rank() -> int:
    """The process rank: ``torch.distributed``'s when a group is initialised,
    else the first of ``RANK``, ``SLURM_PROCID`` and ``LOCAL_RANK`` set, else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except ImportError:
        pass
    for var in ("RANK", "SLURM_PROCID", "LOCAL_RANK"):
        val = os.environ.get(var)
        if val is not None:
            try:
                return int(val)
            except ValueError:
                continue
    return 0


def is_global_rank_zero() -> bool:
    return _rank() == 0


class _RankFilter(logging.Filter):
    """Puts the current rank into every record, so that loggers created early
    do not keep rank 0."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _rank()
        return True


def get_logger(name: str = "mridc_tpu") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        fmt = "[%(name)s rank%(rank)s] %(asctime)s %(levelname)s: %(message)s"
        handler.setFormatter(logging.Formatter(fmt, datefmt="%H:%M:%S"))
        handler.addFilter(_RankFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


def add_file_handler(log_dir, filename: Optional[str] = None):
    """A per-process log file ``mridc_tpu_log_globalrank-N.txt`` in ``log_dir``
    (the JAX package's name and layout). One live file handler per process: a
    new run dir (a resumed run, a second experiment manager) closes and
    replaces the previous handler instead of adding appenders."""
    logger = get_logger()
    filename = filename or f"mridc_tpu_log_globalrank-{_rank()}.txt"
    path = Path(log_dir) / filename
    path.parent.mkdir(parents=True, exist_ok=True)
    for key in list(_FILE_HANDLERS):
        prev = _FILE_HANDLERS.pop(key)
        logger.removeHandler(prev)
        prev.close()
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
    logger.addHandler(handler)
    _FILE_HANDLERS[str(path)] = handler
    return path
