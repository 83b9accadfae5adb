"""Cached download of pretrained model archives (counterpart of
``mridc_tpu/utils/cloud.py``; reference: mridc/utils/cloud.py:15
``maybe_download_from_cloud``).

The cache is the JAX package's: ``MRIDC_TPU_CACHE_DIR`` (default
``~/.cache/mridc_tpu``), each URL under the key ``sha256(url +
filename)[:16]``, so an archive cached by either package is found by both.
A download goes to a ``.part`` file first and is renamed when complete: an
interrupted download never leaves a file that a later call takes for a hit.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from pathlib import Path
from typing import Optional

from mridc_tpu_torch.utils.logging import get_logger

logger = get_logger()

__all__ = ["maybe_download_from_cloud", "resolve_cache_dir", "cache_path"]


def resolve_cache_dir() -> Path:
    override = os.environ.get("MRIDC_TPU_CACHE_DIR")
    if override:
        return Path(override)
    return Path.home() / ".cache" / "mridc_tpu"


def cache_path(url: str, filename: str, subfolder: Optional[str] = None) -> Path:
    """Where ``url``'s ``filename`` is cached (whether or not it is there)."""
    key = hashlib.sha256((url + filename).encode()).hexdigest()[:16]
    # the url's sha is always part of the path: two urls that share a
    # subfolder and a file name must not alias one cached file
    dest_dir = resolve_cache_dir() / subfolder / key if subfolder else resolve_cache_dir() / key
    return dest_dir / filename


def maybe_download_from_cloud(url: str, filename: str, subfolder: Optional[str] = None,
                              refresh_cache: bool = False) -> Path:
    """The cached file of ``url``'s ``filename``, downloaded first when it is
    not cached (or ``refresh_cache`` is set)."""
    dest = cache_path(url, filename, subfolder)
    if dest.exists() and not refresh_cache:
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    full = url.rstrip("/") + "/" + filename if not url.endswith(filename) else url
    logger.info(f"Downloading {full} -> {dest}")
    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        urllib.request.urlretrieve(full, tmp)  # noqa: S310
        os.replace(tmp, dest)
    finally:
        if tmp.exists():
            tmp.unlink()
    return dest
