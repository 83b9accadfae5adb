"""Pretrained models (counterpart of ``mridc_tpu/models/pretrained.py``;
reference: mridc/core/classes/common.py:568-650 ``PretrainedModelInfo``,
``list_available_models``, ``get_available_model_names``,
``from_pretrained``).

A registered name, a URL or a local path resolves to a ``.mridc`` archive,
of the reference torch format or the JAX package's, which
``train/checkpoints.py:restore_model`` builds and loads. URLs are cached as
``utils/cloud.py`` keeps them, where the JAX package finds them too.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from mridc_tpu_torch.train.checkpoints import restore_model
from mridc_tpu_torch.utils.cloud import maybe_download_from_cloud
from mridc_tpu_torch.utils.logging import get_logger

logger = get_logger()

__all__ = ["PretrainedModelInfo", "register_pretrained_model", "list_available_models", "get_available_model_names",
           "from_pretrained", "from_pretrained_variables", "resolve_pretrained"]


@dataclass(frozen=True)
class PretrainedModelInfo:
    pretrained_model_name: str
    description: str
    location: str  # URL or local path of a .mridc archive
    aliases: Optional[tuple] = None

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(\n"
            f"\tpretrained_model_name={self.pretrained_model_name},\n"
            f"\tdescription={self.description},\n"
            f"\tlocation={self.location}\n)"
        )


_PRETRAINED: Dict[str, PretrainedModelInfo] = {}


def register_pretrained_model(info: PretrainedModelInfo) -> PretrainedModelInfo:
    """Register ``info`` under its name and aliases; the first registration of
    a name wins (the reference instantiates whatever is listed first)."""
    for name in (info.pretrained_model_name, *(info.aliases or ())):
        _PRETRAINED.setdefault(name, info)
    return info


def list_available_models() -> List[PretrainedModelInfo]:
    seen, out = set(), []
    for info in _PRETRAINED.values():
        if id(info) not in seen:
            seen.add(id(info))
            out.append(info)
    return out


def get_available_model_names() -> List[str]:
    return [m.pretrained_model_name for m in list_available_models()]


def resolve_pretrained(model_name_or_path: str, refresh_cache: bool = False) -> Path:
    """The local archive of a registered name, a URL (cached) or a path."""
    location = model_name_or_path
    if model_name_or_path in _PRETRAINED:
        location = _PRETRAINED[model_name_or_path].location
    if str(location).startswith(("http://", "https://")):
        filename = str(location).rsplit("/", 1)[-1]
        location = maybe_download_from_cloud(str(location), filename, refresh_cache=refresh_cache)
    path = Path(location)
    if not path.exists():
        raise FileNotFoundError(
            f"{model_name_or_path!r} is neither a registered pretrained model "
            f"({get_available_model_names() or 'none registered'}), a URL, nor an existing archive path"
        )
    return path


def from_pretrained(model_name_or_path: str, refresh_cache: bool = False, override_config: Optional[Dict] = None,
                    device=None):
    """``(model, state_dict, cfg)`` from a registered pretrained name, a URL
    or a local ``.mridc`` archive path: the model built from the archive's
    config (updated by ``override_config``) on ``device`` (the card unless
    the caller names another) with the archive's weights."""
    path = resolve_pretrained(model_name_or_path, refresh_cache)
    logger.info(f"Restoring pretrained model from {path}")
    return restore_model(path, override_config=override_config, device=device)


def from_pretrained_variables(model_name_or_path: str, refresh_cache: bool = False,
                              override_config: Optional[Dict] = None, device=None):
    """As :func:`from_pretrained`: the state dict holds every variable of the
    archive, a live BatchNorm's running statistics among them (the JAX
    package's ``batch_stats`` collection)."""
    return from_pretrained(model_name_or_path, refresh_cache, override_config, device)
