"""``use_sens_net``: estimate the coil sensitivities before reconstruction
(counterpart of ``mridc_tpu/models/sens_wrapper.py``).

As in the reference (``mridc/collections/reconstruction/nn/base.py:406``:
``if self.use_sens_net: sensitivity_maps = self.sens_net(kspace, mask)``),
the estimator is the attribute ``sens_net`` of the model it feeds: the
wrapped model is the built model itself, its class swapped for a subclass
whose forward first runs :class:`~mridc_tpu_torch.nn.sens.SensitivityModel`
on the masked k-space and passes its maps on in place of the dataset's. So
its state-dict keys are ``sens_net.*`` and the model's own keys unprefixed,
as the reference's are, and every attribute, method and ``isinstance`` check
of the model holds for it. A model with a ``sens_net`` of its own
(JointICNet) keeps it, and the wrapper's estimator is ``wrapper_sens_net``:
two estimators, as the JAX package's ``SensitivityModel_0`` beside
``model/SensitivityModel_0``. The JAX package's ``WithSensNet`` scopes the
wrapper's estimator ``SensitivityModel_0`` and the model ``model``;
``utils/params.py`` maps between them.

The maps' gradient runs through every DC Function the models call (K1's and
K2's maps-gradient kernels on the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from mridc_tpu_torch.models.base import drawn
from mridc_tpu_torch.nn.sens import SensitivityModel

__all__ = ["WithSensNet", "maybe_wrap_sens_net", "is_wrapped", "estimator"]


class WithSensNet:
    """Mixin of a wrapped model: the estimator, the attribute ``sens_attr``,
    estimates the maps from the masked k-space; the dataset's maps are
    ignored."""

    sens_attr = "sens_net"

    def forward(self, y, sens, mask, init_pred=None, train: bool = False):
        del sens  # estimated below
        est = getattr(self, self.sens_attr)(y, mask, train=train)
        return super().forward(y, est, mask, init_pred, train=train)


_SENS_UNSUPPORTED = {
    # models whose call contract is not (y, sens, mask, init_pred): quantitative
    # ((y, sens, sampling_mask, maps_init, tes) over 6D echo k-space) and
    # segmentation ((image,)), as in the JAX package
    "QCIRIM", "QRIM", "QVN", "QVARNET",
    "SEGMENTATIONUNET", "SEGMENTATION2DUNET", "SEGMENTATION3DUNET",
    "SEGMENTATIONATTENTIONUNET", "SEGMENTATIONLAMBDAUNET", "SEGMENTATIONVNET",
    "SEGMENTATIONDYNUNET", "SEGMENTATIONUNETR",
}

_CLASSES: Dict[Tuple[type, str], type] = {}


def _wrapped_class(cls: type, attr: str) -> type:
    if (cls, attr) not in _CLASSES:
        _CLASSES[cls, attr] = type(f"{cls.__name__}WithSensNet", (WithSensNet, cls),
                                   {"__module__": __name__, "sens_attr": attr,
                                    "__doc__": f"{cls.__name__} with learned sensitivity maps."})
    return _CLASSES[cls, attr]


def is_wrapped(model) -> bool:
    return isinstance(model, WithSensNet)


def estimator(model) -> SensitivityModel:
    """The wrapper's estimator of a wrapped model."""
    return getattr(model, model.sens_attr)


def maybe_wrap_sens_net(model, cfg: Dict[str, Any], model_name: str = "",
                        generator: Optional[torch.Generator] = None):
    """Wrap ``model`` when the config sets ``use_sens_net`` (the reference's
    keys ``sens_chans``, ``sens_pools``, ``sens_mask_type``, and
    ``sens_normalize``, ``sens_mask_center``, ``compute_dtype``); the
    estimator's weights are drawn from ``generator``."""
    if not cfg.get("use_sens_net", False):
        return model
    if str(model_name).upper() in _SENS_UNSUPPORTED:
        raise ValueError(
            f"use_sens_net is not supported for {model_name}: the sens-net wrapper "
            "assumes the reconstruction call contract (y, sens, mask, init_pred) "
            "over [B, C, H, W, 2] k-space"
        )
    sens_net = drawn(lambda: SensitivityModel(
        chans=cfg.get("sens_chans", 8),
        num_pools=cfg.get("sens_pools", 4),
        mask_type=cfg.get("sens_mask_type", "2D"),
        fft_centered=model.fft_centered,
        fft_normalization=model.fft_normalization,
        spatial_dims=model.spatial_dims,
        coil_dim=model.coil_dim,
        normalize=cfg.get("sens_normalize", True),
        mask_center=cfg.get("sens_mask_center", True),
        dtype=cfg.get("compute_dtype", None),
    ), generator)
    attr = "wrapper_sens_net" if isinstance(getattr(model, "sens_net", None), torch.nn.Module) else "sens_net"
    model.__class__ = _wrapped_class(type(model), attr)
    setattr(model, attr, sens_net.to(memory_format=torch.channels_last))
    return model
