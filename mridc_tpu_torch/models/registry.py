"""Model registry (counterpart of ``mridc_tpu/models/registry.py``):
name -> constructor for every name of the JAX registry (``PENDING_MODELS``,
the names not ported yet with the ROADMAP item that ports them, is empty).
``use_sens_net: true`` wraps a model with a learned sensitivity estimator
(``models/sens_wrapper.py``) where the JAX package wraps it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from mridc_tpu_torch.models.recon import (CIRIM, CS, PICS, ZF, CascadeNet, CRNNet, DUNet, JointICNet, KIKINet,
                                          LPDNet, MultiDomainNet, ProximalGradient, RecurrentVarNet, ResNet, UNet,
                                          VarNet, VSNet, XPDNet)
from mridc_tpu_torch.models.sens_wrapper import maybe_wrap_sens_net
from mridc_tpu_torch.models.multitask import IDSLR, MTLRS, SERANet, IDSLRUNet, RecSegUNet, SegNet
from mridc_tpu_torch.models.quantitative import qCIRIM, qVarNet
from mridc_tpu_torch.models.segmentation import (Segmentation3DUNet, SegmentationAttentionUNet, SegmentationDYNUNet,
                                                 SegmentationLambdaUNet, SegmentationUNet, SegmentationUNetR,
                                                 SegmentationVNet)
from mridc_tpu_torch.utils.typecheck import resolve_device

__all__ = ["MODEL_REGISTRY", "PENDING_MODELS", "build_model", "available_models"]

MODEL_REGISTRY: Dict[str, Callable] = {
    "ZF": ZF.from_config, "UNET": UNet.from_config,
    "CIRIM": CIRIM.from_config, "RIM": CIRIM.from_config,
    "VN": VarNet.from_config, "VARNET": VarNet.from_config, "E2EVN": VarNet.from_config,
    "PROXIMALGRADIENT": ProximalGradient.from_config, "PG": ProximalGradient.from_config,
    "RESNET": ResNet.from_config,
    "CASCADENET": CascadeNet.from_config, "CCNN": CascadeNet.from_config,
    "CRNNET": CRNNet.from_config, "CRNN": CRNNet.from_config,
    "XPDNET": XPDNet.from_config, "KIKINET": KIKINet.from_config,
    "LPDNET": LPDNet.from_config, "LPD": LPDNet.from_config,
    "VSNET": VSNet.from_config, "DUNET": DUNet.from_config,
    "RVN": RecurrentVarNet.from_config, "RECURRENTVARNET": RecurrentVarNet.from_config,
    "MULTIDOMAINNET": MultiDomainNet.from_config, "MULTIDOMAIN": MultiDomainNet.from_config,
    "CS": CS.from_config, "PICS": PICS.from_config, "JOINTICNET": JointICNet.from_config,
    "QCIRIM": qCIRIM.from_config, "QRIM": qCIRIM.from_config,
    "QVN": qVarNet.from_config, "QVARNET": qVarNet.from_config,
    "SEGMENTATIONUNET": SegmentationUNet.from_config, "SEGMENTATION2DUNET": SegmentationUNet.from_config,
    "SEGMENTATION3DUNET": Segmentation3DUNet.from_config,
    "SEGMENTATIONATTENTIONUNET": SegmentationAttentionUNet.from_config,
    "SEGMENTATIONLAMBDAUNET": SegmentationLambdaUNet.from_config, "SEGMENTATIONVNET": SegmentationVNet.from_config,
    "SEGMENTATIONDYNUNET": SegmentationDYNUNet.from_config, "SEGMENTATIONUNETR": SegmentationUNetR.from_config,
    "MTLRS": MTLRS.from_config, "JRSCIRIM": MTLRS.from_config, "IDSLR": IDSLR.from_config,
    "IDSLRUNET": IDSLRUNet.from_config, "SEGNET": SegNet.from_config, "RECSEGNET": RecSegUNet.from_config,
    "RECSEGUNET": RecSegUNet.from_config, "SERANET": SERANet.from_config,
}

PENDING_MODELS: Dict[str, str] = {}


# Perf knobs with model-specific support, as in the JAX package: a knob key in
# the config of a model outside its support set is a user error.
_TPU_KNOB_SUPPORT = {
    "scan_iterations": {"XPDNET", "KIKINET", "LPDNET", "LPD"},
    "dc_mode": {"CIRIM", "RIM", "MTLRS", "JRSCIRIM", "VN", "E2EVN", "VARNET"},
    "dc_dtype": {"VN", "E2EVN", "VARNET"},
    "remat_mode": {"CIRIM", "RIM", "QCIRIM"},
    "remat_save_dc": {"CIRIM", "RIM"},
    "lane_fold": {"CIRIM", "RIM", "MTLRS", "JRSCIRIM"},
    "train_dc_dtype": {"CIRIM", "RIM", "MTLRS", "JRSCIRIM"},
    "infer_dc_dtype": {"CIRIM", "RIM", "MTLRS", "JRSCIRIM"},
    "train_eta_dtype": {"CIRIM", "RIM"},
    "scan_unroll": {"CIRIM", "RIM"},
    "train_pointwise_matmul": {"CIRIM", "RIM"},
    "stack_intermediates": {"CIRIM", "RIM"},
    "train_batch_stats": {
        "CASCADENET", "CCNN", "KIKINET", "LPDNET", "LPD", "XPDNET", "VSNET",
        "SEGMENTATIONVNET", "SEGMENTATIONLAMBDAUNET",
        "MTLRS", "JRSCIRIM",
    },
}


def _check_knob_support(name: str, cfg: Dict[str, Any]) -> None:
    for key, supported in _TPU_KNOB_SUPPORT.items():
        if key in cfg and cfg[key] is not None and name not in supported:
            raise ValueError(
                f"{key!r} is not supported by model {name!r} (supported: "
                f"{sorted(supported)}); remove it from the model config"
            )


def build_model(cfg: Dict[str, Any], device=None, generator: Optional[torch.Generator] = None):
    """Build a model from a config dict with a ``model_name`` key, on ``device``:
    the CUDA device when None (raising if there is none), the CPU only when the
    caller asks for it. Weights are drawn from ``generator`` (CPU generator);
    ``use_sens_net: true`` wraps the model with a learned sensitivity
    estimator."""
    name = str(cfg.get("model_name", "")).upper()
    if name in PENDING_MODELS and name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported to mridc_tpu_torch yet: ROADMAP {PENDING_MODELS[name]}"
        )
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model_name {name!r}. Available: {sorted(MODEL_REGISTRY)}")
    _check_knob_support(name, cfg)
    dev = resolve_device(device)
    model = MODEL_REGISTRY[name](cfg, generator=generator)
    return maybe_wrap_sens_net(model, cfg, model_name=name, generator=generator).to(dev)


def available_models():
    """Names that build in this package (the rest: :data:`PENDING_MODELS`)."""
    return sorted(MODEL_REGISTRY)
