from mridc_tpu_torch.models.registry import MODEL_REGISTRY, PENDING_MODELS, available_models, build_model

__all__ = ["MODEL_REGISTRY", "PENDING_MODELS", "available_models", "build_model"]
