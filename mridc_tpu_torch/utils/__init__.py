from mridc_tpu_torch.utils.typecheck import ShapeError, check_rv, resolve_device

__all__ = ["ShapeError", "check_rv", "resolve_device"]
