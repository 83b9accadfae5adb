from mridc_tpu_torch.models.multitask.blocks import KSpaceDC, UnetDecoder, UnetEncoder
from mridc_tpu_torch.models.multitask.models import IDSLR, MTLRS, SERANet, IDSLRUNet, RecSegUNet, SegNet

__all__ = ["KSpaceDC", "UnetDecoder", "UnetEncoder", "IDSLR", "IDSLRUNet", "MTLRS", "RecSegUNet", "SERANet", "SegNet"]
