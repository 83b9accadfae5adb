from mridc_tpu_torch.models.recon.cirim import CIRIM
from mridc_tpu_torch.models.recon.resnet import ProximalGradient, ResNet
from mridc_tpu_torch.models.recon.unet import UNet
from mridc_tpu_torch.models.recon.vn import VarNet
from mridc_tpu_torch.models.recon.zf import ZF

__all__ = ["CIRIM", "ProximalGradient", "ResNet", "UNet", "VarNet", "ZF"]
