from mridc_tpu_torch.models.recon.ccnn import CascadeNet
from mridc_tpu_torch.models.recon.cirim import CIRIM
from mridc_tpu_torch.models.recon.crnn import CRNNet
from mridc_tpu_torch.models.recon.cs import CS, PICS
from mridc_tpu_torch.models.recon.dunet import DUNet
from mridc_tpu_torch.models.recon.jointicnet import JointICNet
from mridc_tpu_torch.models.recon.kikinet import KIKINet
from mridc_tpu_torch.models.recon.lpd import LPDNet
from mridc_tpu_torch.models.recon.multidomainnet import MultiDomainNet
from mridc_tpu_torch.models.recon.resnet import ProximalGradient, ResNet
from mridc_tpu_torch.models.recon.rvn import RecurrentVarNet
from mridc_tpu_torch.models.recon.unet import UNet
from mridc_tpu_torch.models.recon.vn import VarNet
from mridc_tpu_torch.models.recon.vsnet import VSNet
from mridc_tpu_torch.models.recon.xpdnet import XPDNet
from mridc_tpu_torch.models.recon.zf import ZF

__all__ = ["CIRIM", "CRNNet", "CS", "CascadeNet", "DUNet", "JointICNet", "KIKINet", "LPDNet", "MultiDomainNet", "PICS",
           "ProximalGradient", "RecurrentVarNet", "ResNet", "UNet", "VSNet", "VarNet", "XPDNet", "ZF"]
