from mridc_tpu_torch.models.recon.cirim import CIRIM
from mridc_tpu_torch.models.recon.vn import VarNet

__all__ = ["CIRIM", "VarNet"]
