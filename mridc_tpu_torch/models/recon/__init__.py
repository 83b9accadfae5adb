from mridc_tpu_torch.models.recon.cirim import CIRIM

__all__ = ["CIRIM"]
