from mridc_tpu_torch.losses.ssim import ssim_loss

__all__ = ["ssim_loss"]
