"""Host-side evaluation metrics (:mod:`.reconstruction`: SSIM at skimage
parity, PSNR, NMSE; :mod:`.segmentation`: Dice, IoU, F1, HD95)."""
