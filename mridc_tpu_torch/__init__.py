"""mridc_tpu_torch — the PyTorch/CUDA port of mridc_tpu for NVIDIA Hopper.

Mirrors ``mridc_tpu``'s module paths and tensor contract (real views
``[..., 2]``); imports torch and numpy only. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
