"""Packaging (reference: setup.py + setup.cfg; console entry point added —
the reference exposes its CLI via `python -m` only)."""

from setuptools import find_packages, setup

setup(
    name="mridc_tpu",
    version="0.1.0",
    description="TPU-native AI MRI analysis: reconstruction, quantitative mapping, segmentation, multitask",
    packages=find_packages(include=["mridc_tpu", "mridc_tpu.*", "mridc_tpu_torch", "mridc_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"mridc_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "scipy",
        "h5py",
        "pyyaml",
        "einops",
    ],
    extras_require={"torch": ["torch", "numpy"]},
    entry_points={"console_scripts": ["mridc_tpu=mridc_tpu.cli:main"]},
)
