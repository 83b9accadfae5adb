"""Hand-written Hopper kernels of the port and their wrappers.

K1 ``psf1d_dc`` (psf1d DC), K2 ``full_dc``/``sens_expand``/``sens_reduce``
(full-mask DC, SENSE expansion and reduction: stages ``expand``, ``residual``,
``load`` and ``reduce`` around cuFFT, and the backward's ``mask`` and
``reduce_acc``, in :mod:`.k2_full_dc`), K3 ``indrnn`` (IndRNN cell), K4 ``edge_pad`` and
``bias_act`` (the edge pad and the bias-and-activation epilogue around each
``ConvNonlinear`` conv, in :mod:`.k4_conv_epilogue`). Each wrapper is a
``torch.autograd.Function`` that takes its plain PyTorch versions (forward and
backward) for CPU tensors and launches its CUDA kernels for CUDA tensors;
:data:`LAUNCHES` counts the kernel launches per entry point.
"""

from mridc_tpu_torch.kernels.binding import LAUNCHES, build, reset_launch_counts
from mridc_tpu_torch.kernels.k2_full_dc import (full_dc, full_dc_plain, sens_expand, sens_expand_plain, sens_reduce,
                                                sens_reduce_plain)
from mridc_tpu_torch.kernels.k3_indrnn import indrnn, indrnn_plain
from mridc_tpu_torch.kernels.k1_psf1d_dc import psf1d_dc, psf1d_dc_plain
from mridc_tpu_torch.kernels.k4_conv_epilogue import bias_act, bias_act_plain, edge_pad, edge_pad_plain

__all__ = [
    "LAUNCHES", "build", "reset_launch_counts", "launch_counts",
    "psf1d_dc", "psf1d_dc_plain", "full_dc", "full_dc_plain", "sens_expand", "sens_expand_plain",
    "sens_reduce", "sens_reduce_plain",
    "indrnn", "indrnn_plain", "edge_pad", "edge_pad_plain", "bias_act", "bias_act_plain",
]


def launch_counts() -> dict:
    """Snapshot of the launch counters, {entry point: launches}."""
    return dict(LAUNCHES)
