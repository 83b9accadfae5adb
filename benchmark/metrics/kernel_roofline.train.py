"""kernel_roofline.train: Percent of their roofline the hand kernels of ``csrc/*.cu`` reach together: the summed bound
of every launch over their summed device time."""

from mribench.devtrace import roofline


def read(ctx):
    return roofline(ctx, ctx["bounds"])
