"""k1_roofline.serve: Percent of its roofline K1 (``csrc/psf1d_dc.cu``) reaches: the summed bound of its launches
over their summed device time."""

from mribench.devtrace import roofline


def read(ctx):
    return roofline(ctx, ("k1_fwd", "k1_bwd"))
