"""mfu.serve: Percent of the card's peak for the cell's compute dtype that the model's operations a slice
(a training step: three times the forward's) at the run's window rate reach."""

from mribench.devtrace import mfu


def read(ctx):
    return mfu(ctx)
