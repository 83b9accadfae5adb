"""idle_share.serve: Percent of the profiled calls' wall time in which no operation ran on the device."""

from mribench.devtrace import idle_share


def read(ctx):
    return idle_share(ctx)
