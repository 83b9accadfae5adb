"""dc_ms.serve: Device ms a slice of the data consistency: K1 and K2 (forward, backward, maps gradient) and cuFFT."""

from mribench.devtrace import DC_LAYERS, per_slice_ms


def read(ctx):
    return per_slice_ms(ctx, DC_LAYERS)
