"""elementwise_ms.serve: Device ms a slice of ATen's elementwise kernels (pads, casts, adds, copies): what the conv
stack leaves unfused."""

from mribench.devtrace import per_slice_ms


def read(ctx):
    return per_slice_ms(ctx, ("elementwise (ATen)",))
