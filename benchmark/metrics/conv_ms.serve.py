"""conv_ms.serve: Device ms a slice of cuDNN's and cuBLAS's convolution and GEMM kernels: the conv stack."""

from mribench.devtrace import per_slice_ms


def read(ctx):
    return per_slice_ms(ctx, ("conv and GEMM (cuDNN, cuBLAS)",))
