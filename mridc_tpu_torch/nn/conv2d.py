"""The conv cascade of CascadeNet, CRNNet and VSNet, and of the primal-dual
models' CONV option (counterpart of ``mridc_tpu/nn/conv2d.py``): 3x3
zero-SAME convs with the hidden width on every conv but the last, optional
BatchNorm after every conv (the last included), a learned one-alpha PReLU
between convs.

Takes and returns NHWC ``[B, H, W, C]``; the convs run on its NCHW view in
``torch.channels_last`` memory. Module names: ``convs.{j}``, ``bns.{j}``,
``prelus.{j}`` (flax's ``Conv_{j}``, ``TorchBatchNorm_{j}``, ``prelu_{j}``).
The JAX package's ``lane_fold`` is a TPU layout that leaves the numbers as
they are; the key is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mridc_tpu_torch.nn.layers import BatchNorm, Conv, as_torch_dtype, prelu

__all__ = ["Conv2dCascade"]


class Conv2dCascade(nn.Module):
    """``n_convs`` 3x3 convs ``in_channels -> hidden -> ... -> out_channels``.
    ``batchnorm``: torch-semantics BatchNorm (eps 1e-4, momentum 0.1) after
    each conv, frozen or, with ``live_bn``, tracking running statistics.
    ``dtype`` is the convs' compute dtype; the output is float32."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2, hidden_channels: int = 64, n_convs: int = 3,
                 batchnorm: bool = False, live_bn: bool = False, dtype=None, lane_fold: str = "auto"):
        super().__init__()
        del lane_fold
        self.dtype = as_torch_dtype(dtype)
        widths = [in_channels] + [hidden_channels] * (n_convs - 1) + [out_channels]
        self.convs = nn.ModuleList([Conv(widths[j], widths[j + 1], 3, dtype=dtype) for j in range(n_convs)])
        self.bns = nn.ModuleList([BatchNorm(widths[j + 1], 1e-4, 0.1, live_bn) for j in range(n_convs)]
                                 if batchnorm else [])
        self.prelus = nn.ParameterList([nn.Parameter(torch.full((1,), 0.25)) for _ in range(n_convs - 1)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's draw order: each conv's kernel in turn (the biases, BatchNorm
        entries and alphas are constants)."""
        for j, conv in enumerate(self.convs):
            conv.reset_parameters(generator)
            if self.bns:
                self.bns[j].reset_parameters()
        for a in self.prelus:
            nn.init.constant_(a, 0.25)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (channels_last)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for j, conv in enumerate(self.convs):
            x = conv(x)
            if self.bns:
                x = self.bns[j](x, train)
            if j < len(self.prelus):
                x = prelu(x, self.prelus[j])
        return x.float().permute(0, 2, 3, 1).contiguous()
