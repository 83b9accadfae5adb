"""Recurrent Variational Network (counterpart of
``mridc_tpu/models/recon/rvn.py``): k-space refinement steps, each a learned-
rate gradient DC plus a multi-layer convolutional GRU regulariser on the SENSE
image, whose hidden state starts from a dilated conv stack over the k-space of
the initial image.

Per step, in the caller's k-space order: ``k <- k - lr m (k - y) +
sens_expand(GRU(sens_reduce(k)))``; the SENSE reduction and expansion run on
K2's stages around cuFFT on the card (differentiable in k and the image), the
masked residual ``m (k - y)`` in PyTorch. The initial hidden state reads
``fft2(sens_reduce(y))`` (``sense``), ``fft2(init_pred)`` (``input_image``)
or the coil sum of ``fft2(ifft2(y))`` (``zero_filled``).

Layout: NCHW in ``torch.channels_last`` inside; the GRU's state is a list of
[B, hidden, H, W] tensors, one per layer (the JAX package's [B, H, W, hidden,
layers] stacked). ``compute_dtype``: the convolutions compute in it and the
state is carried in it; the DC and the FFTs stay float32, the regulariser's
output is cast back to float32.

Module names (the reference torch ones): ``initializer.conv_blocks.{i}``,
``initializer.out_blocks.{j}``, ``block_list.{i}.learning_rate``,
``block_list.{i}.regularizer.{conv_blocks,update_gates,reset_gates,out_gates}.{l}``
and ``.conv_out``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import sens_expand, sens_reduce
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.layers import Conv, as_torch_dtype, replicate_pad
from mridc_tpu_torch.ops.fft import fft2_rv, ifft2_rv

__all__ = ["Conv2dGRU", "RecurrentInit", "RecurrentVarNetBlock", "RecurrentVarNet"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> its NCHW view (channels_last strides when x is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


class Conv2dGRU(nn.Module):
    """Multi-layer convolutional GRU. Layer l: an edge-padded VALID conv (5x5
    at layer 0, 3x3 at dilation 2 at layer 1, 3x3 after) and ReLU, then the
    update, reset and candidate gates (``gru_kernel_size`` zero-SAME convs over
    ``[cell, prev]`` and ``[cell, prev * reset]``, flax's orthogonal init);
    the new state is ``prev (1 - update) + candidate update``, and the next
    layer reads its ReLU. An edge-padded 3x3 VALID conv maps the last layer to
    ``out_channels``."""

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, out_channels: int = 2, num_layers: int = 4,
                 gru_kernel_size: int = 1, dtype=None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.dtype = as_torch_dtype(dtype)
        self.pads = []
        self.conv_blocks = nn.ModuleList()
        for idx in range(num_layers):
            k, d = (5 if idx == 0 else 3), (2 if idx == 1 else 1)
            self.pads.append(d * (k - 1) // 2)
            self.conv_blocks.append(Conv(in_channels if idx == 0 else hidden_channels, hidden_channels, k, d, "VALID",
                                         dtype=dtype))

        def gates():
            return nn.ModuleList([Conv(2 * hidden_channels, hidden_channels, gru_kernel_size, dtype=dtype)
                                  for _ in range(num_layers)])

        self.update_gates, self.reset_gates, self.out_gates = gates(), gates(), gates()
        self.conv_out = Conv(hidden_channels, out_channels, 3, padding="VALID", dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults in its creation order (per layer the cell conv, the
        update, reset and candidate gates; then the output conv): lecun-normal
        kernels, orthogonal gate kernels, zero biases."""
        for idx in range(self.num_layers):
            self.conv_blocks[idx].reset_parameters(generator)
            for gate in (self.update_gates[idx], self.reset_gates[idx], self.out_gates[idx]):
                nn.init.orthogonal_(gate.weight, generator=generator)
                nn.init.zeros_(gate.bias)
        self.conv_out.reset_parameters(generator)

    def forward(self, x: torch.Tensor, state: Optional[List[torch.Tensor]]):
        """x NCHW [B, C, H, W]; state one [B, hidden, H, W] a layer, or None
        (zeros). Returns the output in x's dtype and the new state."""
        in_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        if state is None:
            b, _, h, w = x.shape
            zero = torch.zeros((b, self.hidden_channels, h, w), dtype=x.dtype, device=x.device)
            state = [zero.contiguous(memory_format=torch.channels_last)] * self.num_layers
        else:
            state = [s.to(x.dtype) for s in state]
        new_states = []
        cell = x
        for idx in range(self.num_layers):
            cell = F.relu(self.conv_blocks[idx](replicate_pad(cell, self.pads[idx])))
            prev = state[idx]
            stacked = torch.cat([cell, prev], dim=1)
            update = torch.sigmoid(self.update_gates[idx](stacked))
            reset = torch.sigmoid(self.reset_gates[idx](stacked))
            delta = torch.tanh(self.out_gates[idx](torch.cat([cell, prev * reset], dim=1)))
            cell = prev * (1 - update) + delta * update
            new_states.append(cell)
            cell = F.relu(cell)
        return self.conv_out(replicate_pad(cell, 1)).to(in_dtype), new_states


class RecurrentInit(nn.Module):
    """The hidden state's initializer: edge-padded dilated 3x3 VALID convs
    with ReLU (``channels`` x ``dilations``), the concatenation of the last
    ``multiscale_depth`` features when above 1, then ``depth`` 1x1 convs with
    ReLU, one a GRU layer. Output in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, channels: Sequence[int] = (32, 32, 64, 64),
                 dilations: Sequence[int] = (1, 1, 2, 4), depth: int = 4, multiscale_depth: int = 1, dtype=None):
        super().__init__()
        self.dilations = tuple(dilations)
        self.multiscale_depth = multiscale_depth
        self.dtype = as_torch_dtype(dtype)
        cins = [in_channels] + list(channels[:-1])
        self.conv_blocks = nn.ModuleList([Conv(ci, co, 3, d, "VALID", dtype=dtype)
                                          for ci, co, d in zip(cins, channels, dilations)])
        feat = sum(channels[-multiscale_depth:]) if multiscale_depth > 1 else channels[-1]
        self.out_blocks = nn.ModuleList([Conv(feat, out_channels, 1, dtype=dtype) for _ in range(depth)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in list(self.conv_blocks) + list(self.out_blocks):
            conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        features = []
        for conv, dil in zip(self.conv_blocks, self.dilations):
            x = F.relu(conv(replicate_pad(x, dil)))
            features.append(x)
        if self.multiscale_depth > 1:
            x = torch.cat(features[-self.multiscale_depth:], dim=1)
        return [F.relu(conv(x)) for conv in self.out_blocks]


class RecurrentVarNetBlock(nn.Module):
    """One step's weights: the learned DC rate (initialised to one) and the
    conv-GRU regulariser."""

    def __init__(self, in_channels: int = 2, hidden_channels: int = 64, num_layers: int = 4, dtype=None):
        super().__init__()
        self.learning_rate = nn.Parameter(torch.ones(1))
        self.regularizer = Conv2dGRU(2, hidden_channels, in_channels, num_layers, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.learning_rate)
        self.regularizer.reset_parameters(generator)


class RecurrentVarNet(BaseReconModel):
    """Config fields and defaults as in the JAX package; ``num_steps`` rounds
    up to a multiple of 8, ``no_parameter_sharing: false`` shares one block
    across the steps, ``learned_initializer: false`` starts from a zero
    state."""

    def __init__(
        self,
        in_channels: int = 2,
        recurrent_hidden_channels: int = 64,
        recurrent_num_layers: int = 4,
        num_steps: int = 8,
        no_parameter_sharing: bool = True,
        learned_initializer: bool = True,
        initializer_initialization: str = "sense",
        initializer_channels: Sequence[int] = (32, 32, 64, 64),
        initializer_dilations: Sequence[int] = (1, 1, 2, 4),
        initializer_multiscale: int = 1,
        compute_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.num_steps = num_steps
        self.no_parameter_sharing = no_parameter_sharing
        self.initializer_initialization = initializer_initialization
        self.initializer = None
        if learned_initializer:
            self.initializer = drawn(lambda: RecurrentInit(2, recurrent_hidden_channels, initializer_channels,
                                                           initializer_dilations, recurrent_num_layers,
                                                           initializer_multiscale, compute_dtype), generator)
        self.block_list = nn.ModuleList([
            drawn(lambda: RecurrentVarNetBlock(in_channels, recurrent_hidden_channels, recurrent_num_layers,
                                               compute_dtype), generator)
            for _ in range(num_steps if no_parameter_sharing else 1)
        ])
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            compute_dtype=cfg.get("compute_dtype"),
            in_channels=cfg.get("in_channels", 2),
            recurrent_hidden_channels=cfg.get("recurrent_hidden_channels", 64),
            recurrent_num_layers=cfg.get("recurrent_num_layers", 4),
            num_steps=8 * math.ceil(cfg.get("num_steps", 8) / 8),
            no_parameter_sharing=cfg.get("no_parameter_sharing", True),
            learned_initializer=cfg.get("learned_initializer", True),
            initializer_initialization=cfg.get("initializer_initialization", "sense"),
            initializer_channels=tuple(cfg.get("initializer_channels", (32, 32, 64, 64))),
            initializer_dilations=tuple(cfg.get("initializer_dilations", (1, 1, 2, 4))),
            initializer_multiscale=cfg.get("initializer_multiscale", 1),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def _initial_kspace(self, y, sens, init_pred):
        c, n = self.fft_centered, self.fft_normalization
        if self.initializer_initialization == "sense":
            return fft2_rv(sens_reduce(y, sens, None, c, n, self.spatial_dims, self.coil_dim), c, n)
        if self.initializer_initialization == "input_image" and init_pred is not None:
            return fft2_rv(init_pred.contiguous(), c, n)
        return fft2_rv(ifft2_rv(y, c, n), c, n).sum(self.coil_dim)  # zero_filled

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del train
        y, sens = y.contiguous(), sens.contiguous()
        m = expand_mask(mask)[..., None]
        c, n = self.fft_centered, self.fft_normalization
        hidden = None
        if self.initializer is not None:
            hidden = self.initializer(_nchw(self._initial_kspace(y, sens, init_pred)))
        kspace = y
        for step in range(self.num_steps):
            block = self.block_list[step if self.no_parameter_sharing else 0]
            image = sens_reduce(kspace, sens, None, c, n, self.spatial_dims, self.coil_dim)
            reg, hidden = block.regularizer(_nchw(image), hidden)
            reg_k = sens_expand(reg.permute(0, 2, 3, 1), sens, c, n)
            kspace = kspace - block.learning_rate * (m * (kspace - y)) + reg_k
        return ModelOutput(prediction=self.zero_filled(kspace, sens))
