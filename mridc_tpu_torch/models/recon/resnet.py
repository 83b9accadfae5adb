"""ResNet with conjugate-gradient data consistency, and ProximalGradient (the
SSDU default models; counterpart of ``mridc_tpu/models/recon/resnet.py``).

The CG solve applies the normal operator ``E^H M E + mu I`` through
:func:`~mridc_tpu_torch.kernels.k2_full_dc.normal_op` (K2's stages around
cuFFT on the card, forward and backward). Its complex scalars (dot products,
alpha, beta) are (re, im) pairs as in the JAX package, computed on complex64
views of the real-view tensors: a dot product is one ``torch.vdot`` over every
axis, the batch included, so the examples of a batch share one alpha and one
beta per iteration.

Module names: ResNet's ``ResidualNetwork`` is ``residual_network`` with the
reference's ``conv1``, ``layers1.{i}`` (inner), ``layers2.{i}`` (outer),
``last_layer`` and ``final_layer``; the CG weight is ``mu`` (ResNet with
``conjugate_gradient_dc``, and ProximalGradient).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.kernels.k2_full_dc import normal_op
from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, drawn, expand_mask
from mridc_tpu_torch.nn.layers import Conv, fan_avg_truncated_normal_
from mridc_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["ResidualNetwork", "conjugate_gradient", "ResNet", "ProximalGradient", "cdot", "cdiv", "cscale"]


class ResidualNetwork(nn.Module):
    """Scaled residual blocks of 3x3 zero-SAME convs without bias: ``h = reg *
    layers2(relu(layers1(h))) + h`` after ``conv1``, an outer skip around the
    blocks and ``last_layer``, then ``final_layer`` to 2 channels. Takes and
    returns NHWC [B, H, W, 2]; ``dtype`` is the convolutions' compute dtype
    (the output is in the input's dtype)."""

    def __init__(self, nb_res_blocks: int = 15, channels: int = 64, regularization_factor: float = 0.1, dtype=None):
        super().__init__()
        self.regularization_factor = regularization_factor

        def conv(cin, cout):
            return Conv(cin, cout, 3, use_bias=False, dtype=dtype)

        self.conv1 = conv(2, channels)
        self.layers1 = nn.ModuleList([conv(channels, channels) for _ in range(nb_res_blocks)])
        self.layers2 = nn.ModuleList([conv(channels, channels) for _ in range(nb_res_blocks)])
        self.last_layer = conv(channels, channels)
        self.final_layer = conv(channels, 2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``xavier_normal`` (fan-avg truncated normal) in flax's
        creation order: conv1, each block's outer conv before its inner one,
        last_layer, final_layer."""
        convs = [self.conv1]
        for inner, outer in zip(self.layers1, self.layers2):
            convs += [outer, inner]
        for conv in convs + [self.last_layer, self.final_layer]:
            fan_avg_truncated_normal_(conv.weight, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)  # NHWC -> NCHW
        out = self.conv1(x)  # each conv casts its input to the compute dtype
        h = out
        for inner, outer in zip(self.layers1, self.layers2):
            h = torch.add(h, outer(F.relu(inner(h))), alpha=self.regularization_factor)
        h = self.last_layer(h) + out
        return self.final_layer(h).to(in_dtype).permute(0, 2, 3, 1).contiguous()


def _c(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(x.contiguous())


def cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> = sum over every axis of conj(a) b, as an (re, im) pair; over
    the processes' joined batch across processes (``parallel/mesh.py``)."""
    return all_reduce_sum(torch.view_as_real(torch.vdot(_c(a).reshape(-1), _c(b).reshape(-1))))


def cdiv(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den of (re, im) pairs, with 1e-30 added to |den|^2."""
    return torch.view_as_real(_c(num) * _c(den).conj() / (den.square().sum() + 1e-30))


def cscale(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The (re, im) pair s times the real-view complex tensor x."""
    return torch.view_as_real(_c(s) * _c(x))


def conjugate_gradient(
    rhs: torch.Tensor,
    sens: torch.Tensor,
    mask: torch.Tensor,
    mu,
    iterations: int = 10,
    fft_centered: bool = False,
    fft_normalization: str = "ortho",
    spatial_dims: Sequence[int] = (-2, -1),
    coil_dim: int = 1,
) -> torch.Tensor:
    """Solve (E^H M E + mu I) x = rhs by ``iterations`` CG steps from x = 0;
    ``rhs`` [B, H, W, 2], ``mask`` broadcastable to [B, 1, H, W]."""
    if tuple(spatial_dims) not in ((-2, -1), (2, 3)) or coil_dim != 1:
        raise ValueError("conjugate_gradient takes [B, C, H, W, 2] maps with coils on axis 1")
    b, _, h, w, _ = sens.shape
    mask = torch.broadcast_to(mask, (b, 1, h, w)).to(torch.float32).contiguous()
    sens = sens.contiguous()
    rhs = rhs.contiguous()
    x, r, p = torch.zeros_like(rhs), rhs, rhs
    rsold = cdot(rhs, rhs)
    for _ in range(iterations):
        ap = normal_op(p, sens, mask, mu, fft_centered, fft_normalization)
        alpha = cdiv(rsold, cdot(p, ap))
        x = x + cscale(alpha, p)
        r = r - cscale(alpha, ap)
        rsnew = cdot(r, r)
        beta = cdiv(rsnew, rsold)
        p = r + cscale(beta, p)
        rsold = rsnew
    return x


class ResNet(BaseReconModel):
    """Config fields and defaults as in the JAX package: ``unrolled_iterations``
    applications of one shared :class:`ResidualNetwork`, each followed (with
    ``conjugate_gradient_dc``) by a CG solve of ``(E^H M E + mu I) x =
    zero_filled + mu x``, mu a learned weight starting at
    ``penalization_weight``. ``compute_dtype`` is the residual network's; the
    CG stays float32."""

    def __init__(
        self,
        unrolled_iterations: int = 10,
        residual_blocks: int = 15,
        channels: int = 64,
        regularization_factor: float = 0.1,
        conjugate_gradient_dc: bool = False,
        conjugate_gradient_iterations: int = 10,
        penalization_weight: float = 1.0,
        compute_dtype=None,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.unrolled_iterations = unrolled_iterations
        self.conjugate_gradient_dc = conjugate_gradient_dc
        self.conjugate_gradient_iterations = conjugate_gradient_iterations
        self.residual_network = drawn(lambda: ResidualNetwork(residual_blocks, channels, regularization_factor,
                                                              compute_dtype), generator)
        self.mu = nn.Parameter(torch.full((1,), float(penalization_weight))) if conjugate_gradient_dc else None
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            compute_dtype=cfg.get("compute_dtype"),
            unrolled_iterations=cfg.get("unrolled_iterations", 10),
            residual_blocks=cfg.get("residual_blocks", 15),
            channels=cfg.get("channels", 64),
            regularization_factor=cfg.get("regularization_factor", 0.1),
            conjugate_gradient_dc=cfg.get("conjugate_gradient_dc", False),
            conjugate_gradient_iterations=cfg.get("conjugate_gradient_iterations", 10),
            penalization_weight=cfg.get("penalization_weight", 1.0),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
            generator=generator,
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del init_pred, train
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        prediction = self.zero_filled(y, sens)
        x = prediction
        for _ in range(self.unrolled_iterations):
            x = self.residual_network(x)
            if self.conjugate_gradient_dc:
                x = conjugate_gradient(prediction + self.mu * x, sens, mask, self.mu,
                                       self.conjugate_gradient_iterations, self.fft_centered,
                                       self.fft_normalization, self.spatial_dims, self.coil_dim)
        return ModelOutput(prediction=x)


class ProximalGradient(BaseReconModel):
    """The CG solve of ``(E^H M E + mu I) x = zero_filled``, mu a learned
    weight starting at ``penalization_weight``."""

    def __init__(
        self,
        conjugate_gradient_iterations: int = 10,
        penalization_weight: float = 1.0,
        fft_centered: bool = False,
        fft_normalization: str = "backward",
        spatial_dims: Sequence[int] = (-2, -1),
        coil_dim: int = 1,
        coil_combination_method: str = "SENSE",
    ):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.conjugate_gradient_iterations = conjugate_gradient_iterations
        self.mu = nn.Parameter(torch.full((1,), float(penalization_weight)))

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        del generator
        return cls(
            conjugate_gradient_iterations=cfg.get("conjugate_gradient_iterations", 10),
            penalization_weight=cfg.get("penalization_weight", 1.0),
            fft_centered=cfg.get("fft_centered", False),
            fft_normalization=cfg.get("fft_normalization", "backward"),
            spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))),
            coil_dim=cfg.get("coil_dim", 1),
            coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper(),
        )

    def forward(self, y, sens, mask, init_pred=None, train: bool = False) -> ModelOutput:
        del init_pred, train
        y, sens, mask = y.contiguous(), sens.contiguous(), expand_mask(mask)
        x = conjugate_gradient(self.zero_filled(y, sens), sens, mask, self.mu, self.conjugate_gradient_iterations,
                               self.fft_centered, self.fft_normalization, self.spatial_dims, self.coil_dim)
        return ModelOutput(prediction=x)
