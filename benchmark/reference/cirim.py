"""CIRIM as published (Karkalousos et al., arXiv:2111.15498;
``projects/reconstruction/conf/base_cirim_train.yaml``), in plain PyTorch.

Cascades of Recurrent Inference Machines: the first cascade starts from the
SENSE image of the measured k-space, each later one from the previous
cascade's final estimate with its gradient stopped, and hidden states start
at zero in every cascade. A time step takes the estimate eta and the data
term A^H (M A eta - y) as four channels [Re eta, Im eta, Re g, Im g] and
runs, per recurrent layer, an edge-padded convolution with bias and ReLU and
an IndRNN cell h' = ReLU(W x + b + u * h), then an edge-padded convolution to
two channels, which it adds to eta. The data term is computed as written
(FFT, mask, inverse FFT) whatever the mask; a 1D mask is its rows repeated.

Weights are a dict keyed as the benchmark names them
(``cirim.{c}.layers.{l}.convs.conv_layer.weight`` and so on); convolution
weights are [out, in, kH, kW].
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.common import Precision, likelihood_gradient, sense_reduce

__all__ = ["forward"]


def _step(w: Dict[str, torch.Tensor], c: int, cfg: dict, x: torch.Tensor, eta: torch.Tensor, hs: List[torch.Tensor],
          prec: Precision):
    """One time step of cascade ``c`` on the four-channel input ``x``
    [B, 4, H, W]: returns (eta + dx, the new hidden states)."""
    new_hs = []
    layers = [i for i, f in enumerate(cfg["recurrent_filters"]) if f]
    for li, hidden in zip(layers, hs):
        k, d = cfg["conv_kernels"][li], cfg["conv_dilations"][li]
        pad = d * (k - 1) // 2
        p = f"cirim.{c}.layers.{li}."
        z = F.pad(x, (pad,) * 4, mode="replicate")
        z = F.relu(prec.conv(z, w[p + "convs.conv_layer.weight"], w.get(p + "convs.conv_layer.bias"), dilation=d))
        x = F.relu(prec.conv(z, w[p + "rnn.ih.weight"], w.get(p + "rnn.ih.bias")) + w[p + "rnn.hh"] * hidden)
        new_hs.append(x)
    last = len(cfg["conv_filters"]) - 1
    k, d = cfg["conv_kernels"][last], cfg["conv_dilations"][last]
    pad = d * (k - 1) // 2
    p = f"cirim.{c}.final_layer.0.conv_layer."
    dx = prec.conv(F.pad(x, (pad,) * 4, mode="replicate"), w[p + "weight"], w.get(p + "bias"), dilation=d)
    return eta + torch.complex(dx[:, 0], dx[:, 1]), new_hs


def forward(w: Dict[str, torch.Tensor], cfg: dict, y: torch.Tensor, sens: torch.Tensor, mask: torch.Tensor,
            centered: bool, norm: str, prec: Precision = Precision()) -> List[torch.Tensor]:
    """Every time step's estimate, cascade after cascade ([B, H, W] complex
    each, cascades x time_steps of them; the prediction is the last).
    ``y``, ``sens``: [B, C, H, W] complex; ``mask``: [B, 1, H, W] real."""
    b, _, h, wd = y.shape
    eta = sense_reduce(y, sens, centered, norm)
    n_hidden = [f for f in cfg["recurrent_filters"] if f]
    out = []
    for c in range(cfg["num_cascades"]):
        hs = [torch.zeros(b, f, h, wd, dtype=torch.float32, device=y.device) for f in n_hidden]
        for _ in range(cfg["time_steps"]):
            g = likelihood_gradient(eta, y, sens, mask, centered, norm)
            x = torch.stack([eta.real, eta.imag, g.real, g.imag], dim=1)
            eta, hs = _step(w, c, cfg, x, eta, hs, prec)
            out.append(eta)
        eta = eta.detach()
    return out
