"""CIRIM: the weights, the program, the reference and the counts.

Weights follow the scales of the package's layout generator for the flagship
(``chip_smoke.py:jax_layout_tree``): the convolutions He-normal, their biases
normal(0.01), the IndRNN input weights normal(gain / sqrt(F)) and its
recurrent weights uniform(0, gain / 2), where the gain 0.3 keeps 5 x 8 steps
bounded and moving (at the initialisers' own scales the network barely moves
the SENSE image).
"""

from __future__ import annotations

import math

from mribench.flops import conv_macs, fft_flops, kernel_bounds as _bounds, psf1d_flops
from reference import cirim as reference

__all__ = ["weight_shapes", "build_program", "reference", "time_steps", "forward_flops", "kernel_bounds"]


def weight_shapes(model_cfg: dict, gain: float):
    shapes = []
    for c in range(model_cfg["num_cascades"]):
        cin = 4
        layers = zip(model_cfg["conv_filters"], model_cfg["conv_kernels"], model_cfg["recurrent_filters"],
                     model_cfg["conv_bias"], model_cfg["recurrent_bias"])
        for i, (cf, ck, rf, cb, rb) in enumerate(layers):
            p = f"cirim.{c}.layers.{i}." if rf else f"cirim.{c}.final_layer.0."
            conv = p + ("convs.conv_layer." if rf else "conv_layer.")
            shapes.append((conv + "weight", (cf, cin, ck, ck), ("normal", math.sqrt(2.0 / (ck * ck * cin)))))
            if cb:
                shapes.append((conv + "bias", (cf,), ("normal", 0.01)))
            if rf:
                shapes.append((p + "rnn.hh", (1, rf, 1, 1), ("uniform", gain / 2)))
                shapes.append((p + "rnn.ih.weight", (rf, cf, 1, 1), ("normal", gain / math.sqrt(cf))))
                if rb:
                    shapes.append((p + "rnn.ih.bias", (rf,), ("normal", 0.01)))
                cin = rf
    return shapes


def build_program(program_cfg: dict, weights: dict, device):
    from mridc_tpu_torch.models import build_model

    model = build_model(program_cfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model


def time_steps(program_cfg: dict) -> int:
    return int(program_cfg["time_steps"])


def forward_flops(cfg: dict, program_cfg: dict) -> float:
    """Model operations of one slice's forward: the convolutions (2 a
    multiply-accumulate) of every time step, and the data term by the DC
    mode's own algorithm (psf1d: the [W, W] complex operator a coil a step,
    plus a cascade's masked SENSE image; full: an FFT and an inverse FFT a
    coil a step), plus the SENSE start."""
    c, h, w = int(cfg["coils"]), int(cfg["height"]), int(cfg["width"])
    px, cin, macs = h * w, 4, 0
    for cf, ck, rf in zip(program_cfg["conv_filters"], program_cfg["conv_kernels"], program_cfg["recurrent_filters"]):
        macs += conv_macs(px, cin, cf, ck)
        if rf:
            macs += conv_macs(px, cf, rf, 1)
            cin = rf
    steps = program_cfg["num_cascades"] * program_cfg["time_steps"]
    if program_cfg.get("dc_mode", "full") == "psf1d":
        dc = steps * c * psf1d_flops(h, w) + program_cfg["num_cascades"] * c * fft_flops(px)
    else:
        dc = steps * 2 * c * fft_flops(px)
    return 2.0 * macs * steps + dc + c * fft_flops(px)


def kernel_bounds(cfg: dict, program_cfg: dict, batch: int) -> dict:
    f = [x for x in program_cfg["recurrent_filters"] if x]
    pads, cin = [], 4
    for cf, ck, cd in zip(program_cfg["conv_filters"], program_cfg["conv_kernels"], program_cfg["conv_dilations"]):
        pads.append((cin, cd * (ck - 1) // 2))
        cin = cf
    dtype = str(program_cfg.get("compute_dtype") or "float32")
    return _bounds(batch, int(cfg["coils"]), int(cfg["height"]), int(cfg["width"]), dtype, f[0], pads)

