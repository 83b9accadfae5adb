"""The end-to-end variational network: the weights, the program, the
reference and the counts.

Weights follow the package's layout generator for VarNet
(``chip_smoke.py:vn_layout_tree``): every kernel normal with variance
1 / fan-in (fan-in k * k * in, for the transpose convolutions too), zero
biases, DC weights 1, and each U-Net's final 1x1 kernel scaled by a gain of
0.05, which keeps a cascade's regulariser a correction to its DC step (at 1
eight random cascades compound rounding into the output).
"""

from __future__ import annotations

import math

from mribench.flops import conv_macs, fft_flops, kernel_bounds as _bounds, psf1d_flops
from reference import varnet as reference

__all__ = ["weight_shapes", "build_program", "reference", "time_steps", "forward_flops", "kernel_bounds"]


def _unet_convs(chans: int, pools: int):
    """(name, in, out, k, transposed, pixel scale) of each U-Net convolution,
    pixel scale the side's division of H and W at its output."""
    out, ch = [], chans

    def block(prefix, cin, cout, scale):
        out.append((prefix + "layers.0.weight", cin, cout, 3, False, scale))
        out.append((prefix + "layers.4.weight", cout, cout, 3, False, scale))

    block("down_sample_layers.0.", 2, ch, 1)
    for k in range(1, pools):
        block(f"down_sample_layers.{k}.", ch, ch * 2, 2 ** k)
        ch *= 2
    block("conv.", ch, ch * 2, 2 ** pools)
    for j in range(pools):
        out.append((f"up_transpose_conv.{j}.layers.0.weight", ch * 2, ch, 2, True, 2 ** (pools - 1 - j)))
        last = j == pools - 1
        block(f"up_conv.{j}." + ("0." if last else ""), ch * 2, ch, 2 ** (pools - 1 - j))
        if not last:
            ch //= 2
    return out, ch


def weight_shapes(model_cfg: dict, gain: float):
    shapes = []
    convs, ch = _unet_convs(model_cfg["channels"], model_cfg["pooling_layers"])
    for i in range(model_cfg["num_cascades"]):
        p = f"cascades.{i}."
        shapes.append((p + "dc_weight", (1,), ("ones",)))
        for name, cin, cout, k, transposed, _ in convs:
            shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
            shapes.append((p + "model.unet." + name, shape, ("normal", 1.0 / math.sqrt(k * k * cin))))
        last = f"{p}model.unet.up_conv.{model_cfg['pooling_layers'] - 1}.1."
        shapes.append((last + "weight", (2, ch, 1, 1), ("normal", gain / math.sqrt(ch))))
        shapes.append((last + "bias", (2,), ("zeros",)))
    return shapes


def build_program(program_cfg: dict, weights: dict, device):
    from mridc_tpu_torch.models import build_model

    model = build_model(program_cfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model


def time_steps(program_cfg: dict) -> int:
    return 1


def _padded(n: int, padding_size: int) -> int:
    return ((n - 1) | padding_size) + 1


def forward_flops(cfg: dict, program_cfg: dict) -> float:
    """Model operations of one slice's forward: each cascade's U-Net on the
    padded image (2 a multiply-accumulate), and the data terms by the DC
    mode's own algorithm (psf1d: the [W, W] complex operator a coil for every
    cascade but the last, whose term reaches no output; full: an inverse FFT
    and an FFT a coil a cascade, and the output's SENSE image), plus the SENSE
    start."""
    c, h, w = int(cfg["coils"]), int(cfg["height"]), int(cfg["width"])
    ps = int(program_cfg.get("padding_size", 11))
    hp, wp = _padded(h, ps), _padded(w, ps)
    convs, ch = _unet_convs(program_cfg["channels"], program_cfg["pooling_layers"])
    macs = 0
    for _, cin, cout, k, transposed, scale in convs:
        px_out = (hp // scale) * (wp // scale)
        macs += px_out * cin * cout if transposed else conv_macs(px_out, cin, cout, k)  # a k x k stride-k transpose
    macs += conv_macs(hp * wp, ch, 2, 1)
    n = program_cfg["num_cascades"]
    if program_cfg.get("dc_mode", "full") == "psf1d":
        dc = (n - 1) * c * psf1d_flops(h, w) + c * fft_flops(h * w)
    else:
        dc = (2 * n + 1) * c * fft_flops(h * w)
    return 2.0 * macs * n + dc


def kernel_bounds(cfg: dict, program_cfg: dict, batch: int) -> dict:
    dtype = str(program_cfg.get("dc_dtype") or "float32")
    return _bounds(batch, int(cfg["coils"]), int(cfg["height"]), int(cfg["width"]), dtype)
