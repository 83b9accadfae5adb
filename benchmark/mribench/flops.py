"""The yardstick: one H100's peaks, the least time of a kernel launch from
the bytes and operations its shapes need, and the operation counts of the
pieces models are made of.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the card's 700 W limit):
989 TFLOP/s of bfloat16 products on the tensor cores; 67 TFLOP/s of float32
on the CUDA cores; 495 TFLOP/s of TF32 products, so 165 of float32-accurate
products as three TF32 products each (3xTF32, the route the hand kernels take
for float32 products); 3.35 TB/s of HBM.

A launch's bound is the larger of its bytes over the HBM rate and its
operations over the peak of their route (routes run side by side), counting
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math
from typing import Dict

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "MODEL_PEAK", "bound_ms", "conv_macs", "fft_flops", "psf1d_flops",
           "kernel_bounds"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float32_products": 495e12 / 3, "bfloat16_products": 989e12}
PRODUCTS = {"float32": "float32_products", "bfloat16": "bfloat16_products"}
# the peak an MFU divides by, by the compute dtype the cell states: bfloat16
# products on the tensor cores; float32 on the CUDA cores (the port runs its
# float32 convolutions in full float32, without TF32)
MODEL_PEAK = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: float, flops: Dict[str, float]) -> float:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max([f / PEAK_FLOPS[route] for route, f in flops.items()] + [0.0])
    return max(t_bytes, t_ops) * 1e3


def conv_macs(pixels_out: int, cin: int, cout: int, k: int) -> int:
    """Multiply-accumulates of a k x k convolution over ``pixels_out`` outputs."""
    return pixels_out * cin * cout * k * k


def fft_flops(n: int) -> float:
    """A complex FFT of n points, 5 n log2 n (the radix-2 count)."""
    return 5.0 * n * math.log2(n)


def psf1d_flops(h: int, w: int) -> float:
    """One coil's [W, W] complex operator applied to its H rows: 8 H W^2 (4
    real products and 4 adds a complex multiply-accumulate)."""
    return 8.0 * h * w * w


def kernel_bounds(b: int, c: int, h: int, w: int, dtype: str, filters: int = 0, pads=()) -> Dict[str, float]:
    """Bound ms of one launch of each hand-kernel entry at a cell's shapes:
    batch ``b``, ``c`` coils, H x W, the compute ``dtype`` ("float32" or
    "bfloat16"), ``filters`` hidden channels of K3 and K4's epilogue, and
    ``pads`` the (channels, pad) of K4's edge pads in the order a step runs
    them (their launches are taken as equally many: the mean bound)."""
    es = 2 if dtype == "bfloat16" else 4
    prod, hw, p = PRODUCTS[dtype], h * w, b * h * w
    coil = b * c * hw * 8  # a complex64 coil tensor
    k1_ops = {prod: 6 * b * c * h * w * w, "float32": 17 * b * c * hw + 4 * b * hw}  # the Gauss form: 3 products
    out = {
        # eta, sens, the 3 operator planes, z0 in; [B, H, W, 4] out
        "k1_fwd": bound_ms(es * (b * hw * 2 + b * c * hw * 2 + b * 3 * w * w + b * hw * 2 + b * hw * 4), k1_ops),
        # g [B, H, W, 4], sens, the operator in; d_eta out
        "k1_bwd": bound_ms(es * (b * hw * 4 + b * c * hw * 2 + b * 3 * w * w + b * hw * 2), k1_ops),
        "k2_expand": bound_ms(2 * coil + b * hw * 8, {"float32": 6 * b * c * hw}),
        "k2_residual": bound_ms(3 * coil + b * hw * 4, {"float32": 4 * b * c * hw}),
        "k2_load": bound_ms(2 * coil + b * hw * 4, {"float32": 2 * b * c * hw}),
        # P and sens in, eta in and [eta, grad] out (the DC's form; the SENSE image's writes less)
        "k2_reduce": bound_ms(2 * coil + b * hw * 8 + b * hw * 16, {"float32": 8 * b * c * hw}),
        "k2_mask": bound_ms(2 * coil + b * hw * 4, {"float32": 2 * b * c * hw}),
        "k2_reduce_acc": bound_ms(2 * coil + b * hw * 16 + b * hw * 8, {"float32": 8 * b * c * hw + 2 * b * hw}),
    }
    if filters:
        f = filters
        out["k3_fwd"] = bound_ms(es * (p * f + 2 * p * f + f * f + 2 * f), {prod: 2 * p * f * f, "float32": 3 * p * f})
        out["k3_bwd"] = bound_ms(es * (2 * p * f + 4 * p * f + f * f) + 4 * (f * f + 3 * f),
                                 {prod: 4 * p * f * f, "float32": 5 * p * f})
        out["k4_bias_act"] = bound_ms(es * (2 * p * f + f), {"float32": 2 * p * f})
        out["k4_bias_act_bwd"] = bound_ms(es * 3 * p * f + 4 * f, {"float32": 2 * p * f})
    if pads:
        fwd, bwd = [], []
        for ch, pad in pads:
            inner, padded = b * h * w * ch, b * (h + 2 * pad) * (w + 2 * pad) * ch
            fwd.append(bound_ms(es * (inner + padded), {}))
            bwd.append(bound_ms(es * (inner + padded), {"float32": padded - inner}))
        out["k4_pad"] = sum(fwd) / len(fwd)
        out["k4_pad_bwd"] = sum(bwd) / len(bwd)
    return out
