"""Shared NN building blocks (counterpart of ``mridc_tpu/nn/layers.py``):
padded convolutions with a compute dtype, instance normalisation, batch
normalisation with torch semantics, and the one-alpha PReLU.

Layout: NCHW tensors in ``torch.channels_last`` memory format, which is
physically NHWC like the JAX package's layout. Kernels are OIHW (the JAX
package's HWIO transposed); parameters stay float32 and are cast to the
compute dtype at each call, as flax's ``dtype=`` does.

Precision: a float32 convolution runs in full float32, as the JAX package
computes it, whatever ``torch.backends.cudnn.allow_tf32`` says (PyTorch's
default lets cuDNN use TF32). The flag is read when a convolution runs, in
the forward and again in the backward (autograd's convolution node does not
record it), so :func:`conv2d` runs a float32 convolution under
:func:`cudnn_float32` and hooks its autograd node to turn the flag off while
the node runs. The node stays PyTorch's own, so a checkpoint's recompute
still stops before a convolution whose output the backward does not need
(a Python autograd Function would save its tensors only after running, and
so run one more convolution per checkpointed region).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mridc_tpu_torch.parallel.mesh import all_reduce_sum, distributed_world, joins_processes

__all__ = ["Conv", "ConvTranspose", "Conv3d", "ConvTranspose3d", "Dense", "ConvNonlinear", "InstanceNorm",
           "BatchNorm", "as_torch_dtype", "activation", "conv2d", "cudnn_float32", "prelu", "replicate_pad",
           "fan_in_truncated_normal_", "fan_avg_truncated_normal_", "nearest_resize", "bilinear_resize"]

# std of a unit normal cut at +-2, by which flax's truncated_normal divides
TRUNC_STD = 0.87962566103423978


def fan_in_truncated_normal_(
    weight: torch.Tensor, scale: float, generator: Optional[torch.Generator] = None, fan_in: Optional[int] = None
) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` on an OIHW
    kernel: a normal with std s = sqrt(scale / fan_in) / TRUNC_STD cut at +-2s,
    whose variance is scale / fan_in (``kaiming_normal``: scale 2,
    ``lecun_normal``: scale 1). ``fan_in`` defaults to I*H*W of an OIHW kernel."""
    s = math.sqrt(scale / (weight[0].numel() if fan_in is None else fan_in)) / TRUNC_STD
    return nn.init.trunc_normal_(weight, std=s, a=-2 * s, b=2 * s, generator=generator)


def fan_avg_truncated_normal_(
    weight: torch.Tensor, scale: float = 1.0, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_avg", "truncated_normal")`` on an
    OIHW kernel (``xavier_normal`` at scale 1): a normal with std s =
    sqrt(scale / fan_avg) / TRUNC_STD cut at +-2s, fan_avg = (I + O) * H * W / 2;
    not torch's ``xavier_normal_``, which neither truncates nor rescales."""
    receptive = weight[0, 0].numel()
    fan_avg = (weight.shape[0] + weight.shape[1]) * receptive / 2
    s = math.sqrt(scale / fan_avg) / TRUNC_STD
    return nn.init.trunc_normal_(weight, std=s, a=-2 * s, b=2 * s, generator=generator)


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """None | torch dtype | name ("bfloat16", "float32", ...) -> torch dtype or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype).lower(), None)
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f"Unknown compute dtype {dtype!r}")
    return out


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def cudnn_float32():
    """cuDNN's float32 convolutions in full float32 (TF32 off) inside, the
    global flag restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _hook_cudnn_float32(node) -> None:
    """Turn cuDNN's TF32 flag off while autograd ``node`` runs (restored
    after it)."""
    prev = []

    def off(grad_outputs):
        prev.append(torch.backends.cudnn.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False

    def restore(grad_inputs, grad_outputs):
        torch.backends.cudnn.allow_tf32 = prev.pop()

    node.register_prehook(off)
    node.register_hook(restore)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: Sequence[int] = (1, 1), padding: Sequence[int] = (0, 0), dilation: Sequence[int] = (1, 1),
           transposed: bool = False, output_padding: Optional[Sequence[int]] = None) -> torch.Tensor:
    """A 2D convolution, or a 3D one where ``stride`` has three entries
    (``transposed``: its transpose, ``output_padding`` zeros by default), in
    full float32 for float32 operands whatever the global cuDNN flag says;
    other dtypes take PyTorch's convolution as it is."""
    nd = len(stride)
    args = (list(stride), list(padding), list(dilation), transposed, list(output_padding or [0] * nd), 1)
    if x.dtype != torch.float32:
        return torch.ops.aten.convolution(x, weight, bias, *args)
    with cudnn_float32():
        out = torch.ops.aten.convolution(x, weight, bias, *args)
    if out.grad_fn is not None:
        _hook_cudnn_float32(out.grad_fn)
    return out


def activation(x: torch.Tensor, nonlinear: Optional[str]) -> torch.Tensor:
    if nonlinear is None or nonlinear.lower() == "none":
        return x
    if nonlinear.lower() == "relu":
        return F.relu(x)
    if nonlinear.lower() == "leakyrelu":
        return F.leaky_relu(x, 0.01)
    raise ValueError(f"Unknown nonlinearity {nonlinear!r}")


class Conv(nn.Conv2d):
    """Conv with flax padding semantics: ``"SAME"`` zero-pads ``d*(k-1)``
    split low-first (torch's ``padding="same"``; stride 1 only), ``"VALID"``
    pads nothing, an int ``p`` pads p zeros on every side (flax's explicit
    ``((p, p), (p, p))``, which the strided convs of DIDN use). ``dtype`` is
    the compute dtype (None: promote input and weight).

    ``pointwise_matmul``, ``lane_fold`` and ``fold_pad_mode`` select TPU
    lowerings in the JAX package that leave the numbers unchanged; they are
    accepted and ignored.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Union[int, Tuple[int, int]] = 3,
        kernel_dilation: Union[int, Tuple[int, int]] = 1,
        padding: Union[str, int] = "SAME",
        use_bias: bool = True,
        dtype=None,
        pointwise_matmul: bool = False,
        lane_fold: bool = False,
        fold_pad_mode: str = "zero",
        stride: int = 1,
    ):
        del pointwise_matmul, lane_fold, fold_pad_mode
        if isinstance(padding, int):
            pads = [(padding, padding)] * 2
        elif padding.upper() in ("SAME", "VALID") and (stride == 1 or padding.upper() == "VALID"):
            pads = None
        else:
            raise ValueError(f"Conv padding must be SAME (stride 1), VALID or an int, got {padding!r}")
        super().__init__(in_features, features, _pair(kernel_size), stride=stride, dilation=_pair(kernel_dilation),
                         bias=use_bias)
        if pads is None:
            # flax SAME at stride 1: d*(k-1) zeros, the smaller half first
            total = [d * (k - 1) if padding.upper() == "SAME" else 0 for k, d in zip(self.kernel_size, self.dilation)]
            pads = [(t // 2, t - t // 2) for t in total]
        self.pads = pads
        self.compute_dtype = as_torch_dtype(dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``nn.Conv``'s defaults: ``lecun_normal`` kernel, zero bias."""
        fan_in_truncated_normal_(self.weight, 1.0, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
        """The conv; ``with_bias=False`` leaves the bias out (``ConvNonlinear``
        adds it in K4's epilogue)."""
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None or not with_bias else self.bias.to(dt)
        x = x.to(dt)
        if any(lo != hi for lo, hi in self.pads):
            (th, bh), (lw, rw) = self.pads
            x, pads = F.pad(x, (lw, rw, th, bh)), (0, 0)
        else:
            pads = tuple(lo for lo, _ in self.pads)
        return conv2d(x, self.weight.to(dt), bias, self.stride, pads, self.dilation)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with ``padding="SAME"`` and kernel size equal
    to its stride (each input pixel paints one k x k output patch), no bias
    unless ``use_bias``. The weight is torch's (in, out, kH, kW); flax applies
    its (kH, kW, in, out) kernel unflipped, so the weight is flax's kernel
    transposed and flipped in both spatial axes
    (:func:`mridc_tpu_torch.utils.params.hwio_to_iohw_flipped`). ``dtype`` is
    the compute dtype.

    ``stride``, ``padding`` and ``output_padding`` give torch's
    ``ConvTranspose2d(k, s, p, 2p + s - k)``, the form MONAI's blocks take:
    flax's VALID transpose conv of stride s cropped to rows [p, p + s * in)
    (``mridc_tpu/nn/seg_blocks.py:_TorchConvTranspose``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 2, dtype=None, stride: Optional[int] = None,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = False):
        super().__init__(in_features, features, kernel_size, stride=stride or kernel_size, padding=padding,
                         output_padding=output_padding, bias=use_bias)
        self.compute_dtype = as_torch_dtype(dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``lecun_normal`` on the (kH, kW, in, out) kernel: fan-in kH*kW*in; zero bias."""
        fan_in_truncated_normal_(self.weight, 1.0, generator, fan_in=self.in_channels * self.weight[0, 0].numel())
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, (1, 1), transposed=True,
                      output_padding=self.output_padding)


class Conv3d(nn.Conv3d):
    """The 3D :class:`Conv`: flax padding semantics (``"SAME"`` at stride 1,
    ``"VALID"``), OIDHW weight (flax's DHWIO transposed), ``dtype`` the
    compute dtype, flax's ``lecun_normal`` kernel and zero bias."""

    def __init__(self, in_features: int, features: int, kernel_size=3, padding: str = "SAME", use_bias: bool = True,
                 dtype=None):
        ks = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(kernel_size)
        if padding.upper() not in ("SAME", "VALID"):
            raise ValueError(f"Conv3d padding must be SAME or VALID, got {padding!r}")
        super().__init__(in_features, features, ks, bias=use_bias)
        total = [k - 1 if padding.upper() == "SAME" else 0 for k in ks]
        self.pads = [(t // 2, t - t // 2) for t in total]
        self.compute_dtype = as_torch_dtype(dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in_truncated_normal_(self.weight, 1.0, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt)
        if any(lo != hi for lo, hi in self.pads):
            (fd, bd), (th, bh), (lw, rw) = self.pads
            x, pads = F.pad(x, (lw, rw, th, bh, fd, bd)), (0, 0, 0)
        else:
            pads = tuple(lo for lo, _ in self.pads)
        return conv2d(x, self.weight.to(dt), bias, (1, 1, 1), pads, (1, 1, 1))


class ConvTranspose3d(nn.ConvTranspose3d):
    """flax ``nn.ConvTranspose`` in 3D with kernel size equal to its stride
    (``(1, 2, 2)``: in-plane only), no bias: torch's (in, out, kD, kH, kW)
    weight is flax's kernel transposed and flipped in its three spatial axes."""

    def __init__(self, in_features: int, features: int, kernel_size=(1, 2, 2), dtype=None):
        super().__init__(in_features, features, tuple(kernel_size), stride=tuple(kernel_size), bias=False)
        self.compute_dtype = as_torch_dtype(dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in_truncated_normal_(self.weight, 1.0, generator, fan_in=self.in_channels * self.weight[0, 0].numel())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return conv2d(x.to(dt), self.weight.to(dt), None, self.stride, (0, 0, 0), (1, 1, 1), transposed=True)


class Dense(nn.Linear):
    """flax ``nn.Dense``: the weight is torch's [out, in] (flax's [in, out]
    kernel transposed), ``lecun_normal`` (fan-in ``in``), zero bias; ``dtype``
    the compute dtype (a float32 product stays float32: PyTorch's matmul TF32
    flag is off by default)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None):
        super().__init__(in_features, features, bias=use_bias)
        self.compute_dtype = as_torch_dtype(dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in_truncated_normal_(self.weight, 1.0, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over the spatial axes of an NCHW
    or NCDHW tensor (``mridc_tpu/nn/layers.py:InstanceNorm``: torch's
    InstanceNorm2d/3d without affine, eps 1e-5, population variance), or over
    the axes ``dims`` given to the call. The statistics are taken in float32
    whatever the input's dtype; the output is in the input's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, dims: Optional[Sequence[int]] = None) -> torch.Tensor:
        xf = x.float()
        dims = tuple(range(2, x.ndim)) if dims is None else tuple(dims)
        var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``where(x >= 0, x, alpha * x)`` with one learned alpha, in x's dtype:
    the JAX package's PReLU (``mridc_tpu/nn/conv2d.py``, ``nn/didn.py``). Not
    ``F.prelu``, whose gradient at x = 0 is alpha's side, where this one (and
    the JAX package's) is 1; masked k-space puts many exact zeros there."""
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


class BatchNorm(nn.Module):
    """BatchNorm with torch semantics over the channels of an NCHW tensor
    (``mridc_tpu/nn/layers.py:TorchBatchNorm``); the statistics run in float32
    whatever the input's dtype, and the output is in the input's dtype.

    ``live=False`` (frozen): the running ``mean`` and ``var`` are parameters,
    as the JAX package keeps them in ``params``, used without a gradient: a
    training step hands them a zero gradient, and the optimizer does to them
    what optax does to a parameter with a zero gradient (weight decay moves
    them). Train mode normalises with the batch's biased statistics; eval
    mode with the stored ones, which nothing updates.

    ``live=True`` (the ``train_batch_stats`` knob): the running statistics
    are the float32 buffers ``running_mean`` and ``running_var`` (the JAX
    package's ``batch_stats`` collection). Train mode normalises with the
    batch's biased statistics and updates running = (1 - m) running + m batch
    with the unbiased batch variance (``F.batch_norm``'s own update); eval
    mode normalises with the running ones.

    Across processes (a process group of more than one), train mode takes the
    statistics of the batch the processes hold together, as the JAX package's
    step over the mesh's global batch does: the per-channel sums are summed
    over the processes, differentiably (``parallel/mesh.py``
    ``all_reduce_sum``), and every process updates the same running
    statistics. ``torch.nn.SyncBatchNorm`` takes CUDA tensors only."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1, live: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.live = live
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        if live:
            self.register_buffer("running_mean", torch.zeros(num_features))
            self.register_buffer("running_var", torch.ones(num_features))
        else:
            self.mean = nn.Parameter(torch.zeros(num_features))
            self.var = nn.Parameter(torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        if self.live:
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
        else:
            nn.init.zeros_(self.mean)
            nn.init.ones_(self.var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train and joins_processes():
            out = self._joined_batch_norm(xf)
        elif self.live:
            out = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias, train, self.momentum,
                               self.eps)
        elif train:
            out = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            out = F.batch_norm(xf, self.mean.detach(), self.var.detach(), self.weight, self.bias, False, 0.0, self.eps)
        if out.requires_grad and out.device.type == "cpu":
            out.register_hook(_relaid_like(xf))
        return out.to(x.dtype)


    def _joined_batch_norm(self, xf: torch.Tensor) -> torch.Tensor:
        """Train mode over the processes' joined batch (equal shards): the
        biased mean and variance from sums over every process, two passes."""
        world = distributed_world()
        dims = [0] + list(range(2, xf.ndim))
        shape = [1, -1] + [1] * (xf.ndim - 2)
        n = xf.numel() // xf.shape[1] * world
        mean = all_reduce_sum(xf.sum(dims)) / n
        centered = xf - mean.reshape(shape)
        var = all_reduce_sum((centered * centered).sum(dims)) / n
        if self.live:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach() * (n / max(n - 1, 1)), alpha=m)
        return centered * torch.rsqrt(var + self.eps).reshape(shape) * self.weight.reshape(shape) + \
            self.bias.reshape(shape)


def _relaid_like(x: torch.Tensor):
    """A gradient hook that re-lays a gradient with standard strides in
    ``x``'s memory format. PyTorch's CPU ``batch_norm`` backward misreads a
    channels_last gradient of batch 1 whose batch stride is not C*H*W (legal
    for an axis of size 1; einsum's backward makes one) against an NCHW
    input, and returns wrong gradients for the input, the weight and the
    bias; the card's kernels read it right."""
    fmt = torch.channels_last if x.ndim == 4 and not x.is_contiguous() and \
        x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format

    def relay(g: torch.Tensor) -> torch.Tensor:
        return torch.empty(g.shape, dtype=g.dtype, device=g.device, memory_format=fmt).copy_(g)
    return relay


def replicate_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge padding of the last two axes, equal to ``F.pad(x, (pad,) * 4,
    mode="replicate")``, in x's memory format: K4's pad
    (``kernels/k4_conv_epilogue.py``). The kernel takes a channels_last or a
    contiguous tensor; any other layout is handed to it channels_last."""
    from mridc_tpu_torch.kernels.k4_conv_epilogue import edge_pad  # kernels import this module

    if x.device.type == "cuda" and not (x.is_contiguous(memory_format=torch.channels_last) or x.is_contiguous()):
        x = x.contiguous(memory_format=torch.channels_last)
    return edge_pad(x, pad)


class ConvNonlinear(nn.Module):
    """Replicate-padded conv + nonlinearity: the JAX package pads with
    ``mode="edge"`` and runs a VALID conv (``mridc_tpu/nn/layers.py:277-290``),
    so the halo repeats the border instead of adding zeros."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        dilation: int = 1,
        use_bias: bool = True,
        nonlinear: Optional[str] = "relu",
        dtype=None,
        lane_fold: bool = False,
    ):
        super().__init__()
        del lane_fold
        self.pad = dilation * (kernel_size - 1) // 2
        self.nonlinear = nonlinear
        self.conv_layer = Conv(in_features, features, kernel_size, dilation, "VALID", use_bias, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``kaiming_normal`` kernel (``mridc_tpu/nn/layers.py:286``), zero bias."""
        fan_in_truncated_normal_(self.conv_layer.weight, 2.0, generator)
        if self.conv_layer.bias is not None:
            nn.init.zeros_(self.conv_layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The pad, the conv without its bias, then the bias and the
        activation in K4's epilogue (neither: the conv alone). The epilogue
        takes a channels_last conv output on the card, which a channels_last
        input gives; another is handed to it channels_last."""
        from mridc_tpu_torch.kernels.k4_conv_epilogue import act_code, bias_act  # kernels import this module

        if self.pad:
            x = replicate_pad(x, self.pad)
        conv = self.conv_layer
        if conv.bias is None and act_code(self.nonlinear) == 0:
            return conv(x)
        y = conv(x, with_bias=False)
        if y.device.type == "cuda":
            y = y.contiguous(memory_format=torch.channels_last)
        return bias_act(y, None if conv.bias is None else conv.bias.to(y.dtype), self.nonlinear)


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor to [out_h, out_w]
    (``mridc_tpu/nn/layers.py:nearest_resize``, which defines itself as torch's
    ``F.interpolate(mode="nearest")``: source index floor(i * in / out))."""
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor with half-pixel centres and no
    antialiasing (``mridc_tpu/nn/layers.py:bilinear_resize``: torch's
    ``F.interpolate(mode="bilinear", align_corners=False)``)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=False)
