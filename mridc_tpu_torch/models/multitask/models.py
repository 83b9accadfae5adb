"""Joint reconstruction + segmentation models (counterpart of
``mridc_tpu/models/multitask/models.py``): MTLRS (also JRSCIRIM), IDSLR,
IDSLRUNet, SegNet, RecSegUNet and SERANet.

Contract: ``forward(y, sens, mask, init_pred=None, train=False) ->
(ModelOutput, seg)`` with seg [B, H, W, classes] (NHWC, float32); SegNet in
train mode returns the stack of its per-iteration and fused segmentations
[N, B, H, W, classes]. Each segmentation input is group-normed without a
gradient (``_group_norm_nograd``: the segmentation loss does not reach the
reconstruction through it), and a segmentation normalised by its signed
maximum uses ``torch.amax``, whose gradient splits at ties as JAX's ``max``.

MTLRS is ``rs_cascades`` blocks of CIRIM cascades (``RIMBlock``, the
likelihood-gradient DC on K2 in ``full`` mode and K1 in ``psf1d`` mode, two
IndRNN cells a step on K3), each followed by a segmentation head (the
attention U-Net, U-Net, lambda U-Net or V-Net of ``nn/seg_blocks.py``); the
hidden state threads through every cascade and block, and with
``task_adaption_type: multi_task_learning`` |recon| x seg, tiled over each
hidden state's channels, is added to it after each block. Its heads run
under ``torch.utils.checkpoint`` in train mode (the JAX package's
``nn.remat``, value-exact) but with live BatchNorm statistics. The other
five run no hand kernel but the SENSE init of RecSegUNet and SERANet
(``BaseReconModel.sense_init``: K2's load and reduce stages) where no
initial prediction is given; their data consistency is a weighted k-space
blend around the FFT.

Widths that follow the data: IDSLR's, IDSLRUNet's and SegNet's encoders take
and their reconstruction decoders give 2 x coils channels, SERANet's
segmentation ConvLSTM takes max(coils, ``seg_in_chans``) and its attention
gate and recurrent ConvLSTM twice that. flax infers them at ``init``; these
four models build their modules at the first batch (``materialize``, which
``MultitaskTrainer.init_state`` calls), from the weights' shapes
(``load_state_dict``) or at the first forward, with the weights drawn from
the generator the model was built with.

Names: every flax scope carries its name in ``flax_scope`` (MTLRS's heads
``{class}_{i}``, the explicit name of the JAX package's ``nn.remat``), so
``utils/params.py`` reads the weight mapping off the module tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mridc_tpu_torch.models.base import BaseReconModel, ModelOutput, check_dc_mode, drawn, expand_mask
from mridc_tpu_torch.models.multitask.blocks import KSpaceDC, UnetDecoder, UnetEncoder, apply_group_norm
from mridc_tpu_torch.nn.convlstm import ConvLSTMNormUnet
from mridc_tpu_torch.nn.layers import ConvNonlinear, as_torch_dtype
from mridc_tpu_torch.nn.rim import RIMBlock
from mridc_tpu_torch.nn.seg_blocks import AttentionGate, AttentionUnet, LambdaUnet, VNet, name_unet
from mridc_tpu_torch.nn.unet import Unet
from mridc_tpu_torch.ops.cplx import cabs, ccombine
from mridc_tpu_torch.ops.fft import fft2_rv, ifft2_rv
from mridc_tpu_torch.parallel.mesh import joined_amax

__all__ = ["MTLRS", "IDSLR", "IDSLRUNet", "SegNet", "RecSegUNet", "SERANet", "SERANetDC"]


def _norm_by_max(s: torch.Tensor) -> torch.Tensor:
    """``s / max(s)`` by the SIGNED maximum of the whole tensor (of the
    processes' joined batch across processes: ``parallel/mesh.py``), 1 where
    |max| < 1e-12."""
    m = joined_amax(s)
    return s / torch.where(torch.abs(m) < 1e-12, torch.ones_like(m), m)


def _group_norm_nograd(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """:func:`apply_group_norm` of x in float32 (channel groups over the last
    axis), without a gradient."""
    with torch.no_grad():
        return apply_group_norm(x.float(), groups)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _stack_group_norm(s: torch.Tensor, groups: int, magnitude: bool) -> torch.Tensor:
    """An encoder feature (NCHW) group-normed without a gradient, |.| with
    ``magnitude``."""
    s = _group_norm_nograd(_nhwc(s), groups)
    return _nchw(torch.abs(s) if magnitude else s)


def _coils_to_channels(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W, 2] -> [B, H, W, 2C], channels (re coils..., im coils...)."""
    return torch.cat([x[..., 0], x[..., 1]], dim=1).permute(0, 2, 3, 1)


def _channels_to_coils(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_coils_to_channels`."""
    x = x.permute(0, 3, 1, 2)
    c = x.shape[1] // 2
    return torch.stack([x[:, :c], x[:, c:]], dim=-1)


def _channels_last(module: nn.Module) -> nn.Module:
    """Conv weights in the layout of the activations (NHWC, NDHWC)."""
    with torch.no_grad():
        for prm in module.parameters():
            if prm.ndim in (4, 5):
                prm.data = prm.data.contiguous(memory_format=torch.channels_last if prm.ndim == 4
                                               else torch.channels_last_3d)
    return module


def _named(module: nn.Module, scope: str) -> nn.Module:
    module.flax_scope = scope
    return module


def _seg_trunk(kind: str, in_chans: int, classes: int, chans: int, pools: int, live_bn: bool = False):
    """The segmentation head of MTLRS's ``segmentation_module`` (float32)."""
    kind = str(kind).lower()
    if kind == "unet":
        return name_unet(Unet(in_chans, classes, chans, pools))
    if kind == "attentionunet":
        return AttentionUnet(in_chans, classes, chans, pools)
    if kind == "lambdaunet":
        return LambdaUnet(in_chans, classes, chans, pools, live_bn=live_bn)
    if kind == "vnet":
        return VNet(in_chans, classes, live_bn=live_bn)
    raise ValueError(f"Unknown segmentation module {kind!r}")


def _base_cfg(cfg):
    return dict(fft_centered=cfg.get("fft_centered", False),
                fft_normalization=cfg.get("fft_normalization", "backward"),
                spatial_dims=tuple(cfg.get("spatial_dims", (-2, -1))), coil_dim=cfg.get("coil_dim", 1),
                coil_combination_method=str(cfg.get("coil_combination_method", "SENSE")).upper())


class MTLRS(BaseReconModel):
    """Multi-task learning for MRI reconstruction and segmentation (module
    docstring); config fields and defaults as in the JAX package.
    ``lane_fold`` is a TPU layout, accepted and ignored."""

    def __init__(self, rs_cascades: int = 5, recon_num_cascades: int = 1, recon_time_steps: int = 8,
                 recon_recurrent_layer: str = "IndRNN", recon_conv_filters: Sequence[int] = (64, 64, 2),
                 recon_recurrent_filters: Sequence[int] = (64, 64, 0), seg_module: str = "attentionunet",
                 live_bn: bool = False, seg_classes: int = 2, seg_channels: int = 32, seg_pools: int = 2,
                 input_channels: int = 2, magnitude_input: bool = False, normalize_segmentation_output: bool = True,
                 task_adaption_type: str = "multi_task_learning", dc_mode: str = "full", compute_dtype=None,
                 lane_fold: str = "auto", train_dc_dtype=None, infer_dc_dtype=None, fft_centered: bool = False,
                 fft_normalization: str = "backward", spatial_dims: Sequence[int] = (-2, -1), coil_dim: int = 1,
                 coil_combination_method: str = "SENSE", generator: Optional[torch.Generator] = None):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        del lane_fold
        if input_channels == 2 and magnitude_input:
            raise ValueError("Magnitude input is not supported for 2-channel input "
                             "(reference mtlrs_base/mtlrs_block.py:312)")
        self.recon_num_cascades = recon_num_cascades
        self.seg_classes = seg_classes
        self.seg_in_chans = 1 if (input_channels == 1 or magnitude_input) else 2
        self.normalize_segmentation_output = normalize_segmentation_output
        self.task_adaption = task_adaption_type == "multi_task_learning"
        self.live_bn = live_bn
        self.train_dc_dtype = as_torch_dtype(train_dc_dtype)
        self.infer_dc_dtype = as_torch_dtype(infer_dc_dtype)
        block_cfg = dict(recurrent_layer=recon_recurrent_layer, conv_filters=tuple(recon_conv_filters),
                         recurrent_filters=tuple(recon_recurrent_filters), time_steps=recon_time_steps, no_dc=True,
                         fft_centered=fft_centered, fft_normalization=fft_normalization,
                         spatial_dims=tuple(spatial_dims), coil_dim=coil_dim, compute_dtype=compute_dtype,
                         dc_psf1d=check_dc_mode(dc_mode) == "psf1d", remat="step")
        with torch.device("meta"):
            self.rim_blocks = nn.ModuleList([RIMBlock(**block_cfg) for _ in range(rs_cascades * recon_num_cascades)])
        self.rim_blocks.to_empty(device="cpu")
        self.seg_heads = nn.ModuleList()
        for i in range(rs_cascades):  # flax's creation order: a block's cascades, then its head
            for block in self.rim_blocks[i * recon_num_cascades:(i + 1) * recon_num_cascades]:
                block.reset_parameters(generator)
            head = drawn(lambda: _seg_trunk(seg_module, self.seg_in_chans, seg_classes, seg_channels, seg_pools,
                                            live_bn), generator)
            self.seg_heads.append(_named(head, f"{type(head).__name__}_{i}"))
        _channels_last(self)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(
            dc_mode=str(cfg.get("dc_mode", "full")).lower(),
            compute_dtype=cfg.get("compute_dtype", None),
            lane_fold=str(cfg.get("lane_fold", "auto")).lower(),
            train_dc_dtype=cfg["train_dc_dtype"] if "train_dc_dtype" in cfg else cfg.get("compute_dtype"),
            infer_dc_dtype=cfg["infer_dc_dtype"] if "infer_dc_dtype" in cfg else cfg.get("compute_dtype"),
            rs_cascades=cfg.get("joint_reconstruction_segmentation_module_cascades", 5),
            recon_num_cascades=cfg.get("reconstruction_module_num_cascades", 1),
            recon_time_steps=cfg.get("reconstruction_module_time_steps", 8),
            recon_recurrent_layer=cfg.get("reconstruction_module_recurrent_layer", "IndRNN"),
            recon_conv_filters=tuple(cfg.get("reconstruction_module_conv_filters", (64, 64, 2))),
            recon_recurrent_filters=tuple(cfg.get("reconstruction_module_recurrent_filters", (64, 64, 0))),
            seg_module=cfg.get("segmentation_module", "attentionunet"),
            live_bn=bool(cfg.get("train_batch_stats", False)),
            seg_classes=cfg.get("segmentation_module_output_channels", 2),
            seg_channels=cfg.get("segmentation_module_channels", 32),
            seg_pools=cfg.get("segmentation_module_pooling_layers", 2),
            input_channels=cfg.get("segmentation_module_input_channels", 2),
            magnitude_input=cfg.get("magnitude_input", False),
            normalize_segmentation_output=cfg.get("normalize_segmentation_output", True),
            task_adaption_type=cfg.get("task_adaption_type", "multi_task_learning"),
            generator=generator, **_base_cfg(cfg))

    def _segment(self, head: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = _nchw(x)
        if train and not self.live_bn and torch.is_grad_enabled():
            return _nhwc(checkpoint(head, x, train, use_reentrant=False))
        return _nhwc(head(x, train))

    def _adapt(self, hx, eta: torch.Tensor, seg: torch.Tensor):
        """Each hidden state (NHWC) plus |recon x seg| tiled over its channels,
        zero-padded and cut to its width, in its dtype."""
        shared = torch.abs(cabs(eta)[..., None] * seg)
        out = []
        for h_ in hx:
            width = h_.shape[-1]
            tiled = shared.repeat(1, 1, 1, max(width // self.seg_classes, 1))
            if tiled.shape[-1] < width:
                tiled = F.pad(tiled, (0, width - tiled.shape[-1]))
            out.append(h_ + tiled[..., :width].to(h_.dtype))
        return tuple(out)

    def forward(self, y, sens, mask, init_pred=None, train: bool = False):
        y, sens = y.contiguous(), sens.contiguous()
        mask = expand_mask(mask)
        b, _, h, w, _ = y.shape
        mask = torch.broadcast_to(mask, (b, 1, h, w)).to(y.dtype).contiguous()
        dc_dtype = self.train_dc_dtype if train else self.infer_dc_dtype
        # a given init prediction starts every cascade of the first block; else
        # cascade 0 SENSE-inits in its block and later ones start from the
        # previous estimate, detached; a block's last estimate starts every
        # cascade of the next block, with its gradient
        init_eta = init_pred if (init_pred is not None and init_pred.ndim >= 4) else None
        hx, seg, eta, recons = None, None, None, []
        c_per = self.recon_num_cascades
        for i, head in enumerate(self.seg_heads):
            etas = []
            for c, block in enumerate(self.rim_blocks[i * c_per:(i + 1) * c_per]):
                eta_in = init_eta if init_eta is not None else (None if c == 0 else eta.detach())
                step_etas, eta, hx = block(y, sens, mask, eta=eta_in, hx=hx, return_hx=True, dc_dtype=dc_dtype)
                etas.append(step_etas)
            init_eta = eta
            recons.append(torch.stack(etas, 0))  # [C, T, B, H, W, 2]
            seg_in = cabs(eta)[..., None] if self.seg_in_chans == 1 else eta
            seg = torch.abs(self._segment(head, _group_norm_nograd(seg_in), train))
            if self.normalize_segmentation_output:
                seg = _norm_by_max(seg)
            if self.task_adaption:
                hx = self._adapt(hx, eta, seg)
        return ModelOutput(prediction=eta, intermediates=torch.cat(recons, 0)), seg


class _DataWidthModel(BaseReconModel):
    """A model whose modules are built at the data's width (module
    docstring): subclasses give ``_width(coils)`` (the in-channels of
    ``width_key``'s conv, flax's ``width_leaf``) and ``_build(width,
    generator)``."""

    width_key = ""
    width_leaf = ""

    def __init__(self, fft_centered=False, fft_normalization="backward", spatial_dims=(-2, -1), coil_dim=1,
                 coil_combination_method="SENSE", generator: Optional[torch.Generator] = None):
        super().__init__(fft_centered, fft_normalization, spatial_dims, coil_dim, coil_combination_method)
        self.register_buffer("_anchor", torch.empty(0), persistent=False)  # the model's device
        self._generator_state = None if generator is None else generator.get_state()
        self.width = None

    def _width(self, coils: int) -> int:
        return 2 * int(coils)

    def _build(self, width: int, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    @property
    def materialized(self) -> bool:
        return self.width is not None

    def materialize(self, coils: int, device=None) -> None:
        """Build the modules for k-space of ``coils`` coils (weights from the
        build's generator, on ``device`` or the model's); a built model
        checks the width instead."""
        self._materialize_width(self._width(coils), device)

    def _materialize_width(self, width: int, device=None) -> None:
        if self.materialized:
            if width != self.width:
                raise ValueError(f"{type(self).__name__} was built for {self.width} input channels, the data gives "
                                 f"{width}")
            return
        generator = None
        if self._generator_state is not None:
            generator = torch.Generator()
            generator.set_state(self._generator_state)
        self._build(int(width), generator)
        self.width = int(width)
        _channels_last(self.to(device=device if device is not None else self._anchor.device))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        if not self.materialized:
            self._materialize_width(int(state_dict[self.width_key].shape[1]))
        return super().load_state_dict(state_dict, strict=strict, assign=assign)


class IDSLR(_DataWidthModel):
    """Image-domain deep structured low-rank network: a shared U-Net encoder,
    the reconstruction decoder and the k-space DC each iteration, then the
    segmentation decoder on the last encoder stack (group-normed without a
    gradient); IDSLRUNet segments the last coil-channelised image with a
    full U-Net instead."""

    seg_head_kind = "decoder"
    width_key = "encoder.blocks.0.layers.0.weight"
    width_leaf = "UnetEncoder_0/ConvBlock_0/Conv_0/kernel"

    def __init__(self, num_iters: int = 5, chans: int = 32, num_pools: int = 4, seg_classes: int = 2,
                 magnitude_input: bool = True, norm_groups: int = 2, normalize: bool = True, padding: bool = True,
                 padding_size: int = 11, normalize_segmentation_output: bool = True, compute_dtype=None,
                 generator: Optional[torch.Generator] = None, **base):
        super().__init__(generator=generator, **base)
        self.num_iters, self.chans, self.num_pools, self.seg_classes = num_iters, chans, num_pools, seg_classes
        self.magnitude_input, self.norm_groups, self.normalize, self.padding = (magnitude_input, norm_groups,
                                                                                 normalize, padding)
        self.padding_size, self.normalize_segmentation_output = padding_size, normalize_segmentation_output
        self.compute_dtype = compute_dtype

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(compute_dtype=cfg.get("compute_dtype"), num_iters=cfg.get("num_iters", 5),
                   chans=cfg.get("channels", cfg.get("segmentation_module_channels", 32)),
                   num_pools=cfg.get("num_pools", cfg.get("segmentation_module_pooling_layers", 4)),
                   seg_classes=cfg.get("segmentation_module_output_channels", 2),
                   magnitude_input=cfg.get("magnitude_input", True), norm_groups=cfg.get("norm_groups", 2),
                   normalize=cfg.get("normalize", True), padding=cfg.get("padding", True),
                   padding_size=cfg.get("padding_size", 11),
                   normalize_segmentation_output=cfg.get("normalize_segmentation_output", True), generator=generator,
                   **_base_cfg(cfg))

    def _codec(self):
        return dict(chans=self.chans, num_pools=self.num_pools, normalize=self.normalize, padding=self.padding,
                    norm_groups=self.norm_groups, dtype=self.compute_dtype)

    def _build(self, width, generator):
        kw = self._codec()
        self.encoder = _named(drawn(lambda: UnetEncoder(width, padding_size=self.padding_size, **kw), generator),
                              "UnetEncoder_0")
        self.recon_decoder = _named(drawn(lambda: UnetDecoder(width, **kw), generator), "UnetDecoder_0")
        if self.seg_head_kind == "unet":
            self.seg_head = _named(drawn(lambda: name_unet(Unet(width, self.seg_classes, self.chans, self.num_pools,
                                                                dtype=self.compute_dtype)), generator), "Unet_0")
        else:
            self.seg_head = _named(drawn(lambda: UnetDecoder(self.seg_classes, **kw), generator), "UnetDecoder_1")
        self.dc = _named(KSpaceDC(), "KSpaceDC_0")

    def forward(self, y, sens, mask, init_pred=None, train: bool = False):
        del init_pred
        self.materialize(y.shape[1], y.device)
        mask = expand_mask(mask)
        c, n, sd = self.fft_centered, self.fft_normalization, self.spatial_dims
        y_pred, stack, pad_sizes = y, None, None
        for _ in range(self.num_iters):
            img = ifft2_rv(y_pred, c, n, sd)
            stack, pad_sizes, mean, std = self.encoder(_coils_to_channels(img), train)
            recon = _channels_to_coils(self.recon_decoder(stack, pad_sizes, mean, std, train)) + img
            y_pred = self.dc(fft2_rv(recon, c, n, sd), y, mask)
        image = ifft2_rv(y_pred, c, n, sd)
        prediction = ccombine(image, sens, self.coil_combination_method, self.coil_dim)
        if self.seg_head_kind == "unet":
            seg_in = _group_norm_nograd(_coils_to_channels(image), self.norm_groups)
            if self.magnitude_input:
                seg_in = torch.abs(seg_in)
            seg = _nhwc(self.seg_head(_nchw(seg_in), train))
        else:
            seg_stack = [_stack_group_norm(s, self.norm_groups, self.magnitude_input) for s in stack]
            seg = self.seg_head(seg_stack, pad_sizes, None, None, train)
        seg = torch.abs(seg)
        if self.normalize_segmentation_output:
            seg = _norm_by_max(seg)
        return ModelOutput(prediction=prediction), seg


class IDSLRUNet(IDSLR):
    """IDSLR with a full U-Net as the segmentation head."""

    seg_head_kind = "unet"


class SegNet(_DataWidthModel):
    """Per-iteration encoder, segmentation decoder and reconstruction decoder
    (no residual), one shared k-space DC, and a replicate-padded conv over
    the concatenated segmentations."""

    width_key = "encoders.0.blocks.0.layers.0.weight"
    width_leaf = "UnetEncoder_0/ConvBlock_0/Conv_0/kernel"

    def __init__(self, num_iters: int = 2, chans: int = 32, num_pools: int = 4, seg_classes: int = 2,
                 norm_groups: int = 2, normalize: bool = False, padding: bool = False, padding_size: int = 11,
                 magnitude_input: bool = True, seg_final_kernel: int = 3, seg_final_bias: bool = False,
                 seg_final_nonlinear: str = "relu", normalize_segmentation_output: bool = True, compute_dtype=None,
                 generator: Optional[torch.Generator] = None, **base):
        super().__init__(generator=generator, **base)
        self.num_iters, self.chans, self.num_pools, self.seg_classes = num_iters, chans, num_pools, seg_classes
        self.norm_groups, self.normalize, self.padding, self.padding_size = norm_groups, normalize, padding, \
            padding_size
        self.magnitude_input = magnitude_input
        self.final_cfg = (seg_final_kernel, seg_final_bias, seg_final_nonlinear)
        self.normalize_segmentation_output = normalize_segmentation_output
        self.compute_dtype = compute_dtype

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(compute_dtype=cfg.get("compute_dtype"), num_iters=cfg.get("num_cascades", cfg.get("num_iters", 2)),
                   chans=cfg.get("channels", cfg.get("segmentation_module_channels", 32)),
                   num_pools=cfg.get("num_pools", cfg.get("segmentation_module_pooling_layers", 4)),
                   seg_classes=cfg.get("segmentation_module_output_channels", 2),
                   norm_groups=cfg.get("norm_groups", 2), normalize=cfg.get("normalize", False),
                   padding=cfg.get("padding", False), padding_size=cfg.get("padding_size", 11),
                   magnitude_input=cfg.get("magnitude_input", True),
                   seg_final_kernel=cfg.get("segmentation_final_layer_kernel_size", 3),
                   seg_final_bias=cfg.get("segmentation_final_layer_bias", False),
                   seg_final_nonlinear=cfg.get("segmentation_final_layer_nonlinear", "relu"),
                   normalize_segmentation_output=cfg.get("normalize_segmentation_output", True), generator=generator,
                   **_base_cfg(cfg))

    def _build(self, width, generator):
        kw = dict(chans=self.chans, num_pools=self.num_pools, normalize=self.normalize, padding=self.padding,
                  norm_groups=self.norm_groups, dtype=self.compute_dtype)
        self.encoders, self.seg_decoders, self.recon_decoders = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for i in range(self.num_iters):
            self.encoders.append(_named(drawn(lambda: UnetEncoder(width, padding_size=self.padding_size, **kw),
                                              generator), f"UnetEncoder_{i}"))
            self.seg_decoders.append(_named(drawn(lambda: UnetDecoder(self.seg_classes, **kw), generator),
                                            f"UnetDecoder_{2 * i}"))
            self.recon_decoders.append(_named(drawn(lambda: UnetDecoder(width, **kw), generator),
                                              f"UnetDecoder_{2 * i + 1}"))
        self.dc = _named(KSpaceDC(), "KSpaceDC_0")
        kernel, bias, nonlinear = self.final_cfg
        self.final = _named(drawn(lambda: ConvNonlinear(self.num_iters * self.seg_classes, self.seg_classes, kernel,
                                                        1, bias, nonlinear, dtype=self.compute_dtype), generator),
                            "ConvNonlinear_0")
        self.final.conv_layer.flax_scope = "Conv_0"

    def forward(self, y, sens, mask, init_pred=None, train: bool = False):
        del init_pred
        self.materialize(y.shape[1], y.device)
        mask = expand_mask(mask)
        c, n, sd = self.fft_centered, self.fft_normalization, self.spatial_dims
        y_pred, segs = y, []
        for encoder, seg_decoder, recon_decoder in zip(self.encoders, self.seg_decoders, self.recon_decoders):
            img = ifft2_rv(y_pred, c, n, sd)
            stack, pad_sizes, mean, std = encoder(_coils_to_channels(img), train)
            seg_stack = [_stack_group_norm(s, self.norm_groups, self.magnitude_input) for s in stack]
            segs.append(seg_decoder(seg_stack, pad_sizes, None, None, train))
            recon = _channels_to_coils(recon_decoder(stack, pad_sizes, mean, std, train))
            y_pred = self.dc(fft2_rv(recon, c, n, sd), y, mask)
        image = ifft2_rv(y_pred, c, n, sd)
        prediction = ccombine(image, sens, self.coil_combination_method, self.coil_dim)
        segs.append(_nhwc(self.final(_nchw(torch.cat(segs, dim=-1)))).float())
        if self.normalize_segmentation_output:
            segs = [_norm_by_max(s) for s in segs]
        if train:
            return ModelOutput(prediction=prediction), torch.stack(segs, 0)
        return ModelOutput(prediction=prediction), segs[-1]


class RecSegUNet(BaseReconModel):
    """A reconstruction U-Net on the zero-filled image (or the initial
    prediction), then a segmentation U-Net on its output group-normed without
    a gradient."""

    def __init__(self, recon_chans: int = 64, recon_pools: int = 2, seg_chans: int = 64, seg_pools: int = 2,
                 seg_classes: int = 2, input_channels: int = 1, normalize_segmentation_output: bool = True,
                 compute_dtype=None, generator: Optional[torch.Generator] = None, **base):
        super().__init__(**base)
        self.input_channels = input_channels
        self.normalize_segmentation_output = normalize_segmentation_output
        width = 1 if input_channels == 1 else 2
        self.recon_unet = _named(drawn(lambda: name_unet(Unet(width, width, recon_chans, recon_pools,
                                                              dtype=compute_dtype)), generator), "Unet_0")
        self.seg_unet = _named(drawn(lambda: name_unet(Unet(width, seg_classes, seg_chans, seg_pools,
                                                            dtype=compute_dtype)), generator), "Unet_1")
        _channels_last(self)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(compute_dtype=cfg.get("compute_dtype"), recon_chans=cfg.get("reconstruction_module_channels", 64),
                   recon_pools=cfg.get("reconstruction_module_pooling_layers", 2),
                   seg_chans=cfg.get("segmentation_module_channels", 64),
                   seg_pools=cfg.get("segmentation_module_pooling_layers", 2),
                   seg_classes=cfg.get("segmentation_module_output_channels", 2),
                   input_channels=cfg.get("segmentation_module_input_channels", 1),
                   normalize_segmentation_output=cfg.get("normalize_segmentation_output", True), generator=generator,
                   **_base_cfg(cfg))

    def forward(self, y, sens, mask, init_pred=None, train: bool = False):
        del mask
        if init_pred is None or init_pred.ndim < 4:
            init_pred = self.zero_filled(y.contiguous(), sens.contiguous())
        x = cabs(init_pred)[..., None] if self.input_channels == 1 else init_pred
        recon = _nhwc(self.recon_unet(_nchw(x), train))
        seg = torch.abs(_nhwc(self.seg_unet(_nchw(_group_norm_nograd(recon)), train)))
        if self.normalize_segmentation_output:
            seg = _norm_by_max(seg)
        pred = recon[..., 0] if recon.shape[-1] == 1 else recon
        if pred.ndim == 3:
            pred = torch.stack([pred, torch.zeros_like(pred)], -1)
        return ModelOutput(prediction=pred), seg


class SERANetDC(nn.Module):
    """SERANet's soft DC: ifft(prev - where(m, F(pred) - y, 0) w - F(pred)),
    a single-coil prediction's k-space broadcast over the coils; SERANet
    feeds the image-domain previous output back as ``prev`` (the
    reference's quirk, kept)."""

    flax_params = {"dc_weight": "dc_weight"}

    def __init__(self, fft_centered: bool = False, fft_normalization: str = "backward",
                 spatial_dims: Sequence[int] = (-2, -1)):
        super().__init__()
        self.fft = (fft_centered, fft_normalization, tuple(spatial_dims))
        self.dc_weight = nn.Parameter(torch.ones(1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.dc_weight)

    def forward(self, prediction, prev_prediction, ref_kspace, mask):
        pred_k = fft2_rv(prediction, *self.fft)
        if pred_k.ndim < ref_kspace.ndim:
            pred_k = pred_k[:, None]
        soft_dc = torch.where(mask.bool(), pred_k - ref_kspace, torch.zeros((), dtype=pred_k.dtype,
                                                                            device=pred_k.device)) * self.dc_weight
        return ifft2_rv(prev_prediction - soft_dc - pred_k, *self.fft)


class SERANet(_DataWidthModel):
    """End-to-end recurrent attention network: a U-Net regulariser run once
    with ``num_blocks`` SERANet DCs, a ConvLSTMNormUnet segmentation of the
    coils' magnitudes (zero coils added up to ``seg_in_chans``), then
    ``num_iterations`` rounds of attention gate -> DC -> recurrent
    ConvLSTMNormUnet; the prediction is the second-last block's output
    combined over the coils."""

    width_key = "attention_gate.W_x.weight"
    width_leaf = "AttentionGate_0/Conv_0/kernel"

    def __init__(self, input_channels: int = 2, recon_out_chans: int = 2, recon_chans: int = 32,
                 recon_pools: int = 4, num_blocks: int = 3, seg_in_chans: int = 2, seg_classes: int = 2,
                 seg_chans: int = 32, seg_pools: int = 4, num_iterations: int = 2, attention_chans: int = 32,
                 attention_pools: int = 4, normalize_segmentation_output: bool = True, compute_dtype=None,
                 generator: Optional[torch.Generator] = None, **base):
        super().__init__(generator=generator, **base)
        del input_channels  # the regulariser takes the estimate's two channels, as flax infers them
        self.recon_cfg = (recon_out_chans, recon_chans, recon_pools)
        self.num_blocks, self.seg_in_chans, self.seg_classes = num_blocks, seg_in_chans, seg_classes
        self.seg_cfg, self.attention_cfg = (seg_chans, seg_pools), (attention_chans, attention_pools)
        self.num_iterations = num_iterations
        self.normalize_segmentation_output = normalize_segmentation_output
        self.compute_dtype = compute_dtype

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(compute_dtype=cfg.get("compute_dtype"), input_channels=cfg.get("input_channels", 2),
                   recon_out_chans=cfg.get("reconstruction_module_output_channels", 2),
                   recon_chans=cfg.get("reconstruction_module_channels", 32),
                   recon_pools=cfg.get("reconstruction_module_pooling_layers", 4),
                   num_blocks=cfg.get("reconstruction_module_num_blocks", 3),
                   seg_in_chans=cfg.get("segmentation_module_input_channels", 2),
                   seg_classes=cfg.get("segmentation_module_output_channels", 2),
                   seg_chans=cfg.get("segmentation_module_channels", 32),
                   seg_pools=cfg.get("segmentation_module_pooling_layers", 4),
                   num_iterations=cfg.get("recurrent_module_iterations", cfg.get("num_iterations", 2)),
                   attention_chans=cfg.get("recurrent_module_attention_channels", 32),
                   attention_pools=cfg.get("recurrent_module_attention_pooling_layers", 4),
                   normalize_segmentation_output=cfg.get("normalize_segmentation_output", True), generator=generator,
                   **_base_cfg(cfg))

    def _width(self, coils: int) -> int:
        return 2 * max(int(coils), self.seg_in_chans)

    def _build(self, width, generator):
        out, chans, pools = self.recon_cfg
        dt, fft = self.compute_dtype, (self.fft_centered, self.fft_normalization, self.spatial_dims)
        coils = width // 2
        self.regularizer = _named(drawn(lambda: name_unet(Unet(2, out, chans, pools, dtype=dt)), generator), "Unet_0")
        self.dcs = nn.ModuleList([_named(SERANetDC(*fft), f"SERANetDC_{i}") for i in range(self.num_blocks)])
        self.segmentation = _named(drawn(lambda: ConvLSTMNormUnet(*self.seg_cfg, in_chans=coils,
                                                                  out_chans=self.seg_classes, dtype=dt), generator),
                                   "ConvLSTMNormUnet_0")
        self.attention_gate = _named(drawn(lambda: AttentionGate(width, self.seg_classes, self.seg_classes),
                                           generator), "AttentionGate_0")
        self.recurrent = _named(drawn(lambda: ConvLSTMNormUnet(*self.attention_cfg, in_chans=width,
                                                               out_chans=self.seg_classes, dtype=dt), generator),
                                "ConvLSTMNormUnet_1")
        self.refine_dc = _named(SERANetDC(*fft), f"SERANetDC_{self.num_blocks}")

    def forward(self, y, sens, mask, init_pred=None, train: bool = False):
        self.materialize(y.shape[1], y.device)
        m = expand_mask(mask)[..., None]  # [B, 1, H, W, 1]
        y, sens = y.contiguous(), sens.contiguous()
        pred0 = init_pred if (init_pred is not None and init_pred.ndim >= 4) else self.sense_init(y, sens)
        # the regulariser runs once: the reference stacks the same instance on
        # the same input; only the per-block DC weights differ
        unet_recon = _nhwc(self.regularizer(_nchw(pred0), train))
        recons, prev = [], y
        for dc in self.dcs:
            prev = dc(unet_recon, prev, y, m)
            recons.append(prev)  # [B, C, H, W, 2]
        pred_recon = recons[-2] if len(recons) > 1 else recons[-1]

        seg_in = cabs(_group_norm_nograd(recons[-1]))  # [B, C, H, W]
        pad = self.seg_in_chans - seg_in.shape[1]
        if pad > 0:  # zero coils up to the segmentation's input width
            seg_in = F.pad(seg_in, (0, 0, 0, 0, 0, pad))
            pred_recon, y, sens = (F.pad(t, (0, 0, 0, 0, 0, 0, 0, pad)) for t in (pred_recon, y, sens))
        segmentation = self.segmentation(seg_in.permute(0, 2, 3, 1), train)  # [B, H, W, classes]

        attention_map, prev = segmentation, y
        for _ in range(self.num_iterations):
            gated = _nhwc(self.attention_gate(_nchw(_coils_to_channels(pred_recon)),
                                              _nchw(attention_map * segmentation)))
            att = self.refine_dc(_channels_to_coils(gated), prev, y, m)
            prev = att
            attention_map = self.recurrent(_coils_to_channels(att), train)
        pred_segmentation = torch.abs(attention_map)
        if self.normalize_segmentation_output:
            pred_segmentation = _norm_by_max(pred_segmentation)
        return ModelOutput(prediction=ccombine(pred_recon, sens, self.coil_combination_method, self.coil_dim)), \
            pred_segmentation
