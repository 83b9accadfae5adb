"""Segmentation models (counterpart of ``mridc_tpu/models/segmentation``):
the U-Net, 3D U-Net, attention U-Net, lambda U-Net, V-Net, DynUNet and
UNETR wrappers.

Contract: ``model(image, train=False)`` with image [B, H, W, C_in] (NHWC:
the magnitude, 1 channel, or the complex real view, 2) -> logits [B, H, W,
classes], raw (``normalize_segmentation_output`` is accepted and, as in the
JAX package, not applied: the loss takes the sigmoid or softmax). DynUNet
with deep supervision returns [B, 1 + heads, H, W, classes] in train mode.
The 3D U-Net also takes a volume batch [B, D, H, W, C_in] (``volumetric``),
and takes a 4D batch as one volume whose depth is the batch (module
``nn.seg_blocks.UNet3D``).

The trunk's input width (and UNETR's patch count, which sizes its position
embeddings) follows the data, as flax infers them at ``init`` (the YAMLs'
``segmentation_module_input_channels`` is 2 while the magnitude input gives
1): the trunk is built by :meth:`materialize` (``SegmentationTrainer.
init_state`` calls it with its first batch), by ``load_state_dict`` from the
weights' shapes, or at the first forward, with weights drawn from the
generator the model was built with. The trunk is the flax scope
``{trunk class}_0`` of the JAX wrapper.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mridc_tpu_torch.models.base import drawn
from mridc_tpu_torch.nn.seg_blocks import UNETR, AttentionUnet, DynUNet, LambdaUnet, UNet3D, VNet, name_unet
from mridc_tpu_torch.nn.unet import Unet

__all__ = ["SegmentationUNet", "Segmentation3DUNet", "SegmentationAttentionUNet", "SegmentationLambdaUNet",
           "SegmentationVNet", "SegmentationDYNUNet", "SegmentationUNetR", "SegmentationModel"]


def _seg_cfg(cfg):
    """(classes, chans, pools) as the JAX package reads them: a channel list
    (DynUNet-style) gives its first entry and len - 1 pools."""
    chans = cfg.get("segmentation_module_channels", 32)
    pools = cfg.get("segmentation_module_pooling_layers", 4)
    if isinstance(chans, (list, tuple)):
        pools = max(len(chans) - 1, 1)
        chans = int(chans[0])
    return dict(classes=cfg.get("segmentation_module_output_channels", cfg.get("output_classes", 2)), chans=chans,
                pools=pools)


class SegmentationModel(nn.Module):
    """The wrapper of one trunk, built at the data's width (module docstring).
    Subclasses give ``_trunk(in_chans, num_patches)``."""

    volumetric = False  # takes [B, D, H, W, C] volumes as they are
    first_conv = ""  # the state-dict key (under ``trunk.``) whose weight gives the input width
    patch_param = None  # UNETR's position embeddings, which give the patch count

    def __init__(self, classes: int = 2, chans: int = 32, pools: int = 4, compute_dtype=None,
                 live_bn: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.classes, self.chans, self.pools = classes, chans, pools
        self.compute_dtype, self.live_bn = compute_dtype, live_bn
        self.trunk = None
        self.register_buffer("_anchor", torch.empty(0), persistent=False)  # the model's device
        self._generator_state = None if generator is None else generator.get_state()

    def _trunk(self, in_chans: int, num_patches: int) -> nn.Module:
        raise NotImplementedError

    @property
    def materialized(self) -> bool:
        return self.trunk is not None

    def materialize(self, image_shape: Sequence[int], device=None) -> None:
        """Build the trunk for images of ``image_shape`` ([..., H, W, C_in];
        weights from the build's generator, on ``device`` or the model's); a
        built model keeps its trunk."""
        if self.materialized:
            return
        h, w, in_chans = (int(v) for v in image_shape[-3:])
        self._build(in_chans, (h // 16) * (w // 16), device)

    def _build(self, in_chans: int, num_patches: int, device=None) -> None:
        generator = None
        if self._generator_state is not None:
            generator = torch.Generator()
            generator.set_state(self._generator_state)
        trunk = drawn(lambda: self._trunk(in_chans, num_patches), generator)
        trunk.flax_scope = f"{type(trunk).__name__}_0"
        trunk.to(device=device if device is not None else self._anchor.device)
        with torch.no_grad():  # conv weights in the layout of the activations (NHWC, NDHWC)
            for prm in trunk.parameters():
                if prm.ndim in (4, 5):
                    fmt = torch.channels_last if prm.ndim == 4 else torch.channels_last_3d
                    prm.data = prm.data.contiguous(memory_format=fmt)
        self.trunk = trunk

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        if not self.materialized:
            w = state_dict[f"trunk.{self.first_conv}"]
            pos = state_dict.get(f"trunk.{self.patch_param}") if self.patch_param else None
            self._build(int(w.shape[1]), 0 if pos is None else int(pos.shape[1]))
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        self.materialize(tuple(image.shape), image.device)
        if image.ndim == 5 and self.volumetric:
            x = image.permute(0, 4, 1, 2, 3)
        else:
            x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out = self.trunk(x, train)
        stacked = out.ndim == 5 and x.ndim == 4  # deep supervision [B, K, C, H, W]
        return out.movedim(2 if stacked else 1, -1)


class SegmentationUNet(SegmentationModel):
    """The fastMRI U-Net (``nn/unet.py:Unet``, flax's ``Unet_0``)."""

    first_conv = "down_sample_layers.0.layers.0.weight"

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(**_seg_cfg(cfg), compute_dtype=cfg.get("compute_dtype"), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return name_unet(Unet(in_chans, self.classes, self.chans, self.pools, dtype=self.compute_dtype))


class Segmentation3DUNet(SegmentationModel):
    volumetric = True
    first_conv = UNet3D.first_conv

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(**_seg_cfg(cfg), compute_dtype=cfg.get("compute_dtype"), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return UNet3D(in_chans, self.classes, self.chans, self.pools, dtype=self.compute_dtype)


class SegmentationAttentionUNet(SegmentationModel):
    first_conv = AttentionUnet.first_conv

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(**_seg_cfg(cfg), compute_dtype=cfg.get("compute_dtype"), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return AttentionUnet(in_chans, self.classes, self.chans, self.pools, dtype=self.compute_dtype)


class SegmentationLambdaUNet(SegmentationModel):
    first_conv = LambdaUnet.first_conv

    def __init__(self, query_depth: int = 16, intra_depth: int = 1, receptive_kernel: int = 3,
                 temporal_kernel: int = 1, num_slices: int = 1, **kw):
        super().__init__(**kw)
        self.lambda_kw = dict(query_depth=query_depth, intra_depth=intra_depth, receptive_kernel=receptive_kernel,
                              temporal_kernel=temporal_kernel, num_slices=num_slices)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(**_seg_cfg(cfg), compute_dtype=cfg.get("compute_dtype"),
                   query_depth=cfg.get("segmentation_module_query_depth", 16),
                   intra_depth=cfg.get("segmentation_module_intra_depth", 1),
                   receptive_kernel=cfg.get("segmentation_module_receptive_kernel", 3),
                   temporal_kernel=cfg.get("segmentation_module_temporal_kernel", 1),
                   num_slices=cfg.get("consecutive_slices", 1),
                   live_bn=bool(cfg.get("train_batch_stats", False)), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return LambdaUnet(in_chans, self.classes, self.chans, self.pools, live_bn=self.live_bn,
                          dtype=self.compute_dtype, **self.lambda_kw)


class SegmentationVNet(SegmentationModel):
    """V-Net at its fixed widths, elu, dropout 0.5 (the JAX wrapper sets no
    rate)."""

    first_conv = VNet.first_conv

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(**_seg_cfg(cfg), compute_dtype=cfg.get("compute_dtype"),
                   live_bn=bool(cfg.get("train_batch_stats", False)), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return VNet(in_chans, self.classes, live_bn=self.live_bn, dtype=self.compute_dtype)


class SegmentationDYNUNet(SegmentationModel):
    first_conv = DynUNet.first_conv

    def __init__(self, kernel_size=(3, 3, 3, 3), strides=(1, 2, 2, 2), filters=None, deep_supervision=False,
                 deep_supr_num: int = 1, **kw):
        super().__init__(**kw)
        self.dyn_kw = dict(kernel_size=tuple(kernel_size), strides=tuple(strides),
                           filters=None if filters is None else tuple(filters), deep_supervision=deep_supervision,
                           deep_supr_num=deep_supr_num)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        filters = cfg.get("segmentation_module_channels")
        strides = cfg.get("segmentation_module_strides", (1, 2, 2, 2))
        return cls(classes=_seg_cfg(cfg)["classes"], compute_dtype=cfg.get("compute_dtype"),
                   kernel_size=tuple(cfg.get("segmentation_module_kernel_size", (3,) * len(strides))),
                   strides=tuple(strides), filters=tuple(filters) if isinstance(filters, (list, tuple)) else None,
                   deep_supervision=cfg.get("segmentation_module_deep_supervision", False),
                   deep_supr_num=cfg.get("segmentation_module_deep_supervision_levels", 1), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return DynUNet(in_chans, self.classes, dtype=self.compute_dtype, **self.dyn_kw)


class SegmentationUNetR(SegmentationModel):
    first_conv, patch_param = UNETR.first_conv, UNETR.patch_param

    def __init__(self, hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12, pos_embed: str = "conv",
                 conv_block: bool = True, res_block: bool = True, qkv_bias: bool = False, **kw):
        super().__init__(**kw)
        self.unetr_kw = dict(hidden_size=hidden_size, mlp_dim=mlp_dim, num_heads=num_heads, pos_embed=pos_embed,
                             conv_block=conv_block, res_block=res_block, qkv_bias=qkv_bias)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None):
        return cls(classes=_seg_cfg(cfg)["classes"], compute_dtype=cfg.get("compute_dtype"),
                   chans=cfg.get("segmentation_module_channels", 64),
                   hidden_size=cfg.get("segmentation_module_hidden_size", 768),
                   mlp_dim=cfg.get("segmentation_module_mlp_dim", 3072),
                   num_heads=cfg.get("segmentation_module_num_heads", 12),
                   pos_embed=cfg.get("segmentation_module_pos_embed", "conv"),
                   conv_block=cfg.get("segmentation_module_conv_block", True),
                   res_block=cfg.get("segmentation_module_res_block", True),
                   qkv_bias=cfg.get("segmentation_module_qkv_bias", False), generator=generator)

    def _trunk(self, in_chans, num_patches):
        return UNETR(in_chans, self.classes, num_patches, feature_size=self.chans, dtype=self.compute_dtype,
                     **self.unetr_kw)
