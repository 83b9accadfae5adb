"""Carry weights from the JAX package into the port.

:func:`varnet_params_from_jax` and :func:`normunet_params_from_jax` are the
inverses of ``import_varnet_params`` and ``import_normunet_params``: flax's
``_VarNetBlock_{i}/{dc_weight, NormUnet_0/Unet_0/...}`` to the reference torch
names (``cascades.{i}.dc_weight``, ``cascades.{i}.model.unet...``). flax
numbers a Unet's ``ConvBlock_k`` in creation order (the down blocks, the
bottleneck, the up blocks), its ``TransposeConvBlock_i`` from the bottom up,
and the final 1x1 conv is ``Conv_0``. Every leaf is used once: a leaf left
over or missing raises.

:func:`cirim_params_from_jax` is the inverse of
``mridc_tpu/utils/torch_import.py:import_cirim_params``: it takes a flax CIRIM
param tree (numpy arrays) and returns the port's ``state_dict``, whose keys are
the reference torch names that importer reads.

:func:`unet_params_from_jax` takes the UNet model's ``NormUnet_0/Unet_0`` to
``unet.unet...``; :func:`resnet_params_from_jax` takes ResNet's
``ResidualNetwork_0/Conv_k`` (flax's creation order: Conv_0 the first conv,
per block Conv_{2i+1} the outer and Conv_{2i+2} the inner conv, then the last
two; the reference's ``conv1``, ``layers2.{i}``, ``layers1.{i}``,
``last_layer``, ``final_layer``, as ``mridc_tpu``'s
``import_residual_network_params`` reads them) and the CG weight ``mu``,
which is all ProximalGradient has.

The flax scope names depend on ``remat_mode``: a rematerialised scan is named
``ScanCheckpoint_*``, a plain one ``Scan_*`` — ``step+cascade`` gives
``ScanCheckpoint_Cascade_0/RIMBlock_0/ScanCheckpoint_RIMStep_0``, ``none``
gives ``Scan_Cascade_0/RIMBlock_0/Scan_RIMStep_0``, ``step`` and ``cascade``
mix the two. Every leaf carries a leading cascade axis; the soft-DC
``dc_weight`` lives at ``RIMBlock_0``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["cirim_params_from_jax", "rim_block_params_from_jax", "normunet_params_from_jax", "varnet_params_from_jax",
           "unet_params_from_jax", "resnet_params_from_jax", "hwio_to_oihw", "hwio_to_iohw_flipped"]

_CELL_SCOPE = re.compile(r"^(IndRNNCell|ConvGRUCell|ConvMGUCell)_(\d+)$")


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def hwio_to_iohw_flipped(w: np.ndarray) -> np.ndarray:
    """flax ``ConvTranspose`` (kH, kW, in, out), applied unflipped -> torch
    ``ConvTranspose2d`` (in, out, kH, kW), which flips its kernel: transposed
    and reversed along both spatial axes."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 0, 1))[..., ::-1, ::-1])


def _one_of(tree: Mapping, names, what: str):
    for n in names:
        if n in tree:
            return tree[n]
    raise KeyError(f"{what}: none of {list(names)} in the param tree (keys: {sorted(tree)})")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _block_state(block: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """State of one RIM block from its flax subtree (``RIMBlock_0`` contents,
    leaves without the cascade axis)."""
    step = _one_of(block, ("ScanCheckpoint_RIMStep_0", "Scan_RIMStep_0"), "RIMBlock_0")
    cells = sorted(
        ((int(m.group(2)), name) for name in step if (m := _CELL_SCOPE.match(name))),
    )
    state: Dict[str, torch.Tensor] = {}
    for h, name in cells:
        conv = step[f"ConvNonlinear_{h}"]["Conv_0"]
        state[f"{prefix}layers.{h}.convs.conv_layer.weight"] = _t(hwio_to_oihw(conv["kernel"]))
        if "bias" in conv:
            state[f"{prefix}layers.{h}.convs.conv_layer.bias"] = _t(conv["bias"])
        cell = step[name]
        ih = cell["Conv_0"]
        state[f"{prefix}layers.{h}.rnn.ih.weight"] = _t(hwio_to_oihw(ih["kernel"]))
        if "bias" in ih:
            state[f"{prefix}layers.{h}.rnn.ih.bias"] = _t(ih["bias"])
        if name.startswith("IndRNNCell"):
            state[f"{prefix}layers.{h}.rnn.hh"] = _t(np.transpose(np.asarray(cell["hh"]), (0, 3, 1, 2)))
        else:
            state[f"{prefix}layers.{h}.rnn.hh.weight"] = _t(hwio_to_oihw(cell["Conv_1"]["kernel"]))
    final = step[f"ConvNonlinear_{len(cells)}"]["Conv_0"]
    state[f"{prefix}final_layer.0.conv_layer.weight"] = _t(hwio_to_oihw(final["kernel"]))
    if "bias" in final:
        state[f"{prefix}final_layer.0.conv_layer.bias"] = _t(final["bias"])
    if "dc_weight" in block:
        state[f"{prefix}dc_weight"] = _t(block["dc_weight"])
    return state


def _unwrap(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def rim_block_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.nn.rim.RIMBlock` state from a flax
    ``RIMBlock`` param tree (as ``RIMBlock(...).init`` returns it)."""
    return _block_state(_unwrap(tree), "")


def cirim_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port CIRIM ``state_dict`` from a flax CIRIM param tree of any
    ``remat_mode`` (with or without the top-level ``"params"`` key)."""
    cascade = _one_of(_unwrap(tree), ("ScanCheckpoint_Cascade_0", "Scan_Cascade_0"), "CIRIM params")
    block = cascade["RIMBlock_0"]
    n = int(np.asarray(_one_of(block, ("ScanCheckpoint_RIMStep_0", "Scan_RIMStep_0"), "RIMBlock_0")
                       ["ConvNonlinear_0"]["Conv_0"]["kernel"]).shape[0])

    def slice_tree(node, i):
        if isinstance(node, Mapping):
            return {k: slice_tree(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    state: Dict[str, torch.Tensor] = {}
    for i in range(n):
        state.update(_block_state(slice_tree(block, i), f"cirim.{i}."))
    return state


class _Leaves:
    """A flax subtree's leaves by path; :meth:`take` hands each out once and
    :meth:`done` raises on any left over."""

    def __init__(self, tree: Mapping, what: str):
        self.what = what
        self.leaves: Dict[str, np.ndarray] = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, Mapping):
                    walk(v, f"{path}{k}/")
                else:
                    self.leaves[f"{path}{k}"] = np.asarray(v)

        walk(tree, "")

    def has(self, path: str) -> bool:
        return path in self.leaves

    def take(self, path: str) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"{self.what}: leaf {path!r} missing from the param tree")
        return self.leaves.pop(path)

    def done(self) -> None:
        if self.leaves:
            raise KeyError(f"{self.what}: leaves not used: {sorted(self.leaves)}")


def _normunet_state(leaves: _Leaves, base: str, prefix: str) -> Dict[str, torch.Tensor]:
    pools = 0
    while leaves.has(f"{base}TransposeConvBlock_{pools}/ConvTranspose_0/kernel"):
        pools += 1
    if pools == 0:
        raise KeyError(f"{leaves.what}: no {base}TransposeConvBlock_0 in the param tree")
    state: Dict[str, torch.Tensor] = {}

    def block(k, name):
        for j, layer in ((0, 0), (1, 4)):
            state[f"{prefix}unet.{name}.layers.{layer}.weight"] = _t(
                hwio_to_oihw(leaves.take(f"{base}ConvBlock_{k}/Conv_{j}/kernel")))

    for i in range(pools):
        block(i, f"down_sample_layers.{i}")
    block(pools, "conv")
    for i in range(pools):
        state[f"{prefix}unet.up_transpose_conv.{i}.layers.0.weight"] = _t(
            hwio_to_iohw_flipped(leaves.take(f"{base}TransposeConvBlock_{i}/ConvTranspose_0/kernel")))
        block(pools + 1 + i, f"up_conv.{i}" if i < pools - 1 else f"up_conv.{i}.0")
    state[f"{prefix}unet.up_conv.{pools - 1}.1.weight"] = _t(hwio_to_oihw(leaves.take(f"{base}Conv_0/kernel")))
    state[f"{prefix}unet.up_conv.{pools - 1}.1.bias"] = _t(leaves.take(f"{base}Conv_0/bias"))
    return state


def normunet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.nn.unet.NormUnet` state from a flax
    ``NormUnet`` param tree (``{"Unet_0": ...}``, with or without ``"params"``)."""
    leaves = _Leaves(_unwrap(tree), "NormUnet params")
    state = _normunet_state(leaves, "Unet_0/", "")
    leaves.done()
    return state


def varnet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.models.recon.vn.VarNet` ``state_dict``
    from a flax VarNet param tree (either ``dc_mode``: they share it)."""
    leaves = _Leaves(_unwrap(tree), "VarNet params")
    state: Dict[str, torch.Tensor] = {}
    i = 0
    while leaves.has(f"_VarNetBlock_{i}/dc_weight"):
        state[f"cascades.{i}.dc_weight"] = _t(leaves.take(f"_VarNetBlock_{i}/dc_weight"))
        state.update(_normunet_state(leaves, f"_VarNetBlock_{i}/NormUnet_0/Unet_0/", f"cascades.{i}.model."))
        i += 1
    if i == 0:
        raise KeyError("VarNet params: no _VarNetBlock_0/dc_weight in the param tree")
    leaves.done()
    return state


def unet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.models.recon.unet.UNet` ``state_dict``
    from a flax UNet param tree (``{"NormUnet_0": {"Unet_0": ...}}``)."""
    leaves = _Leaves(_unwrap(tree), "UNet params")
    state = _normunet_state(leaves, "NormUnet_0/Unet_0/", "unet.")
    leaves.done()
    return state


def resnet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.models.recon.resnet.ResNet` (or
    ``ProximalGradient``) ``state_dict`` from a flax param tree: the residual
    network's convs where there are any, ``mu`` where there is one."""
    leaves = _Leaves(_unwrap(tree), "ResNet params")
    state: Dict[str, torch.Tensor] = {}
    if leaves.has("mu"):
        state["mu"] = _t(leaves.take("mu"))
    n = 0
    while leaves.has(f"ResidualNetwork_0/Conv_{n}/kernel"):
        n += 1
    if n:
        if n < 3 or n % 2 == 0:
            raise KeyError(f"ResNet params: {n} convs in ResidualNetwork_0, expected 2 * blocks + 3")
        blocks = (n - 3) // 2
        names = ["conv1"] + [f"layers{j}.{i}" for i in range(blocks) for j in (2, 1)] + ["last_layer", "final_layer"]
        for k, name in enumerate(names):
            state[f"residual_network.{name}.weight"] = _t(hwio_to_oihw(
                leaves.take(f"ResidualNetwork_0/Conv_{k}/kernel")))
    if not state:
        raise KeyError("ResNet params: neither ResidualNetwork_0 nor mu in the param tree")
    leaves.done()
    return state
