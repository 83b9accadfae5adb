"""Carry weights from the JAX package into the port.

:func:`cirim_params_from_jax` is the inverse of
``mridc_tpu/utils/torch_import.py:import_cirim_params``: it takes a flax CIRIM
param tree (numpy arrays) and returns the port's ``state_dict``, whose keys are
the reference torch names that importer reads.

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

__all__ = ["cirim_params_from_jax", "rim_block_params_from_jax", "hwio_to_oihw"]

_CELL_SCOPE = re.compile(r"^(IndRNNCell|ConvGRUCell|ConvMGUCell)_(\d+)$")


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _one_of(tree: Mapping, names, what: str):
    for n in names:
        if n in tree:
            return tree[n]
    raise KeyError(f"{what}: none of {list(names)} in the param tree (keys: {sorted(tree)})")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


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
