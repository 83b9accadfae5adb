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

CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet and DUNet (their
``*_params_from_jax``, all :func:`zoo2_params_from_jax`), and qCIRIM and
qVarNet (:func:`qcirim_params_from_jax`, :func:`qvn_params_from_jax`) map by one table of
leaf pairs read off a port model built from the config, which
:func:`zoo2_params_to_jax` reads the other way: the auto-named regulariser
scopes (``Conv2dCascade_{i}``, ``MWCNN_{i}`` with its ``_Wrap_{i}`` head,
``DIDN_{i}``, ``NormUnet_{i}``), frozen BatchNorm entries as parameters and
``batch_stats`` as buffers. RecurrentVarNet and MultiDomainNet
(:func:`rvn_params_from_jax`, :func:`multidomainnet_params_from_jax`) take
the same table: flax creates ``RecurrentInit_0``'s dilated convs and then its
1x1 convs, and in each ``_RVNBlock_{i}/Conv2dGRU_0`` per layer the cell conv
and the update, reset and candidate gates (``Conv_{4l}`` to ``Conv_{4l+3}``),
the output conv last; ``MultiDomainUnet2d_0`` numbers its blocks down,
bottleneck, up, its transpose convs from the bottom up, and a multi-domain
conv's image conv before its k-space conv.

The segmentation models (:func:`zoo2_params_from_jax` too, the same table) map
by the flax auto-names their modules carry (``flax_scope``,
``nn/seg_blocks.py``): a 3D conv's DHWIO kernel to OIDHW, a 3D transpose
conv's kernel flipped in its three spatial axes, a Dense kernel [in, out]
transposed, a V-Net PReLU's ``alpha``, UNETR's ``position_embeddings`` and
its LayerNorm's ``scale``/``bias`` as they are. The trunk's input width
(and UNETR's patch count) is read off the tree's shapes.

The multitask models (the same table) map by their modules' flax names
too: MTLRS's ``RIMBlock_{k}`` step scans as qCIRIM's recurrent blocks and its
heads ``{class}_{i}`` (the explicit name of the JAX package's ``nn.remat``,
which the head has whichever way it was built), the DC weights
(``KSpaceDC_0/dc_weight``, ``SERANetDC_{i}/dc_weight``), the exposed-feature
U-Nets' ``UnetEncoder_{i}``/``UnetDecoder_{j}`` and the ConvLSTMs'
``ConvLSTM_0/ConvLSTMCell_0/Conv_0``. The widths that follow the coil count
are read off the tree's shapes.

JointICNet (the same table) maps ``NormUnet_0`` (the k-space U-Net),
``NormUnet_1`` (the image U-Net), ``SensitivityModel_0/NormUnet_0`` and its
five per-iteration parameters. CIRIM, VarNet, UNet and ResNet/ProximalGradient
are in the table too: the functions above that read their structure off the
tree (no config) take the same pairs. CIRIM's leaves are stacked over the
cascades, and its pairs name row i of a leaf ``leaf[i]``. A model with
``use_sens_net`` is the JAX package's ``WithSensNet``: the wrapper's
estimator's ``SensitivityModel_0/NormUnet_0`` beside the wrapped model's
tree under ``model`` (both read off ``init``); JointICNet's own estimator
is ``model/SensitivityModel_0``. :func:`params_from_jax` and
:func:`params_to_jax` map any model of the registry both ways; the port
archives a wrapped model and JointICNet in flax msgpack through them, since
``mridc_tpu`` restores no reference torch archive of either.

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
           "unet_params_from_jax", "resnet_params_from_jax", "zoo2_params_from_jax", "zoo2_params_to_jax",
           "cascadenet_params_from_jax", "crnn_params_from_jax", "xpdnet_params_from_jax", "kikinet_params_from_jax",
           "lpdnet_params_from_jax", "vsnet_params_from_jax", "dunet_params_from_jax", "rvn_params_from_jax",
           "multidomainnet_params_from_jax", "qcirim_params_from_jax", "qvn_params_from_jax", "mtlrs_params_from_jax",
           "idslr_params_from_jax", "idslrunet_params_from_jax", "segnet_params_from_jax",
           "recsegunet_params_from_jax", "seranet_params_from_jax", "jointicnet_params_from_jax",
           "params_from_jax", "params_to_jax", "hwio_to_oihw", "hwio_to_iohw_flipped"]

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


def _unwrap(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


_ROW = re.compile(r"^(.*)\[(\d+)\]$")


class _Leaves:
    """A flax subtree's leaves by path; :meth:`take` hands each out once and
    :meth:`done` raises on any left over. A path ``leaf[i]`` takes row i of a
    leaf stacked over a scan axis (CIRIM's cascades), each row once."""

    def __init__(self, tree: Mapping, what: str):
        self.what = what
        self.leaves: Dict[str, np.ndarray] = {}
        self.rows: Dict[str, set] = {}

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
        row = _ROW.match(path)
        leaf = row.group(1) if row else path
        if leaf not in self.leaves:
            raise KeyError(f"{self.what}: leaf {path!r} missing from the param tree")
        if not row:
            return self.leaves.pop(leaf)
        a, i, seen = self.leaves[leaf], int(row.group(2)), self.rows.setdefault(leaf, set())
        if i in seen or i >= len(a):
            raise KeyError(f"{self.what}: row {i} of {leaf!r} (shape {a.shape}) taken twice or missing")
        seen.add(i)
        if len(seen) == len(a):
            del self.leaves[leaf]
        return a[i]

    def done(self) -> None:
        if self.leaves:
            raise KeyError(f"{self.what}: leaves not used: {sorted(self.leaves)}")


def _take(pairs, tree: Mapping, what: str) -> Dict[str, torch.Tensor]:
    """The port state of the ``params`` pairs over a bare param tree, every
    leaf used once."""
    leaves = _Leaves(tree, what)
    state = {p: _t(_FROM[kind](leaves.take(f))) for _, f, p, kind in pairs}
    leaves.done()
    return state


def _pools(leaves: _Leaves, f: str) -> int:
    """The pool count of the ``NormUnet`` at scope ``f`` of a param tree."""
    n = 0
    while leaves.has(f"{f}Unet_0/TransposeConvBlock_{n}/ConvTranspose_0/kernel"):
        n += 1
    if n == 0:
        raise KeyError(f"{leaves.what}: no {f}Unet_0/TransposeConvBlock_0 in the param tree")
    return n


def _scope_of(tree: Mapping, names, what: str) -> str:
    """The one of ``names`` (a remat and a plain scan scope) that ``tree`` holds."""
    _one_of(tree, names, what)
    return next(n for n in names if n in tree)


_STEP_SCOPES = ("ScanCheckpoint_RIMStep_0", "Scan_RIMStep_0")
_CASCADE_SCOPES = ("ScanCheckpoint_Cascade_0", "Scan_Cascade_0")


def _tree_rim_layout(step: Mapping):
    """:func:`_rim_layout` read off a flax RIM step's subtree."""
    cells = sorted((int(m.group(2)), m.group(1)) for name in step if (m := _CELL_SCOPE.match(name)))
    layers = [(cls, "bias" in step[f"ConvNonlinear_{h}"]["Conv_0"], "bias" in step[f"{cls}_{h}"]["Conv_0"])
              for h, cls in cells]
    return layers, "bias" in step[f"ConvNonlinear_{len(cells)}"]["Conv_0"]


def rim_block_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.nn.rim.RIMBlock` state from a flax
    ``RIMBlock`` param tree (as ``RIMBlock(...).init`` returns it)."""
    block = _unwrap(tree)
    step = _scope_of(block, _STEP_SCOPES, "RIMBlock_0")
    pairs = _rim_stack_pairs(_tree_rim_layout(block[step]), f"{step}/", "")
    return _take(pairs + ([_leaf("dc_weight", "dc_weight")] if "dc_weight" in block else []), block, "RIMBlock params")


def cirim_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port CIRIM ``state_dict`` from a flax CIRIM param tree of any
    ``remat_mode`` (with or without the top-level ``"params"`` key)."""
    params = _unwrap(tree)
    cascade = _scope_of(params, _CASCADE_SCOPES, "CIRIM params")
    block = params[cascade]["RIMBlock_0"]
    step = _scope_of(block, _STEP_SCOPES, "RIMBlock_0")
    n = int(np.shape(block[step]["ConvNonlinear_0"]["Conv_0"]["kernel"])[0])
    pairs = _cirim_pairs(n, _tree_rim_layout(block[step]), "dc_weight" in block, cascade, step)
    return _take(pairs, params, "CIRIM params")


def normunet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.nn.unet.NormUnet` state from a flax
    ``NormUnet`` param tree (``{"Unet_0": ...}``, with or without ``"params"``)."""
    params = _unwrap(tree)
    return _take(_unet_pairs(_pools(_Leaves(params, "NormUnet params"), ""), "", ""), params, "NormUnet params")


def varnet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.models.recon.vn.VarNet` ``state_dict``
    from a flax VarNet param tree (either ``dc_mode``: they share it)."""
    params = _unwrap(tree)
    leaves = _Leaves(params, "VarNet params")
    n = 0
    while leaves.has(f"_VarNetBlock_{n}/dc_weight"):
        n += 1
    if n == 0:
        raise KeyError("VarNet params: no _VarNetBlock_0/dc_weight in the param tree")
    return _take(_varnet_pairs([_pools(leaves, f"_VarNetBlock_{i}/NormUnet_0/") for i in range(n)]), params,
                 "VarNet params")


def unet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.models.recon.unet.UNet` ``state_dict``
    from a flax UNet param tree (``{"NormUnet_0": {"Unet_0": ...}}``)."""
    params = _unwrap(tree)
    pools = _pools(_Leaves(params, "UNet params"), "NormUnet_0/")
    return _take(_unet_pairs(pools, "NormUnet_0/", "unet."), params, "UNet params")


def resnet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Port :class:`~mridc_tpu_torch.models.recon.resnet.ResNet` (or
    ``ProximalGradient``) ``state_dict`` from a flax param tree: the residual
    network's convs where there are any, ``mu`` where there is one."""
    params = _unwrap(tree)
    leaves = _Leaves(params, "ResNet params")
    n = 0
    while leaves.has(f"ResidualNetwork_0/Conv_{n}/kernel"):
        n += 1
    if n and (n < 3 or n % 2 == 0):
        raise KeyError(f"ResNet params: {n} convs in ResidualNetwork_0, expected 2 * blocks + 3")
    if not n and not leaves.has("mu"):
        raise KeyError("ResNet params: neither ResidualNetwork_0 nor mu in the param tree")
    return _take(_resnet_pairs((n - 3) // 2 if n else None, leaves.has("mu")), params, "ResNet params")


# ---- the conv-cascade, MWCNN and DIDN models: one table of leaf pairs, both ways ----
#
# A pair is (collection, flax path, port key, kind): ``collection`` "params" or
# "batch_stats" (live BatchNorm), ``kind`` "conv" (HWIO <-> OIHW), "convT"
# (flax ConvTranspose <-> torch's flipped kernel) or None (as is). The table
# is read off a port model built from the config, so that both directions
# (``params_from_jax``, ``params_to_jax``) take every leaf once by one list.


def _leaf(f: str, p: str, coll: str = "params", kind=None):
    return (coll, f, p, kind)


def _conv_pairs(f: str, p: str, bias: bool = True):
    return [_leaf(f + "kernel", p + "weight", kind="conv")] + ([_leaf(f + "bias", p + "bias")] if bias else [])


def _bn_pairs(bn, f: str, p: str):
    """flax ``TorchBatchNorm`` <-> port :class:`~mridc_tpu_torch.nn.layers.BatchNorm`."""
    out = [_leaf(f + "scale", p + "weight"), _leaf(f + "bias", p + "bias")]
    if bn.live:
        return out + [_leaf(f + "mean", p + "running_mean", "batch_stats"),
                      _leaf(f + "var", p + "running_var", "batch_stats")]
    return out + [_leaf(f + "mean", p + "mean"), _leaf(f + "var", p + "var")]


def _cascade_pairs(mod, f: str, p: str):
    """``Conv2dCascade``: ``Conv_{j}``, ``TorchBatchNorm_{j}``, ``prelu_{j}``."""
    out = []
    for j in range(len(mod.convs)):
        out += _conv_pairs(f"{f}Conv_{j}/", f"{p}convs.{j}.")
        if len(mod.bns):
            out += _bn_pairs(mod.bns[j], f"{f}TorchBatchNorm_{j}/", f"{p}bns.{j}.")
    return out + [_leaf(f"{f}prelu_{j}", f"{p}prelus.{j}") for j in range(len(mod.prelus))]


def _mwcnn_pairs(mod, f: str, p: str):
    """``MWCNN``: flax numbers its ``_CB`` and ``_DilCB`` blocks in creation
    order, the down path's scales first, then the up path's."""
    n = len(mod.down_cb)

    def block(blk, fb, pb):
        out = []
        for j in range(len(blk.convs)):
            out += _conv_pairs(f"{fb}Conv_{j}/", f"{pb}convs.{j}.")
            if len(blk.bns):
                out += _bn_pairs(blk.bns[j], f"{fb}TorchBatchNorm_{j}/", f"{pb}bns.{j}.")
        return out

    out = []
    for i in range(n):
        out += block(mod.down_cb[i], f"{f}_CB_{i}/", f"{p}down_cb.{i}.")
        out += block(mod.down_dil[i], f"{f}_DilCB_{i}/", f"{p}down_dil.{i}.")
        out += block(mod.up_dil[i], f"{f}_DilCB_{n + i}/", f"{p}up_dil.{i}.")
    for i in range(n - 1):
        out += block(mod.up_cb[i], f"{f}_CB_{n + i}/", f"{p}up_cb.{i}.")
    return out + _conv_pairs(f"{f}Conv_0/", f"{p}out.")


def _pconv_pairs(mod, f: str, p: str):
    out = _conv_pairs(f"{f}Conv_0/", f"{p}conv.")
    return out + ([_leaf(f"{f}prelu", f"{p}prelu")] if mod.prelu is not None else [])


def _didn_pairs(mod, f: str, p: str):
    """``DIDN``: its ``_PConv_{k}`` / ``Subpixel_{k}`` / ``Conv_{k}`` scopes in
    creation order, to the reference torch names."""
    out = _pconv_pairs(mod.conv_in, f"{f}_PConv_0/", f"{p}conv_in.")
    out += _pconv_pairs(mod.down, f"{f}_PConv_1/", f"{p}down.")
    for i, dub in enumerate(mod.dubs):
        fd, pd = f"{f}DUB_{i}/", f"{p}dubs.{i}."
        pconvs = [(dub.conv1_1[0], "conv1_1.0"), (dub.conv1_1[1], "conv1_1.1"), (dub.down1, "down1"),
                  (dub.conv2_1[0], "conv2_1.0"), (dub.down2, "down2"), (dub.conv3_1[0], "conv3_1.0"),
                  (dub.conv2_2[0], "conv2_2.0"), (dub.conv1_2[0], "conv1_2.0"), (dub.conv1_2[1], "conv1_2.1"),
                  (dub.conv_out[0], "conv_out.0")]
        for k, (m, name) in enumerate(pconvs):
            out += _pconv_pairs(m, f"{fd}_PConv_{k}/", f"{pd}{name}.")
        out += _conv_pairs(f"{fd}Subpixel_0/Conv_0/", f"{pd}up1.conv.")
        out += _conv_pairs(f"{fd}Conv_0/", f"{pd}conv_agg_1.")
        out += _conv_pairs(f"{fd}Subpixel_1/Conv_0/", f"{pd}up2.conv.")
        out += _conv_pairs(f"{fd}Conv_1/", f"{pd}conv_agg_2.")
    for j, m in enumerate(mod.recon_block.convs):
        out += _pconv_pairs(m, f"{f}ReconBlock_0/_PConv_{j}/", f"{p}recon_block.convs.{j}.")
    out += _conv_pairs(f"{f}Conv_0/", f"{p}recon_agg.")
    out += _pconv_pairs(mod.conv, f"{f}_PConv_2/", f"{p}conv.")
    out += _conv_pairs(f"{f}Subpixel_0/Conv_0/", f"{p}up2.conv.")
    return out + _pconv_pairs(mod.conv_out, f"{f}_PConv_3/", f"{p}conv_out.")


def _normunet_pairs(mod, f: str, p: str):
    """A port ``NormUnet`` at flax scope ``f``: :func:`_unet_pairs`."""
    return _unet_pairs(len(mod.unet.down_sample_layers), f, p)


def _unet_pairs(pools: int, f: str, p: str):
    """A ``NormUnet`` of ``pools`` pools: its ``Unet_0``'s ``ConvBlock_k`` (the
    down blocks, the bottleneck, the up blocks), ``TransposeConvBlock_i``
    and the final 1x1 ``Conv_0``."""
    f = f + "Unet_0/"
    out = []

    def block(k, name):
        return [_leaf(f"{f}ConvBlock_{k}/Conv_{j}/kernel", f"{p}unet.{name}.layers.{layer}.weight", kind="conv")
                for j, layer in ((0, 0), (1, 4))]

    for i in range(pools):
        out += block(i, f"down_sample_layers.{i}")
    out += block(pools, "conv")
    for i in range(pools):
        out.append(_leaf(f"{f}TransposeConvBlock_{i}/ConvTranspose_0/kernel",
                         f"{p}unet.up_transpose_conv.{i}.layers.0.weight", kind="convT"))
        out += block(pools + 1 + i, f"up_conv.{i}" if i < pools - 1 else f"up_conv.{i}.0")
    return out + _conv_pairs(f"{f}Conv_0/", f"{p}unet.up_conv.{pools - 1}.1.")


class _Scopes:
    """flax's auto-names: ``{Class}_{k}`` counted per class in creation order."""

    def __init__(self):
        self.count: Dict[str, int] = {}

    def __call__(self, cls: str) -> str:
        k = self.count.get(cls, 0)
        self.count[cls] = k + 1
        return f"{cls}_{k}/"


def _regulariser_pairs(mod, scopes: _Scopes, p: str):
    """A regulariser module under the parent's next auto-named scope of its
    flax class (an ``MWCNNHead`` is an ``MWCNN`` scope beside a ``_Wrap`` one
    holding the head conv)."""
    from mridc_tpu_torch.nn.conv2d import Conv2dCascade
    from mridc_tpu_torch.nn.didn import DIDN
    from mridc_tpu_torch.nn.mwcnn import MWCNN, MWCNNHead
    from mridc_tpu_torch.nn.unet import NormUnet

    if isinstance(mod, MWCNNHead):
        out = _mwcnn_pairs(mod.mwcnn, scopes("MWCNN"), f"{p}mwcnn.")
        return out + _conv_pairs(f"{scopes('_Wrap')}Conv_0/", f"{p}head.")
    for cls, fn in ((Conv2dCascade, _cascade_pairs), (MWCNN, _mwcnn_pairs), (DIDN, _didn_pairs),
                    (NormUnet, _normunet_pairs)):
        if isinstance(mod, cls):
            return fn(mod, scopes(cls.__name__), p)
    raise TypeError(f"no flax mapping for regulariser {type(mod).__name__}")


def _recurrent_init_pairs(mod, f: str, p: str):
    """``RecurrentInit``: its dilated convs, then its 1x1 convs."""
    n = len(mod.conv_blocks)
    out = []
    for i in range(n):
        out += _conv_pairs(f"{f}Conv_{i}/", f"{p}conv_blocks.{i}.")
    for j in range(len(mod.out_blocks)):
        out += _conv_pairs(f"{f}Conv_{n + j}/", f"{p}out_blocks.{j}.")
    return out


def _gru_pairs(mod, f: str, p: str):
    """``Conv2dGRU``: per layer the cell conv and the update, reset and
    candidate gates, then the output conv."""
    out = []
    for layer in range(mod.num_layers):
        for k, name in enumerate(("conv_blocks", "update_gates", "reset_gates", "out_gates")):
            out += _conv_pairs(f"{f}Conv_{4 * layer + k}/", f"{p}{name}.{layer}.")
    return out + _conv_pairs(f"{f}Conv_{4 * mod.num_layers}/", f"{p}conv_out.")


def _rvn_pairs(model):
    """``RecurrentInit_0`` and each ``_RVNBlock_{i}`` (one when shared)."""
    out = [] if model.initializer is None else _recurrent_init_pairs(model.initializer, "RecurrentInit_0/",
                                                                      "initializer.")
    for i, block in enumerate(model.block_list):
        out.append(_leaf(f"_RVNBlock_{i}/learning_rate", f"block_list.{i}.learning_rate"))
        out += _gru_pairs(block.regularizer, f"_RVNBlock_{i}/Conv2dGRU_0/", f"block_list.{i}.regularizer.")
    return out


def _mdconv_pairs(mod, f: str, p: str):
    """``MultiDomainConv``: the image branch's kernel, then the k-space
    branch's (``Conv_{j}``, or ``ConvTranspose_{j}`` in the up path)."""
    from mridc_tpu_torch.nn.layers import ConvTranspose

    if isinstance(mod.image_conv, ConvTranspose):
        return [_leaf(f"{f}ConvTranspose_{j}/kernel", f"{p}{name}.weight", kind="convT")
                for j, name in enumerate(("image_conv", "kspace_conv"))]
    return [_leaf(f"{f}Conv_{j}/kernel", f"{p}{name}.weight", kind="conv")
            for j, name in enumerate(("image_conv", "kspace_conv"))]


def _multidomain_unet_pairs(mod, f: str, p: str):
    """``MultiDomainUnet2d``: ``MultiDomainConvBlock_{k}`` down, bottleneck,
    up; ``MultiDomainConv_{i}`` the up path's transpose convs; ``Conv_0``."""
    blocks = [(b, f"down_sample_layers.{i}") for i, b in enumerate(mod.down_sample_layers)] + [(mod.conv, "conv")]
    blocks += [(b, f"up_conv.{i}") for i, b in enumerate(mod.up_conv)]
    out = []
    for k, (block, name) in enumerate(blocks):
        for j, conv in enumerate(block.convs):
            out += _mdconv_pairs(conv, f"{f}MultiDomainConvBlock_{k}/MultiDomainConv_{j}/", f"{p}{name}.convs.{j}.")
    for i, conv in enumerate(mod.up_transpose_conv):
        out += _mdconv_pairs(conv, f"{f}MultiDomainConv_{i}/", f"{p}up_transpose_conv.{i}.")
    return out + _conv_pairs(f"{f}Conv_0/", f"{p}final_conv.")


def _sens_pairs(mod, f: str, p: str):
    """A ``SensitivityModel``'s ``NormUnet_0`` (port ``norm_unet``)."""
    return _normunet_pairs(mod.norm_unet, f + "NormUnet_0/", p + "norm_unet.")


def _varnet_pairs(pools):
    """VarNet's ``_VarNetBlock_{i}``: its ``dc_weight`` and its ``NormUnet_0``
    of ``pools[i]`` pools."""
    out = []
    for i, n in enumerate(pools):
        out.append(_leaf(f"_VarNetBlock_{i}/dc_weight", f"cascades.{i}.dc_weight"))
        out += _unet_pairs(n, f"_VarNetBlock_{i}/NormUnet_0/", f"cascades.{i}.model.")
    return out


def _resnet_pairs(blocks, mu: bool):
    """ResNet's ``ResidualNetwork_0/Conv_k`` of ``blocks`` residual blocks
    (None: no network), in flax's creation order: ``Conv_0`` the first
    conv, per block ``Conv_{2i+1}`` the outer and ``Conv_{2i+2}`` the inner,
    then the last two; and the CG weight ``mu`` where there is one."""
    out = []
    if blocks is not None:
        names = (["conv1"] + [f"layers{j}.{i}" for i in range(blocks) for j in (2, 1)]
                 + ["last_layer", "final_layer"])
        out += [_leaf(f"ResidualNetwork_0/Conv_{k}/kernel", f"residual_network.{name}.weight", kind="conv")
                for k, name in enumerate(names)]
    return out + ([_leaf("mu", "mu")] if mu else [])


def _rim_layout(block):
    """The flax layout of a port RIM step stack (``RIMBlock``'s or
    ``qRIMBlock``'s): per layer (cell class, conv bias, input conv bias),
    and the final conv's bias."""
    layers = [(type(layer.rnn).__name__, layer.convs.conv_layer.bias is not None, layer.rnn.ih.bias is not None)
              for layer in block.layers]
    return layers, block.final_layer[0].conv_layer.bias is not None


def _rim_stack_pairs(layout, f: str, p: str):
    """A RIM step's conv/RNN stack of ``layout`` (:func:`_rim_layout`) under
    the step's scan scope ``f``: ``ConvNonlinear_{h}`` and the cells
    (``{Cell}_{h}``: ``Conv_0`` the input conv, IndRNN's ``hh`` or a gated
    cell's ``Conv_1``), the last ``ConvNonlinear`` the final conv."""
    layers, final_bias = layout
    out = []
    for h, (cls, conv_bias, ih_bias) in enumerate(layers):
        out += _conv_pairs(f"{f}ConvNonlinear_{h}/Conv_0/", f"{p}layers.{h}.convs.conv_layer.", conv_bias)
        scope = f"{f}{cls}_{h}/"
        out += _conv_pairs(f"{scope}Conv_0/", f"{p}layers.{h}.rnn.ih.", ih_bias)
        out += ([_leaf(f"{scope}hh", f"{p}layers.{h}.rnn.hh", kind="hh")] if cls == "IndRNNCell"
                else _conv_pairs(f"{scope}Conv_1/", f"{p}layers.{h}.rnn.hh.", False))
    return out + _conv_pairs(f"{f}ConvNonlinear_{len(layers)}/Conv_0/", f"{p}final_layer.0.conv_layer.", final_bias)


def _cirim_pairs(n: int, layout, dc_weight: bool, cascade: str, step: str):
    """CIRIM's ``{cascade}/RIMBlock_0``: every leaf stacked over the ``n``
    cascades (row i the port's ``cirim.{i}``), the step stack under
    ``step``, the soft-DC ``dc_weight`` at the block."""
    block = f"{cascade}/RIMBlock_0/"
    out = []
    for i in range(n):
        pairs = _rim_stack_pairs(layout, f"{block}{step}/", f"cirim.{i}.")
        pairs += [_leaf(f"{block}dc_weight", f"cirim.{i}.dc_weight")] if dc_weight else []
        out += [(coll, f"{f}[{i}]", p, kind) for coll, f, p, kind in pairs]
    return out


def _quantitative_pairs(model):
    """qCIRIM: the reconstruction module's ``RIMBlock_{e * R + c}`` (a
    rematerialised step scan) and each ``qRIMBlock_{i}``'s step scan
    (``ScanCheckpoint_QRIMStep_0`` under remat "step", ``Scan_QRIMStep_0``
    under "none"). qVarNet: the shared ``_VarNetBlock_{j}``, then
    ``NormUnet_{i}`` and ``dc_weight_{i}`` per cascade."""
    from mridc_tpu_torch.models.quantitative import qCIRIM

    out = []
    if isinstance(model, qCIRIM):
        for k, block in enumerate(model.recon):
            out += _rim_stack_pairs(_rim_layout(block), f"RIMBlock_{k}/ScanCheckpoint_RIMStep_0/", f"recon.{k}.")
        for i, block in enumerate(model.qrim):
            scan = "ScanCheckpoint_QRIMStep_0" if block.remat else "Scan_QRIMStep_0"
            out += _rim_stack_pairs(_rim_layout(block), f"qRIMBlock_{i}/{scan}/", f"qrim.{i}.")
        return out
    for j, block in enumerate(model.recon):
        out += _normunet_pairs(block.model, f"_VarNetBlock_{j}/NormUnet_0/", f"recon.{j}.model.")
        out.append(_leaf(f"_VarNetBlock_{j}/dc_weight", f"recon.{j}.dc_weight"))
    for i, reg in enumerate(model.regs):
        out += _normunet_pairs(reg, f"NormUnet_{i}/", f"regs.{i}.")
        out.append(_leaf(f"dc_weight_{i}", f"dc_weights.{i}"))
    return out


def _scoped_pairs(module, f: str = "", p: str = "", skip=()):
    """The pairs of a module tree whose flax scopes are named on the modules
    (``flax_scope``, the segmentation trunks): a conv's, transpose conv's or
    Dense's kernel and bias, a BatchNorm's entries, and the leaves a module
    lists in ``flax_params``; ``module``'s children named in ``skip`` are left
    out."""
    from torch import nn

    from mridc_tpu_torch.nn.layers import BatchNorm

    if isinstance(module, BatchNorm):
        return _bn_pairs(module, f, p)
    for cls, kind in ((nn.Conv2d, "conv"), (nn.Conv3d, "conv3"), (nn.ConvTranspose2d, "convT"),
                      (nn.ConvTranspose3d, "convT3"), (nn.Linear, "dense")):
        if isinstance(module, cls):
            return [_leaf(f + "kernel", p + "weight", kind=kind)] + (
                [_leaf(f + "bias", p + "bias")] if module.bias is not None else [])
    out = [_leaf(f + leaf, p + name) for leaf, name in getattr(module, "flax_params", {}).items()]
    for name, child in module.named_children():
        if name in skip:
            continue
        scope = getattr(child, "flax_scope", None)
        out += _scoped_pairs(child, f"{f}{scope}/" if scope else f, f"{p}{name}.")
    return out


def _model_pairs(model):
    """The pairs of a whole CascadeNet, CRNNet, XPDNet, KIKINet, LPDNet, VSNet,
    DUNet, RecurrentVarNet, MultiDomainNet, qCIRIM, qVarNet, segmentation or
    multitask model, read off the port model: MTLRS's ``RIMBlock_{k}`` step
    scans as qCIRIM's, the rest by the modules' flax scopes."""
    from mridc_tpu_torch.models.quantitative import qCIRIM, qVarNet
    from mridc_tpu_torch.models.recon import (CIRIM, CS, PICS, ZF, CascadeNet, CRNNet, DUNet, JointICNet, KIKINet,
                                              LPDNet, MultiDomainNet, ProximalGradient, RecurrentVarNet, ResNet, UNet,
                                              VarNet, VSNet, XPDNet)
    from mridc_tpu_torch.models.segmentation import SegmentationModel

    from mridc_tpu_torch.models.multitask import MTLRS, IDSLR, RecSegUNet, SegNet, SERANet
    from mridc_tpu_torch.models.sens_wrapper import is_wrapped

    scopes, out = _Scopes(), []
    if isinstance(model, (SegmentationModel, IDSLR, SegNet, RecSegUNet, SERANet)):
        # a wrapper's estimator maps under SensitivityModel_0/ (_all_pairs), not in the model's scopes
        out += _scoped_pairs(model, skip=(model.sens_attr,) if is_wrapped(model) else ())
    elif isinstance(model, MTLRS):
        for k, block in enumerate(model.rim_blocks):
            out += _rim_stack_pairs(_rim_layout(block), f"RIMBlock_{k}/ScanCheckpoint_RIMStep_0/",
                                    f"rim_blocks.{k}.")
        out += _scoped_pairs(model.seg_heads, "", "seg_heads.")
    elif isinstance(model, (qCIRIM, qVarNet)):
        out += _quantitative_pairs(model)
    elif isinstance(model, CascadeNet):
        for i, block in enumerate(model.cascades):
            out += _cascade_pairs(block.model, f"Conv2dCascade_{i}/", f"cascades.{i}.model.")
            out.append(_leaf(f"dc_weight_{i}", f"cascades.{i}.dc_weight"))
    elif isinstance(model, CRNNet):
        out += _cascade_pairs(model.block.model, "Scan_CRNNIter_0/Conv2dCascade_0/", "block.model.")
        out.append(_leaf("Scan_CRNNIter_0/dc_weight", "block.dc_weight"))
    elif isinstance(model, XPDNet):
        for i, it in enumerate(model.iterations):  # flax creates the k-space model first
            if it.kspace_model is not None:
                out += _regulariser_pairs(it.kspace_model, scopes, f"iterations.{i}.kspace_model.")
            out += _regulariser_pairs(it.image_model, scopes, f"iterations.{i}.image_model.")
    elif isinstance(model, KIKINet):
        out += _regulariser_pairs(model.kspace_model, scopes, "kspace_model.")
        out += _regulariser_pairs(model.image_model, scopes, "image_model.")
        out.append(_leaf("dc_weight", "dc_weight"))
    elif isinstance(model, LPDNet):
        out += _regulariser_pairs(model.dual_model, scopes, "dual_model.")
        out += _regulariser_pairs(model.primal_model, scopes, "primal_model.")
    elif isinstance(model, VSNet):
        for i, block in enumerate(model.cascades):
            out += _regulariser_pairs(block.model, scopes, f"cascades.{i}.model.")
            out += [_leaf(f"dc_weight_{i}", f"cascades.{i}.dc_weight"),
                    _leaf(f"weighted_avg_{i}", f"cascades.{i}.weighted_avg")]
    elif isinstance(model, DUNet):
        for i, reg in enumerate(model.regs):
            out += _regulariser_pairs(reg, scopes, f"regs.{i}.")
        for name, plist in (("lambda", model.lambdas), ("alpha", model.alphas), ("beta", model.betas)):
            out += [_leaf(f"{name}_{i}", f"{name}s.{i}") for i in range(len(plist or []))]
    elif isinstance(model, RecurrentVarNet):
        out += _rvn_pairs(model)
    elif isinstance(model, MultiDomainNet):
        out += _multidomain_unet_pairs(model.unet, "MultiDomainUnet2d_0/", "unet.")
    elif isinstance(model, JointICNet):
        out += _normunet_pairs(model.kspace_model, "NormUnet_0/", "kspace_model.")
        out += _normunet_pairs(model.image_model, "NormUnet_1/", "image_model.")
        out += _sens_pairs(model.sens_net, "SensitivityModel_0/", "sens_net.")
        out += [_leaf(n, n) for n in ("reg_param_I", "reg_param_F", "reg_param_C", "lr_image", "lr_sens")]
    elif isinstance(model, VarNet):
        out += _varnet_pairs([len(block.model.unet.down_sample_layers) for block in model.cascades])
    elif isinstance(model, UNet):
        out += _normunet_pairs(model.unet, "NormUnet_0/", "unet.")
    elif isinstance(model, (ResNet, ProximalGradient)):
        net = getattr(model, "residual_network", None)
        out += _resnet_pairs(None if net is None else len(net.layers1), getattr(model, "mu", None) is not None)
    elif isinstance(model, CIRIM):
        first = model.cirim[0]
        out += _cirim_pairs(len(model.cirim), _rim_layout(first), getattr(first, "dc_weight", None) is not None,
                            _CASCADE_SCOPES[0 if model.remat_cascade else 1], _STEP_SCOPES[0 if first.remat_step else 1])
    elif isinstance(model, (ZF, CS, PICS)):
        pass
    else:
        raise TypeError(f"no flax mapping for model {type(model).__name__}")
    return out


def _all_pairs(model):
    """:func:`_model_pairs`, and for a model with ``use_sens_net`` the
    wrapper's estimator's pairs beside the wrapped model's under ``model/``."""
    from mridc_tpu_torch.models.sens_wrapper import estimator, is_wrapped

    if not is_wrapped(model):
        return _model_pairs(model)
    return _sens_pairs(estimator(model), "SensitivityModel_0/", f"{model.sens_attr}.") + [
        (coll, "model/" + f, p, kind) for coll, f, p, kind in _model_pairs(model)]


def _port_model(cfg: Mapping, in_chans=None):
    """The port model of ``cfg`` on the CPU; a qVarNet's regularisers built at
    ``in_chans`` (read off the weights by the caller)."""
    from mridc_tpu_torch.models.registry import build_model

    model = build_model(dict(cfg), device="cpu")
    if in_chans is not None and hasattr(model, "materialize"):
        model.materialize(int(in_chans))
    return model


def _seg_port_model(cfg: Mapping, params: Mapping):
    """A segmentation port model of ``cfg`` on the CPU, its trunk built at the
    input width (and UNETR's patch count) of the flax ``params``' shapes."""
    from mridc_tpu_torch.models.registry import build_model

    probe = build_model(dict(cfg), device="cpu")
    probe.materialize((1, 16, 16, 1))
    paths = {pk: fk for _, fk, pk, _ in _scoped_pairs(probe)}

    def shape(key):
        node = params
        for scope in paths[f"trunk.{key}"].split("/"):
            node = node[scope]
        return np.shape(node)

    model = build_model(dict(cfg), device="cpu")
    model._build(int(shape(model.first_conv)[-2]), int(shape(model.patch_param)[1]) if model.patch_param else 0)
    return model


def _collections(tree: Mapping):
    """(params, batch_stats) of a flax variables tree, a ``{"params",
    "batch_stats"}`` archive tree or a bare param tree."""
    if isinstance(tree, Mapping) and "params" in tree:
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def _contig(a, axes) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(a), axes))


_FROM = {None: lambda a: a, "conv": hwio_to_oihw, "convT": hwio_to_iohw_flipped,
         "hh": lambda a: _contig(a, (0, 3, 1, 2)), "conv3": lambda a: _contig(a, (4, 3, 0, 1, 2)),
         "convT3": lambda a: np.ascontiguousarray(np.transpose(np.asarray(a), (3, 4, 0, 1, 2))[..., ::-1, ::-1, ::-1]),
         "dense": lambda a: _contig(a, (1, 0))}
_TO = {None: lambda a: a, "conv": lambda a: _contig(a, (2, 3, 1, 0)), "hh": lambda a: _contig(a, (0, 2, 3, 1)),
       "convT": lambda a: _contig(a[..., ::-1, ::-1], (2, 3, 0, 1)), "conv3": lambda a: _contig(a, (2, 3, 4, 1, 0)),
       "convT3": lambda a: _contig(a[..., ::-1, ::-1, ::-1], (2, 3, 4, 0, 1)), "dense": lambda a: _contig(a, (1, 0))}


def _unstack_xpd_scan(params: Mapping, num_iter: int) -> Dict:
    """The inverse of ``mridc_tpu``'s ``stack_iteration_params``: one
    iteration's scopes under ``Scan_XPDIter_0``, each leaf stacked over the
    iterations, back to the unrolled ``{Class}_{i * per_iter + j}``."""
    import collections

    scan = params["Scan_XPDIter_0"]
    per_class = collections.Counter(re.match(r"(.+)_(\d+)$", k).group(1) for k in scan)
    out = {k: v for k, v in params.items() if k != "Scan_XPDIter_0"}

    def take(node, i):
        return {k: take(v, i) for k, v in node.items()} if isinstance(node, Mapping) else np.asarray(node)[i]

    for key, sub in scan.items():
        cls, j = re.match(r"(.+)_(\d+)$", key).groups()
        for i in range(num_iter):
            out[f"{cls}_{i * per_class[cls] + int(j)}"] = take(sub, i)
    return out


def zoo2_params_from_jax(tree: Mapping, cfg: Mapping) -> Dict[str, torch.Tensor]:
    """Port ``state_dict`` of any model of the registry (``cfg``'s
    ``model_name``, with or without ``use_sens_net``) from a flax variables tree:
    ``{"params": ..., "batch_stats": ...}`` or the bare params, with numpy
    leaves. Frozen BatchNorm entries (``mean``/``var`` in params) become
    parameters, live ones (``batch_stats``) the buffers ``running_mean`` and
    ``running_var``. XPDNet's ``Scan_XPDIter_0`` layout is taken as well as
    the unrolled one. Every leaf is used once."""
    params, stats = _collections(tree)
    if str(cfg.get("model_name", "")).upper() in _SEG_NAMES:
        model = _seg_port_model(cfg, params)
    elif str(cfg.get("model_name", "")).upper() in MULTITASK_NAMES:
        model = _port_model(cfg)
        if not getattr(model, "materialized", True):  # built at the input width of the tree's shapes
            node = params["model"] if cfg.get("use_sens_net", False) else params
            for scope in model.width_leaf.split("/"):
                node = node[scope]
            model._materialize_width(int(np.shape(node)[-2]))
    else:
        first = params.get("NormUnet_0", {}).get("Unet_0", {}).get("ConvBlock_0", {}).get("Conv_0", {}) \
            if isinstance(params, Mapping) else {}
        model = _port_model(cfg, np.shape(first["kernel"])[2] if "kernel" in first else None)
    if isinstance(params, Mapping) and "Scan_XPDIter_0" in params:
        params = _unstack_xpd_scan(params, len(model.iterations))
    name = str(cfg.get("model_name"))
    leaves = {"params": _Leaves(params, f"{name} params"), "batch_stats": _Leaves(stats, f"{name} batch_stats")}
    state = {p: _t(_FROM[kind](leaves[coll].take(f))) for coll, f, p, kind in _all_pairs(model)}
    for lv in leaves.values():
        lv.done()
    return state


def zoo2_params_to_jax(state: Mapping[str, torch.Tensor], cfg: Mapping) -> Dict:
    """The inverse of :func:`zoo2_params_from_jax`: a port ``state_dict`` to
    the flax variables ``{"params": ...}``, with ``"batch_stats"`` where the
    model tracks live statistics (numpy leaves; XPDNet in the unrolled
    layout: a live-statistics model, the one the port archives this way,
    refuses ``scan_iterations``)."""
    from mridc_tpu_torch.models.quantitative.qvn import FIRST_CONV

    if str(cfg.get("model_name", "")).upper() in _SEG_NAMES | MULTITASK_NAMES:
        model = _port_model(cfg)
        model.load_state_dict(state)  # the modules built at the state's widths
    else:
        first = state.get(FIRST_CONV)
        model = _port_model(cfg, None if first is None else first.shape[1])
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    left = set(state)
    for coll, f, p, kind in _all_pairs(model):
        if p not in state:
            raise KeyError(f"{cfg.get('model_name')} state dict: {p!r} missing")
        left.discard(p)
        node = out[coll]
        *scopes, leaf = f.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        row = _ROW.match(leaf)
        value = _TO[kind](state[p].detach().cpu().float().numpy())
        if row:  # a row of a leaf stacked over a scan axis, stacked below
            node.setdefault(row.group(1), {})[int(row.group(2))] = value
        else:
            node[leaf] = value
    if left:
        raise KeyError(f"{cfg.get('model_name')} state dict: keys not used: {sorted(left)}")

    def stacked(node):
        if node and all(isinstance(k, int) for k in node):
            return np.stack([node[i] for i in range(len(node))])
        return {k: stacked(v) if isinstance(v, dict) else v for k, v in node.items()}

    out = stacked(out)
    return out if out["batch_stats"] else {"params": out["params"]}


MULTITASK_NAMES = {"MTLRS", "JRSCIRIM", "IDSLR", "IDSLRUNET", "SEGNET", "RECSEGNET", "RECSEGUNET", "SERANET"}
_SEG_NAMES = {"SEGMENTATIONUNET", "SEGMENTATION2DUNET", "SEGMENTATION3DUNET", "SEGMENTATIONATTENTIONUNET",
              "SEGMENTATIONLAMBDAUNET", "SEGMENTATIONVNET", "SEGMENTATIONDYNUNET", "SEGMENTATIONUNETR"}


def _named(model_name: str):
    def from_jax(tree: Mapping, cfg: Mapping) -> Dict[str, torch.Tensor]:
        return zoo2_params_from_jax(tree, {**cfg, "model_name": model_name})

    from_jax.__name__ = f"{model_name.lower()}_params_from_jax"
    from_jax.__doc__ = f"Port {model_name} ``state_dict`` from a flax tree (:func:`zoo2_params_from_jax`)."
    return from_jax


cascadenet_params_from_jax = _named("CascadeNet")
crnn_params_from_jax = _named("CRNNet")
xpdnet_params_from_jax = _named("XPDNet")
kikinet_params_from_jax = _named("KIKINet")
lpdnet_params_from_jax = _named("LPDNet")
vsnet_params_from_jax = _named("VSNet")
dunet_params_from_jax = _named("DUNet")
rvn_params_from_jax = _named("RVN")
multidomainnet_params_from_jax = _named("MultiDomainNet")
qcirim_params_from_jax = _named("qCIRIM")
qvn_params_from_jax = _named("qVN")
mtlrs_params_from_jax = _named("MTLRS")
idslr_params_from_jax = _named("IDSLR")
idslrunet_params_from_jax = _named("IDSLRUNet")
segnet_params_from_jax = _named("SegNet")
recsegunet_params_from_jax = _named("RecSegUNet")
seranet_params_from_jax = _named("SERANet")
jointicnet_params_from_jax = _named("JointICNet")


# any model of the registry, with or without ``use_sens_net``, maps by the table
params_from_jax, params_to_jax = zoo2_params_from_jax, zoo2_params_to_jax
