"""Port parity: the segmentation models of mridc_tpu_torch against mridc_tpu's
on the CPU: the resize helpers, the seven trunks (the attention U-Net, the
lambda U-Net with its temporal lambda, V-Net, DynUNet with residual blocks
and deep supervision, UNETR with both patch embeddings, the U-Net and the 3D
U-Net on 4D and 5D batches), the wrappers and the registry, the weight carry
both ways, the losses and the metrics, and bfloat16 compute.

Inputs are drawn with numpy from a seed at B=2, 32x32, one input channel;
weights are drawn with numpy in the flax tree's shapes (``jax.eval_shape`` of
the JAX wrapper's ``init``) and carried into the port by
``zoo2_params_from_jax``. Forward and loss: rtol 2e-3 / atol 2e-4 of the
largest magnitude (``tests/test_torch_parity.py:131``). Gradients: per
parameter against ``jax.grad`` of the YAMLs' loss (CE evaluated detached +
Dice, weights 0.5 / 0.5) at relative l2 1e-2 (random weights make LeakyReLU
and ELU kinks flip between the packages, ``ROADMAP.md`` §1); the lambda
U-Net's float32 gradient is ill-conditioned (its key softmax over every
position after train-mode BatchNorms: the JAX package's own gradient moves
by up to 4e-2 when the batch's rows are reordered), so it is held per
parameter at the larger of 1e-2 and twice the JAX package's distance between
its gradients of the batch and of the batch reordered; V-Net's train
step with the same channel-dropout masks handed to both sides (a test-side
patch of ``flax.linen.Dropout``); a gradient that is zero but for roundoff
(a conv bias before train-mode BatchNorm) is held to roundoff on both
sides. bfloat16: relative l2 2e-2 against the JAX package's bfloat16 forward
as a mean over 4 weight draws (a single draw's two independent bfloat16
roundings land at 0.014-0.022 from each other while each package's own
bfloat16-to-float32 distance is the same, ~0.017 for the attention U-Net);
the lambda U-Net, whose bfloat16 rounding its stack amplifies to 0.1-0.6 at
random weights in both packages, is held to at most the JAX package's own
bfloat16-to-float32 distance (``tests/test_segmentation.py:103``), as the
mean over 8 draws of the port's bfloat16-to-float32 distance. Weight
mappings, metrics and predicted classes: bit for bit.
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.losses import segmentation as jlosses
from mridc_tpu.metrics import segmentation as jmetrics
from mridc_tpu.models import build_model as jbuild
from mridc_tpu.nn import layers as jlayers
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu_torch.losses import segmentation as tlosses
from mridc_tpu_torch.metrics import segmentation as tmetrics
from mridc_tpu_torch.models import PENDING_MODELS, build_model
from mridc_tpu_torch.models.segmentation import SegmentationUNet
from mridc_tpu_torch.nn import layers as tlayers
from mridc_tpu_torch.nn import seg_blocks
from mridc_tpu_torch.train import task_trainers as ttt
from mridc_tpu_torch.utils.params import zoo2_params_from_jax, zoo2_params_to_jax

RTOL, ATOL = 2e-3, 2e-4
GRAD_REL_L2 = 1e-2
BF16_REL_L2 = 2e-2
B, H, W = 2, 32, 32
MODELS = {
    "unet": {"model_name": "SegmentationUNet", "segmentation_module_channels": 4,
             "segmentation_module_pooling_layers": 2},
    "unet3d": {"model_name": "Segmentation3DUNet", "segmentation_module_channels": 4,
               "segmentation_module_pooling_layers": 2},
    "attention": {"model_name": "SegmentationAttentionUNet", "segmentation_module_channels": 4,
                  "segmentation_module_pooling_layers": 2},
    "lambda": {"model_name": "SegmentationLambdaUNet", "segmentation_module_channels": 8,
               "segmentation_module_pooling_layers": 2},
    "vnet": {"model_name": "SegmentationVNet"},
    "dynunet": {"model_name": "SegmentationDYNUNet", "segmentation_module_channels": [4, 8, 8, 16]},
    "unetr": {"model_name": "SegmentationUNetR", "segmentation_module_channels": 4,
              "segmentation_module_hidden_size": 32, "segmentation_module_mlp_dim": 64,
              "segmentation_module_num_heads": 2},
}
VARIANTS = {
    "unet3d_volumes": ("unet3d", {}, (B, 3, H, W, 1)),
    "lambda_temporal": ("lambda", {"segmentation_module_temporal_kernel": 3, "consecutive_slices": 3}, (6, H, W, 1)),
    "lambda_two_channels": ("lambda", {"segmentation_module_query_depth": 4, "segmentation_module_intra_depth": 2},
                            (B, H, W, 2)),
    "dynunet_res_deep": ("dynunet", {"segmentation_module_deep_supervision": True,
                                     "segmentation_module_deep_supervision_levels": 2}, (B, H, W, 1)),
    "unetr_perceptron": ("unetr", {"segmentation_module_pos_embed": "perceptron",
                                   "segmentation_module_res_block": False, "segmentation_module_qkv_bias": True},
                         (B, H, W, 1)),
    "attention_odd": ("attention", {}, (B, 30, 26, 1)),
    "unet_odd": ("unet", {}, (B, 30, 26, 1)),
    "lambda_b1": ("lambda", {}, (1, H, W, 1)),
}
LOSS = {"use_ce": True, "use_dice": True, "ce_weight": 0.5, "dice_weight": 0.5,
        "dice_kwargs": {"include_background": False, "sigmoid": True, "batch": False}, "ce_kwargs": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1e-30, float(np.abs(want).max())))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _image(shape, seed=0):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _labels(shape, classes=2, seed=1):
    """One-hot labels [..., classes] of a random map."""
    lab = np.random.default_rng(seed).integers(0, classes, shape)
    return np.eye(classes, dtype=np.float32)[lab]


@functools.lru_cache(maxsize=None)
def _jm(key):
    return jbuild(json.loads(key))


def _key(cfg):
    return json.dumps(cfg, sort_keys=True)


def _leaf(rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (1.0 + 0.1 * np.abs(rng.standard_normal(s.shape))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "alpha":
            return (0.25 + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "position_embeddings":
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)  # bias, mean
    return leaf


def jax_vars(cfg, shape, seed=0):
    """flax variables of ``cfg``'s wrapper for images of ``shape``, drawn with
    numpy (no flax init: ``jax.eval_shape`` gives the tree)."""
    shapes = jax.eval_shape(_jm(_key(cfg)).init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    return jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(seed)), dict(shapes))


@functools.lru_cache(maxsize=None)
def _jax_apply(key, train):
    return jax.jit(functools.partial(_jm(key).apply, train=train))


def port(cfg, v):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(v, cfg))
    return model


def _case(name):
    if name in MODELS:
        return dict(MODELS[name]), (B, H, W, 1)
    base, extra, shape = VARIANTS[name]
    return {**MODELS[base], **extra}, shape


# ---- the resize helpers ----


@pytest.mark.parametrize("size", [(16, 16, 32, 32), (15, 13, 30, 26), (32, 32, 16, 16), (31, 29, 12, 17),
                                  (8, 12, 13, 9)])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_resize_helpers_match_jax(mode, size):
    """``nearest_resize`` and ``bilinear_resize`` (torch's ``F.interpolate``,
    bilinear without antialiasing) against the JAX helpers, up and down, at
    odd and even sizes."""
    h, w, oh, ow = size
    x = np.random.default_rng(3).standard_normal((2, h, w, 3)).astype(np.float32)
    want = getattr(jlayers, f"{mode}_resize")(jnp.asarray(x), oh, ow)
    got = getattr(tlayers, f"{mode}_resize")(torch.from_numpy(x).permute(0, 3, 1, 2), oh, ow).permute(0, 2, 3, 1)
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


# ---- the trunks: forward, gradients, weights ----


@pytest.mark.parametrize("name", list(MODELS) + list(VARIANTS))
def test_forward_matches_jax(name):
    """Each trunk family's inference forward (the wrapper's logits) against
    the JAX wrapper on the same weights; the 3D U-Net on a 4D batch (the
    batch is its depth) and on volumes; the lambda U-Net's temporal lambda on
    a folded batch of 2 x 3 slices; DynUNet's deep-supervision heads in train
    mode."""
    cfg, shape = _case(name)
    x = _image(shape)
    v = jax_vars(cfg, shape)
    train = name == "dynunet_res_deep"
    want = np.asarray(_jax_apply(_key(cfg), train)(v, jnp.asarray(x)))
    model = port(cfg, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    _close(got, want)
    if train:
        assert got.shape == (B, 3, H, W, 2)


def test_unet3d_takes_the_batch_as_depth_like_jax():
    """A 4D batch is one volume: the first row's logits alone differ from the
    same row's inside the batch, in both packages alike."""
    cfg = MODELS["unet3d"]
    x = _image((3, H, W, 1), seed=5)
    v = jax_vars(cfg, (3, H, W, 1))
    model = port(cfg, v)
    with torch.no_grad():
        whole, first = model(torch.from_numpy(x)), model(torch.from_numpy(x[:1]))
    jwhole = np.asarray(_jax_apply(_key(cfg), False)(v, jnp.asarray(x)))
    jfirst = np.asarray(_jax_apply(_key(cfg), False)(v, jnp.asarray(x[:1])))
    _close(whole, jwhole)
    _close(first, jfirst)
    assert float(np.abs(whole[:1].numpy() - first.numpy()).max()) > 1e-3


@pytest.mark.parametrize("act", ["prelu", "relu", "leakyrelu"])
def test_vnet_activations_and_bias_match_jax(act):
    """V-Net's other activations (PReLU's one alpha per scope) and conv biases
    (``use_bias``), at two input channels (tiled to 16), against the JAX
    trunk; the wrapper builds elu without bias, as the JAX wrapper does."""
    from mridc_tpu.nn.seg_blocks import VNet as JVNet

    x = _image((B, H, W, 2), seed=7)
    jm = JVNet(out_chans=2, act=act, use_bias=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(8)), dict(shapes))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    model = seg_blocks.VNet(2, 2, act=act, use_bias=True)
    model.flax_scope = "VNet_0"
    wrapper = torch.nn.Module()
    wrapper.trunk = model
    state = _state_from_tree(wrapper, {"params": {"VNet_0": v["params"]}})
    wrapper.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)
    alphas = [p for p in jax.tree_util.tree_leaves_with_path(v) if p[0][-1].key == "alpha"]
    assert sum(k.endswith("alpha") for k in state) == len(alphas) == (32 if act == "prelu" else 0)


def _state_from_tree(module, tree):
    from mridc_tpu_torch.utils import params as P

    pairs = P._scoped_pairs(module)
    leaves = {"params": P._Leaves(tree["params"], "params"), "batch_stats": P._Leaves(tree.get("batch_stats", {}),
                                                                                      "batch_stats")}
    state = {p: P._t(P._FROM[kind](leaves[coll].take(f))) for coll, f, p, kind in pairs}
    for lv in leaves.values():
        lv.done()
    return state


def _drop_masks(seed):
    rng = np.random.default_rng(seed)
    return lambda shape, p: rng.random(shape) >= p


def _patched_flax_dropout(draw):
    def call(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        assert tuple(self.broadcast_dims) == (1, 2), "only channel dropout draws masks here"
        keep = jnp.asarray(draw((inputs.shape[0], inputs.shape[-1]), self.rate))[:, None, None, :]
        return jnp.where(keep, inputs / (1.0 - self.rate), 0.0)
    return call


def _jax_loss_grads(cfg, v, x, target, mutable=False):
    jm = _jm(_key(cfg))

    def loss(params):
        out = jm.apply({**v, "params": params}, jnp.asarray(x), train=True,
                       **({"mutable": ["batch_stats"]} if mutable else {}))
        logits = out[0] if mutable else out
        return jtt.segmentation_loss_fn(jnp.asarray(target), logits, **LOSS)

    return jax.jit(jax.value_and_grad(loss))(v["params"])


@pytest.mark.parametrize("name", ["unet", "unet3d", "attention", "lambda", "vnet", "dynunet", "unetr",
                                  "lambda_temporal", "dynunet_res_deep", "lambda_b1"])
def test_loss_and_gradients_match_jax(name, monkeypatch):
    """The YAMLs' loss (detached CE + Dice) of a train-mode forward and every
    parameter's gradient against ``jax.grad`` (frozen BatchNorm statistics
    get zero gradients on both sides); V-Net with the same dropout masks on
    both sides."""
    cfg, shape = _case(name)
    if name == "dynunet_res_deep":
        # the stacked heads [B, 1 + heads, ...] meet a [B, ...] target by
        # broadcasting in both packages: batch 1, as the YAMLs train
        cfg, shape = {**cfg, "segmentation_module_res_block": True}, (1,) + shape[1:]
    x = _image(shape, seed=11)
    target = _labels(shape[:-1], seed=12)
    v = jax_vars(cfg, shape, seed=13)
    if name == "vnet":
        monkeypatch.setattr(fnn.Dropout, "__call__", _patched_flax_dropout(_drop_masks(14)))
    jloss, jgrads = _jax_loss_grads(cfg, v, x, target)
    want = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, cfg)
    limit = {k: GRAD_REL_L2 for k in want}
    if name.startswith("lambda"):  # rows reordered (the temporal lambda's slice groups kept whole)
        perm = np.roll(np.arange(shape[0]), shape[0] // 2)
        _, own = _jax_loss_grads(cfg, v, x[perm], target[perm])
        own = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, own)}, cfg)
        limit = {k: max(GRAD_REL_L2, 2 * _rel_l2(own[k].numpy(), want[k].numpy())) for k in want}
    model = port(cfg, v)
    masks = seg_blocks.dropout_masks(_drop_masks(14)) if name == "vnet" else torch.enable_grad()
    with masks:
        loss = ttt.segmentation_loss_fn(torch.from_numpy(target), model(torch.from_numpy(x), train=True), **LOSS)
    loss.backward()
    _close(loss, jloss)
    roundoff = 1e-6 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if float(np.abs(want[k].numpy()).max()) <= roundoff:
            assert float(g.abs().max()) <= roundoff, k
            continue
        assert _rel_l2(g.numpy(), want[k].numpy()) < limit[k], k


@pytest.mark.parametrize("name", sorted(MODELS) + ["lambda_live"])
def test_weights_carry_both_ways_bit_for_bit(name):
    """``zoo2_params_from_jax`` takes every leaf of the flax tree once (live
    BatchNorm statistics to buffers) and ``zoo2_params_to_jax`` gives the
    tree back, bit for bit; the input width (2 here) is read off the tree."""
    cfg = dict(MODELS["lambda" if name == "lambda_live" else name])
    if name == "lambda_live":
        cfg["train_batch_stats"] = True
    v = jax_vars(cfg, (B, H, W, 2), seed=21)
    state = zoo2_params_from_jax(v, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    back = zoo2_params_to_jax(model.state_dict(), cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if name == "lambda_live":
        assert any(k.endswith("running_mean") for k in state)


def test_batchnorm_cpu_gradient_takes_a_batch_one_gradient_of_any_strides():
    """A channels_last gradient of batch 1 whose batch stride is C (legal for
    an axis of size 1: the lambda layer's einsum backward hands BatchNorm
    one) against an NCHW input: the port's BatchNorm gives the gradients of
    the plain formula (PyTorch's CPU ``batch_norm`` backward misreads such a
    gradient; the port re-lays it)."""
    c, s = 16, 128
    x0 = torch.randn(1, c, s, s, generator=torch.Generator().manual_seed(3)) * 2 + 0.5
    g = torch.randn(1, s, s, c, generator=torch.Generator().manual_seed(4))
    g = torch.as_strided(g.contiguous(), (1, c, s, s), (c, 1, s * c, c))
    for live in (False, True):
        bn = tlayers.BatchNorm(c, live=live)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(5))
            bn.bias.normal_(generator=torch.Generator().manual_seed(6))
        got, want = [], []
        for out, grads in ((lambda x: bn(x, train=True), got), (None, want)):
            x = x0.clone().requires_grad_()
            if out is None:
                var, mean = torch.var_mean(x, dim=(0, 2, 3), keepdim=True, correction=0)
                y = (x - mean) * torch.rsqrt(var + bn.eps) * bn.weight[None, :, None, None] + bn.bias[None, :, None, None]
            else:
                y = out(x)
            grads.extend(torch.autograd.grad(y, (x, bn.weight, bn.bias), g))
        for a, b in zip(got, want):
            _close(a, b.detach().numpy())


def test_live_batchnorm_forward_and_statistics_match_jax():
    """The lambda U-Net with ``train_batch_stats``: a train-mode forward
    updates the running statistics as the JAX package's ``batch_stats``."""
    cfg = {**MODELS["lambda"], "train_batch_stats": True}
    x = _image((B, H, W, 1), seed=31)
    v = jax_vars(cfg, (B, H, W, 1), seed=32)
    out, mutated = jax.jit(functools.partial(_jm(_key(cfg)).apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    model = port(cfg, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True)
    _close(got, out)
    want = zoo2_params_from_jax({"params": v["params"], "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                                               mutated["batch_stats"])},
                               cfg)
    for k, b in model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            _close(b, want[k].numpy())


# ---- the wrappers and the registry ----


def test_the_eight_names_build_and_the_input_width_follows_the_data():
    """Every segmentation name builds (SEGMENTATION2DUNET is the U-Net), none
    is pending; the trunk is built at the first batch's width, not at the
    YAMLs' ``segmentation_module_input_channels``."""
    names = ["SEGMENTATIONUNET", "SEGMENTATION2DUNET", "SEGMENTATION3DUNET", "SEGMENTATIONATTENTIONUNET",
             "SEGMENTATIONLAMBDAUNET", "SEGMENTATIONVNET", "SEGMENTATIONDYNUNET", "SEGMENTATIONUNETR"]
    assert not set(names) & set(PENDING_MODELS)
    for name in names:
        model = build_model({"model_name": name, "segmentation_module_channels": 4,
                             "segmentation_module_input_channels": 2}, device="cpu")
        assert not model.materialized and not list(model.parameters())
    m = build_model({"model_name": "segmentation2dunet", "segmentation_module_channels": 4,
                     "segmentation_module_pooling_layers": 2, "segmentation_module_input_channels": 2}, device="cpu")
    assert isinstance(m, SegmentationUNet)
    m(torch.zeros(1, 16, 16, 1))
    assert m.trunk.down_sample_layers[0].layers[0].weight.shape[1] == 1


def test_trunk_weights_come_from_the_build_generator():
    """Two builds from the same generator seed draw the same trunk, whenever
    it is built; another seed draws another."""
    cfg = MODELS["attention"]
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    torch.manual_seed(0)
    a.materialize((1, H, W, 1))
    torch.manual_seed(1)
    b(torch.zeros(1, H, W, 1))
    c.materialize((1, H, W, 1))
    for (k, p), q, r in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(p, q), k
    assert any(not torch.equal(p, r) for p, r in zip(a.state_dict().values(), c.state_dict().values()))


@pytest.mark.parametrize("name", ["unet", "attention", "lambda", "vnet", "dynunet", "unetr", "unet3d"])
def test_bf16_forward_matches_jax_bf16(name):
    """``compute_dtype: bfloat16``: float32 logits; against the JAX package's
    bfloat16 forward on the same weights at relative l2 2e-2 (the mean over 4
    weight draws), the lambda U-Net no farther from the float32 forward than
    the JAX package's bfloat16 forward is (means over 8 draws): module
    docstring."""
    cfg32 = MODELS[name]
    cfg = {**cfg32, "compute_dtype": "bfloat16"}
    x = _image((B, H, W, 1), seed=41)
    to_jax, to_f32, jax_to_f32 = [], [], []
    for seed in range(8 if name == "lambda" else 4):
        v = jax_vars(cfg, (B, H, W, 1), seed=100 + seed)
        want = np.asarray(_jax_apply(_key(cfg), False)(v, jnp.asarray(x)))
        with torch.no_grad():
            got = port(cfg, v)(torch.from_numpy(x))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        to_jax.append(_rel_l2(got.numpy(), want))
        if name == "lambda":
            f32 = np.asarray(_jax_apply(_key(cfg32), False)(v, jnp.asarray(x)))
            to_f32.append(_rel_l2(got.numpy(), f32))
            jax_to_f32.append(_rel_l2(want, f32))
    if name == "lambda":
        assert np.mean(to_f32) <= np.mean(jax_to_f32), (to_f32, jax_to_f32)
    else:
        assert np.mean(to_jax) <= BF16_REL_L2, to_jax


# ---- losses ----


DICE_CASES = {
    "defaults": {},
    "softmax_background": {"sigmoid": False, "softmax": True, "include_background": True},
    "squared_jaccard": {"squared_pred": True, "jaccard": True},
    "batch": {"batch": True, "smooth_nr": 0.0, "smooth_dr": 1e-6},
    "onehot_y": {"to_onehot_y": True},
}


@pytest.mark.parametrize("case", list(DICE_CASES))
def test_dice_loss_and_its_gradient_match_jax(case):
    kw = DICE_CASES[case]
    logits = np.random.default_rng(51).standard_normal((B, 3, H, W, 3)).astype(np.float32)
    target = _labels((B, 3, H, W), classes=3, seed=52)
    jg = jax.grad(lambda p: jlosses.dice_loss(jnp.asarray(target), p, **kw)[1])(jnp.asarray(logits))
    js, jl = jlosses.dice_loss(jnp.asarray(target), jnp.asarray(logits), **kw)
    p = torch.from_numpy(logits).requires_grad_()
    ts, tl = tlosses.Dice(**kw)(torch.from_numpy(target), p)
    tl.backward()
    _close(ts, js)
    _close(tl, jl)
    _close(p.grad, jg)


@pytest.mark.parametrize("weight,smoothing", [(None, 0.0), ([0.2, 0.8], 0.0), ([1.0, 0.0], 0.1), (None, 0.2)])
def test_cross_entropy_and_its_gradient_match_jax(weight, smoothing):
    logits = np.random.default_rng(53).standard_normal((B, H, W, 2)).astype(np.float32)
    labels = np.random.default_rng(54).integers(0, 2, (B, H, W))
    f = lambda p: jlosses.cross_entropy_loss(jnp.asarray(labels), p, weight, smoothing)  # noqa: E731
    jl, jg = jax.value_and_grad(f)(jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    tl = tlosses.CrossEntropyLoss(weight=weight, label_smoothing=smoothing)(torch.from_numpy(labels), p)
    tl.backward()
    _close(tl, jl)
    _close(p.grad, jg)


@pytest.mark.parametrize("stacked", [False, True])
def test_segmentation_loss_trains_through_dice_alone(stacked):
    """The detached CE adds to the value, never to the gradient; a stack axis
    averages each term; the configured loss of a YAML block as the JAX
    package reads it."""
    model_cfg = {"segmentation_loss_fn": ["cross_entropy", "dice"], "cross_entropy_loss_weighting_factor": 0.3,
                 "dice_loss_weighting_factor": 0.7, "cross_entropy_loss_weight": [0.4, 0.6],
                 "dice_loss_squared_pred": True}
    cfg = ttt.seg_loss_cfg_from_model_cfg(model_cfg)
    assert cfg == jtt.seg_loss_cfg_from_model_cfg(model_cfg)
    shape = (3, B, H, W, 2) if stacked else (B, H, W, 2)
    logits = np.random.default_rng(55).standard_normal(shape).astype(np.float32)
    target = _labels((B, H, W), seed=56)
    jl, jg = jax.value_and_grad(lambda p: jtt.segmentation_loss_fn(jnp.asarray(target), p, **cfg))(
        jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    tl = ttt.segmentation_loss_fn(torch.from_numpy(target), p, **cfg)
    tl.backward()
    _close(tl, jl)
    _close(p.grad, jg)
    dice_only = ttt.segmentation_loss_fn(torch.from_numpy(target), p, **{**cfg, "use_ce": False})
    (g,) = torch.autograd.grad(dice_only, p)
    _close(p.grad, g)
    with pytest.raises(ValueError, match="ZERO gradient"):
        ttt.segmentation_loss_fn(torch.from_numpy(target), p, **{**cfg, "use_dice": False})


# ---- metrics and predicted classes ----


def _masks(seed, shape=(3, 12, 20, 20)):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) > 0.6
    m[1] = False  # a class absent on this side
    return m.astype(np.float32)


@pytest.mark.parametrize("seed", [61, 62])
def test_segmentation_metrics_are_the_jax_package_numbers(seed):
    t, p = _masks(seed), _masks(seed + 100)
    p[2] = False
    t[0] = False
    p[0] = False
    for inc in (False, True):
        assert tmetrics.SegmentationMetrics(inc)(t, p) == jmetrics.SegmentationMetrics(inc)(t, p)
    for fn in ("binary_dice", "binary_iou", "precision_recall_f1", "hausdorff_distance_95"):
        assert getattr(tmetrics, fn)(t[2], _masks(seed + 7)[2]) == getattr(jmetrics, fn)(t[2], _masks(seed + 7)[2])


def test_predicted_classes_are_one_hot_on_ties_and_multi_hot_by_threshold():
    logits = np.random.default_rng(63).standard_normal((2, 8, 8, 3)).astype(np.float32)
    logits[0, 0, 0] = [1.0, 1.0, 0.5]  # a tie
    one = ttt._seg_pred_classes(logits)
    np.testing.assert_array_equal(one, jtt._seg_pred_classes(logits))
    assert (one.sum(-1) == 1).all()
    thr = [0.2, None, "none"]
    np.testing.assert_array_equal(ttt._seg_pred_classes(logits, thr), jtt._seg_pred_classes(logits, thr))
