"""Port parity: the multitask models of mridc_tpu_torch against mridc_tpu's on
the CPU: the blocks (the weighted k-space DC, the channel-group statistics
and norms, the exposed-feature U-Net encoder and decoder), the helpers, the
ConvLSTM and ConvLSTMNormUnet, MTLRS (both ``dc_mode``s, each of the four
segmentation heads, with and without an initial prediction and the task
adaption, two cascades a block, a GRU trunk, magnitude input, bfloat16),
IDSLR, IDSLRUNet, SegNet (its train-mode stack), RecSegUNet and SERANet
(fewer coils than ``segmentation_module_input_channels``: the zero-coil
pad), the registry, the weight carry both ways and ``.mridc`` archives
restored by the other package.

Inputs are drawn with numpy from a seed at B=2, 2 coils, 32x32; weights are
drawn with numpy in the flax tree's shapes (``jax.eval_shape`` of the JAX
model's ``init``) and carried into the port by ``zoo2_params_from_jax``.
Forward outputs and segmentations: rtol 2e-3 / atol 2e-4 of the largest
magnitude (``tests/test_torch_parity.py:131``). Loss: the same; gradients:
per parameter at relative l2 1e-2 against ``jax.grad`` of the multitask
loss (the l1 reconstruction loss plus detached CE and Dice), as random
weights make the norm-U-Nets' LeakyReLU kinks flip between the packages
(``ROADMAP.md`` §1); a gradient that is zero but for roundoff is held to
roundoff. bfloat16 compute: relative l2 2e-2 of the prediction. Weights:
bit for bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.models import build_model as jbuild
from mridc_tpu.models.multitask import blocks as jblocks
from mridc_tpu.models.multitask import models as jmodels
from mridc_tpu.nn import convlstm as jconvlstm
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.train import task_trainers as jtt
from mridc_tpu.train.losses import process_reconstruction_loss as jrecon_loss
from mridc_tpu_torch.models import MODEL_REGISTRY, PENDING_MODELS, build_model
from mridc_tpu_torch.models.multitask import blocks as tblocks
from mridc_tpu_torch.models.multitask import models as tmodels
from mridc_tpu_torch.nn import convlstm as tconvlstm
from mridc_tpu_torch.train import checkpoints
from mridc_tpu_torch.train import task_trainers as ttt
from mridc_tpu_torch.train.losses import process_reconstruction_loss as trecon_loss
from mridc_tpu_torch.utils.params import _FROM, _scoped_pairs, zoo2_params_from_jax, zoo2_params_to_jax

RTOL, ATOL = 2e-3, 2e-4
GRAD_REL_L2 = 1e-2
BF16_REL_L2 = 2e-2
B, C, H, W = 2, 2, 32, 32
MTLRS_SMALL = {"model_name": "MTLRS", "joint_reconstruction_segmentation_module_cascades": 2,
               "reconstruction_module_time_steps": 2, "reconstruction_module_conv_filters": [8, 8, 2],
               "reconstruction_module_recurrent_filters": [8, 8, 0], "segmentation_module_channels": 4,
               "segmentation_module_pooling_layers": 2}
MODELS = {
    "mtlrs": MTLRS_SMALL,
    "idslr": {"model_name": "IDSLR", "num_iters": 2, "segmentation_module_channels": 4,
              "segmentation_module_pooling_layers": 2},
    "idslrunet": {"model_name": "IDSLRUNET", "num_iters": 2, "segmentation_module_channels": 4,
                  "segmentation_module_pooling_layers": 2},
    "segnet": {"model_name": "SegNet", "num_iters": 2, "segmentation_module_channels": 4,
               "segmentation_module_pooling_layers": 2},
    "recseg": {"model_name": "RecSegUNet", "reconstruction_module_channels": 4, "segmentation_module_channels": 4},
    "seranet": {"model_name": "SERANet", "reconstruction_module_channels": 4,
                "reconstruction_module_pooling_layers": 2, "segmentation_module_channels": 4,
                "segmentation_module_pooling_layers": 2, "recurrent_module_attention_channels": 4,
                "recurrent_module_attention_pooling_layers": 2, "num_iterations": 2},
}
VARIANTS = {  # name: (base, config changes, inputs: init_pred / psf1d mask / coils)
    "mtlrs_psf1d": ("mtlrs", {"dc_mode": "psf1d"}, {"psf1d": True}),
    "mtlrs_init_pred_unet_no_adaption": ("mtlrs", {"segmentation_module": "unet", "task_adaption_type": "none"},
                                         {"init_pred": True}),
    "mtlrs_lambdaunet": ("mtlrs", {"segmentation_module": "lambdaunet", "segmentation_module_channels": 8}, {}),
    "mtlrs_vnet_init_pred": ("mtlrs", {"segmentation_module": "vnet"}, {"init_pred": True}),
    "mtlrs_two_cascades_gru_magnitude": ("mtlrs", {"reconstruction_module_num_cascades": 2,
                                                   "reconstruction_module_recurrent_layer": "GRU",
                                                   "segmentation_module_input_channels": 1,
                                                   "magnitude_input": True}, {}),
    "idslr_rss_centered": ("idslr", {"coil_combination_method": "RSS", "fft_centered": True,
                                     "fft_normalization": "ortho"}, {}),
    "segnet_normalized": ("segnet", {"normalize": True, "padding": True, "magnitude_input": False}, {}),
    "recseg_two_channels": ("recseg", {"segmentation_module_input_channels": 2}, {"init_pred": True}),
    "seranet_one_coil": ("seranet", {}, {"coils": 1}),
}


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


def _key(cfg):
    return json.dumps(cfg, sort_keys=True)


@functools.lru_cache(maxsize=None)
def _jm(key):
    return jbuild(json.loads(key))


def _case(name):
    if name in MODELS:
        return dict(MODELS[name]), {}
    base, extra, inputs = VARIANTS[name]
    return {**MODELS[base], **extra}, inputs


def _data(inputs=None, seed=0):
    """(y, sens, mask, init_pred or None) as numpy: a 1D column mask (rows
    equal) for psf1d, a 2D random mask otherwise."""
    inputs = inputs or {}
    rng = np.random.default_rng(seed)
    coils = inputs.get("coils", C)
    y = rng.standard_normal((B, coils, H, W, 2)).astype(np.float32)
    sens = (0.5 * rng.standard_normal((B, coils, H, W, 2))).astype(np.float32)
    if inputs.get("psf1d"):
        cols = (rng.random((B, 1, 1, W)) < 0.4).astype(np.float32)
        cols[..., W // 2 - 2: W // 2 + 2] = 1.0
        mask = np.broadcast_to(cols, (B, 1, H, W)).copy()
    else:
        mask = (rng.random((B, 1, H, W)) < 0.4).astype(np.float32)
    y = y * mask[..., None]
    init = rng.standard_normal((B, H, W, 2)).astype(np.float32) if inputs.get("init_pred") else None
    return y, sens, mask, init


def _leaf(rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("var", "scale", "dc_weight"):
            return (1.0 + 0.1 * np.abs(rng.standard_normal(s.shape))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)  # bias, hh, mean
    return leaf


def jax_vars(cfg, data, seed=0):
    """flax variables of ``cfg``'s model for ``data``, drawn with numpy in the
    tree's shapes."""
    y, sens, mask, init = data
    args = [jnp.asarray(a) for a in (y, sens, mask)] + [None if init is None else jnp.asarray(init)]
    shapes = jax.eval_shape(_jm(_key(cfg)).init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(seed)), dict(shapes))


def port(cfg, v):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(zoo2_params_from_jax(v, cfg))
    return model


def _torch_inputs(data):
    return [None if a is None else torch.from_numpy(a) for a in data]


def _jax_apply(cfg, v, data, train=False):
    args = [None if a is None else jnp.asarray(a) for a in data]
    (out, seg) = _jm(_key(cfg)).apply(v, *args, train=train)
    return np.asarray(out.prediction), np.asarray(seg)


# ---- blocks and helpers ----


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_statistics_and_norms_match_jax(groups):
    """``group_stats`` (ddof 1), ``group_scale`` and ``apply_group_norm``
    (biased, eps 1e-5) on NHWC and on a 5D tensor, groups over the last axis."""
    x = np.random.default_rng(1).standard_normal((B, 6, 5, 8)).astype(np.float32)
    jm, js = jblocks.group_stats(jnp.asarray(x), groups)
    tm, ts = tblocks.group_stats(torch.from_numpy(x), groups)
    _close(tm, jm)
    _close(ts, js)
    _close(tblocks.group_scale(torch.from_numpy(x), 1.0 / ts, -tm / ts), jblocks._group_scale(jnp.asarray(x), 1.0 / js,
                                                                                                -jm / js))
    _close(tblocks.apply_group_norm(torch.from_numpy(x), groups), jblocks.apply_group_norm(jnp.asarray(x), groups))
    x5 = np.random.default_rng(2).standard_normal((B, 3, 4, 5, 2 * groups)).astype(np.float32)
    _close(tblocks.apply_group_norm(torch.from_numpy(x5), groups), jblocks.apply_group_norm(jnp.asarray(x5), groups))


def test_kspace_dc_matches_jax():
    """``(ref + w pred) / (m + w)`` with a 4D mask and a learned weight."""
    rng = np.random.default_rng(3)
    pred, ref = (rng.standard_normal((B, C, H, W, 2)).astype(np.float32) for _ in range(2))
    mask = (rng.random((B, 1, H, W)) < 0.5).astype(np.float32)
    want = jblocks.KSpaceDC().apply({"params": {"dc_weight": jnp.asarray([0.7])}}, jnp.asarray(pred),
                                    jnp.asarray(ref), jnp.asarray(mask))
    dc = tblocks.KSpaceDC()
    with torch.no_grad():
        dc.dc_weight.fill_(0.7)
        got = dc(torch.from_numpy(pred), torch.from_numpy(ref), torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("normalize,padding,size", [(True, True, (30, 26)), (False, False, (32, 32)),
                                                    (True, False, (32, 32))])
def test_unet_encoder_and_decoder_match_jax(normalize, padding, size):
    """The encoder's stack, pad sizes and statistics, and the decoder's output
    (the pad to ``((n - 1) | 11) + 1``, the reflect pad of the up path at odd
    sizes, the crop and the un-normalisation) on carried weights."""
    h, w = size
    x = np.random.default_rng(4).standard_normal((B, h, w, 4)).astype(np.float32)
    kw = dict(chans=4, num_pools=2, normalize=normalize, padding=padding)
    jenc, jdec = jblocks.UnetEncoder(**kw), jblocks.UnetDecoder(out_chans=4, **kw)

    def apply(v_enc, v_dec, x):
        stack, pads, mean, std = jenc.apply(v_enc, x)
        return stack, pads, jdec.apply(v_dec, stack, pads, mean, std)

    venc = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(5)),
                                            dict(jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.asarray(x))))
    stack0, pads0, mean0, std0 = jenc.apply(venc, jnp.asarray(x))
    vdec = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(6)), dict(jax.eval_shape(
        lambda: jdec.init(jax.random.PRNGKey(0), stack0, pads0, mean0, std0))))
    jstack, jpads, jout = apply(venc, vdec, jnp.asarray(x))
    tenc, tdec = tblocks.UnetEncoder(4, padding_size=11, **kw), tblocks.UnetDecoder(4, **kw)
    _load_scoped(tenc, venc["params"])
    _load_scoped(tdec, vdec["params"])
    with torch.no_grad():
        stack, pads, mean, std = tenc(torch.from_numpy(x))
        out = tdec(stack, pads, mean, std)
    assert pads == (jpads if padding else None)
    for got, want in zip(stack, jstack):
        _close(got.permute(0, 2, 3, 1), want)
    _close(out, jout)


def _load_scoped(module, params):
    """Load a flax param tree into ``module`` by the flax scopes its modules
    carry."""
    state = {}
    for _, f, p, kind in _scoped_pairs(module):
        node = params
        for scope in f.split("/"):
            node = node[scope]
        state[p] = torch.from_numpy(np.ascontiguousarray(_FROM[kind](np.asarray(node))))
    module.load_state_dict(state)


def test_norm_by_max_is_signed_and_splits_tied_gradients_like_jax():
    """``s / max(s)`` by the signed maximum (an all-negative map flips sign),
    1 below 1e-12, and the gradient at tied maxima split as JAX's ``max``."""
    for s in (np.array([[-3.0, -1.0, -2.0]], np.float32), np.zeros((1, 3), np.float32),
              np.array([[1.0, 4.0, 4.0, 2.0]], np.float32)):
        t = torch.from_numpy(s).requires_grad_(True)
        got = tmodels._norm_by_max(t)
        _close(got, jmodels._norm_by_max(jnp.asarray(s)))
        got.sum().backward()
        want = jax.grad(lambda a: jmodels._norm_by_max(a).sum())(jnp.asarray(s))
        _close(t.grad, want)


def test_channel_helpers_and_group_norm_nograd_match_jax():
    """The coil/channel folds both ways ([re coils..., im coils...]) and the
    no-gradient group norm (float32 out of a bfloat16 input, no gradient)."""
    x = np.random.default_rng(7).standard_normal((B, 3, 5, 4, 2)).astype(np.float32)
    got = tmodels._coils_to_channels(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmodels._coils_to_channels(jnp.asarray(x))))
    np.testing.assert_array_equal(tmodels._channels_to_coils(got).numpy(), x)
    xb = torch.from_numpy(x[..., 0]).to(torch.bfloat16).requires_grad_(True)
    normed = tmodels._group_norm_nograd(xb, 1)
    assert normed.dtype == torch.float32 and not normed.requires_grad
    _close(normed, jmodels._group_norm_nograd(jnp.asarray(x[..., 0], jnp.bfloat16), 1))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_convlstm_norm_unet_matches_jax(dtype):
    """ConvLSTMNormUnet alone: group norm (ddof 1, +1e-12), the pad to a
    multiple of 16 (30x26 here), one zero-state ConvLSTM step (gates i, f,
    o, g), the U-Net, crop and unnorm; bfloat16 at relative l2 2e-2."""
    x = np.random.default_rng(8).standard_normal((B, 30, 26, 3)).astype(np.float32)
    jm = jconvlstm.ConvLSTMNormUnet(chans=4, num_pools=2, in_chans=3, out_chans=2, dtype=dtype)
    v = jax.tree_util.tree_map_with_path(_leaf(np.random.default_rng(9)),
                                         dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tconvlstm.ConvLSTMNormUnet(4, 2, in_chans=3, out_chans=2, dtype=dtype)
    _load_scoped(tm, v["params"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if dtype is None:
        _close(got, want)
    else:
        assert _rel_l2(got.numpy(), want) < BF16_REL_L2


# ---- the models ----


@pytest.mark.parametrize("name", list(MODELS) + list(VARIANTS))
def test_forward_matches_jax(name):
    """Each model's inference prediction and segmentation against the JAX
    model on the same weights (MTLRS in both dc_modes, each head, with an
    initial prediction, without the task adaption; SERANet on one coil,
    zero-padded to its two segmentation input channels)."""
    cfg, inputs = _case(name)
    data = _data(inputs)
    v = jax_vars(cfg, data)
    jpred, jseg = _jax_apply(cfg, v, data)
    model = port(cfg, v)
    with torch.no_grad():
        out, seg = model(*_torch_inputs(data))
    _close(out.prediction, jpred)
    _close(seg, jseg)
    if name.startswith("mtlrs"):
        c_per = cfg.get("reconstruction_module_num_cascades", 1)
        assert out.intermediates.shape == (2 * c_per, 2, B, H, W, 2)


def test_segnet_train_mode_returns_the_stack_like_jax():
    """SegNet in train mode: the per-iteration segmentations and the fused
    one, stacked [3, B, H, W, classes], each normalised by its maximum."""
    cfg = MODELS["segnet"]
    data = _data()
    v = jax_vars(cfg, data)
    _, jseg = _jax_apply(cfg, v, data, train=True)
    with torch.no_grad():
        _, seg = port(cfg, v)(*_torch_inputs(data), train=True)
    assert seg.shape == (3, B, H, W, 2)
    _close(seg, jseg)


def _jax_loss_grads(cfg, v, data, target, labels):
    jm = _jm(_key(cfg))
    args = [None if a is None else jnp.asarray(a) for a in data]

    def loss(params):
        out, seg = jm.apply({**v, "params": params}, *args, train=True)
        return jrecon_loss(out, jnp.asarray(target), "l1", 1.0) + jtt.segmentation_loss_fn(
            jnp.asarray(labels), seg, **LOSS)

    return jax.jit(jax.value_and_grad(loss))(v["params"])


LOSS = {"use_ce": True, "use_dice": True, "ce_weight": 1.0, "dice_weight": 1.0,
        "dice_kwargs": {"include_background": False, "sigmoid": True, "batch": False}, "ce_kwargs": {}}


@pytest.mark.parametrize("name", ["mtlrs", "mtlrs_psf1d", "idslr", "idslrunet", "segnet", "recseg", "seranet"])
def test_loss_and_gradients_match_jax(name):
    """The multitask loss of a train-mode forward (the l1 reconstruction loss
    over MTLRS's intermediates, the segmentation loss over SegNet's stack)
    and every parameter's gradient against ``jax.grad``; MTLRS's heads run
    under ``torch.utils.checkpoint`` here."""
    cfg, inputs = _case(name)
    data = _data(inputs, seed=11)
    rng = np.random.default_rng(12)
    target = np.abs(rng.standard_normal((B, H, W))).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, H, W))]
    v = jax_vars(cfg, data, seed=13)
    jloss, jgrads = _jax_loss_grads(cfg, v, data, target, labels)
    want = zoo2_params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, cfg)
    model = port(cfg, v)
    out, seg = model(*_torch_inputs(data), train=True)
    loss = trecon_loss(out, torch.from_numpy(target), "l1", 1.0) + ttt.segmentation_loss_fn(
        torch.from_numpy(labels), seg, **LOSS)
    loss.backward()
    _close(loss, jloss)
    roundoff = 1e-6 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if float(np.abs(want[k].numpy()).max()) <= roundoff:
            assert float(g.abs().max()) <= roundoff, k
            continue
        assert _rel_l2(g.numpy(), want[k].numpy()) < GRAD_REL_L2, (k, _rel_l2(g.numpy(), want[k].numpy()))


@pytest.mark.parametrize("name", ["mtlrs", "idslr", "seranet"])
def test_bf16_compute_matches_jax_bf16(name):
    """``compute_dtype: bfloat16`` (MTLRS's trunk, IDSLR's U-Nets, SERANet's
    U-Net and ConvLSTMs): the prediction against the JAX package's bfloat16
    forward at relative l2 2e-2."""
    cfg = {**MODELS[name], "compute_dtype": "bfloat16"}
    data = _data()
    v = jax_vars(cfg, data, seed=3)
    jpred, _ = _jax_apply(cfg, v, data)
    with torch.no_grad():
        out, seg = port(cfg, v)(*_torch_inputs(data))
    assert _rel_l2(out.prediction.numpy(), jpred) < BF16_REL_L2
    assert torch.isfinite(seg).all()


# ---- registry, widths, weights, archives ----


def test_registry_builds_every_multitask_name_and_only_jointicnet_is_pending():
    """All 8 multitask names build; ``PENDING_MODELS``, which kept JointICNet
    alone until M8's second half was ported, is empty."""
    assert PENDING_MODELS == {} and "JOINTICNET" in MODEL_REGISTRY
    for name in ("MTLRS", "JRSCIRIM", "IDSLR", "IDSLRUNET", "SEGNET", "RECSEGNET", "RECSEGUNET", "SERANET"):
        assert name in MODEL_REGISTRY
    assert type(build_model({**MTLRS_SMALL, "model_name": "JRSCIRIM"}, device="cpu")).__name__ == "MTLRS"
    assert type(build_model({**MODELS["recseg"], "model_name": "RECSEGNET"}, device="cpu")).__name__ == "RecSegUNet"


@pytest.mark.parametrize("name", ["idslr", "idslrunet", "segnet", "seranet", "seranet_one_coil"])
def test_widths_follow_the_coils(name):
    """The four models whose widths follow the coil count build at the first
    forward (2 x coils, SERANet's at least 2 x ``seg_in_chans``), from the
    same generator the same weights as ``materialize``, and refuse other
    coil counts after."""
    cfg, inputs = _case(name)
    coils = inputs.get("coils", C)
    data = _data(inputs)
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert not a.materialized and not list(a.parameters())
    with torch.no_grad():
        a(*_torch_inputs(data))
    b.materialize(coils)
    assert a.width == b.width == 2 * max(coils, 2 if name.startswith("seranet") else coils)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match="input channels"):
        b.materialize(coils + 2)


@pytest.mark.parametrize("name", list(MODELS) + ["mtlrs_lambdaunet_live", "mtlrs_vnet_init_pred"])
def test_weights_carry_both_ways_bit_for_bit(name):
    """``zoo2_params_from_jax`` takes every leaf of the flax tree once and
    ``zoo2_params_to_jax`` gives it back bit for bit (MTLRS's explicitly named
    heads, the DC weights, the ConvLSTMs' gate convs, live statistics)."""
    if name == "mtlrs_lambdaunet_live":
        cfg, inputs = {**_case("mtlrs_lambdaunet")[0], "train_batch_stats": True}, {}
    else:
        cfg, inputs = _case(name)
    v = jax_vars(cfg, _data(inputs), seed=21)
    state = zoo2_params_from_jax(v, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    back = zoo2_params_to_jax(model.state_dict(), cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    if name == "mtlrs_lambdaunet_live":
        assert any(k.endswith("running_mean") for k in state)


@pytest.mark.parametrize("name", list(MODELS))
def test_archives_both_ways(tmp_path, name):
    """A ``mridc_tpu`` archive restores in the port to the mapped weights, and
    the port's archive (flax msgpack) restores in ``mridc_tpu`` to the
    port's weights."""
    cfg, _ = _case(name)
    v = jax_vars(cfg, _data(), seed=31)
    jpath = jckpt.save_archive(tmp_path / "j.mridc", cfg, v["params"])
    model, state, _ = checkpoints.restore_model(jpath, device="cpu")
    for k, t in zoo2_params_from_jax(v, cfg).items():
        assert torch.equal(state[k], t), k
    ppath = checkpoints.save_archive(tmp_path / "p.mridc", cfg, model.state_dict())
    _, jparams, jcfg = jckpt.restore_model(ppath)
    assert jcfg["model_name"] == cfg["model_name"]
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(v["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
