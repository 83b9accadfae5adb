"""Task trainers (counterpart of ``mridc_tpu/train/task_trainers.py``): the
segmentation, multitask and quantitative trainers.

:func:`segmentation_loss_fn` is the reference's CE + Dice combination: the
cross-entropy is evaluated on detached logits (it adds to the loss's value
but never to a gradient: only Dice trains), logits with a leading stack axis
(one more axis than the target) average each term over it. The config keys
translate as ``seg_loss_cfg_from_model_cfg`` reads them.
:class:`SegmentationTrainer` trains on ``{"image" [B, H, W, C_in],
"segmentation" [B, H, W, classes]}`` batches; ``validate`` reports
``val_loss`` and ``val_DICE`` (a mean over slices), reduced over processes;
``test`` writes each volume's predicted classes and its Dice, IoU, F1 and
HD95 against its labels (the JAX package's inherited ``test`` reads a
``target`` that segmentation batches do not carry). Consecutive slices
([B, S, H, W, C_in], the 5-slice lambda config) reach a 2D trunk folded to
[B * S, ...] in the (g, t) row order the temporal lambda groups, and its
logits are unfolded to [B, S, H, W, classes] before the loss and the
metrics; the 3D U-Net takes them as volumes (the JAX package's lambda layer
cannot unpack a 5D batch).

:class:`MultitaskTrainer` trains a joint reconstruction-segmentation model
on the reconstruction batches of ``RSBatchLoader`` with their
``segmentation`` [B, H, W, classes]: the loss is ``w_rec *
process_reconstruction_loss + w_seg * segmentation_loss_fn`` (a SegNet's
train-mode stack of segmentations averages each term over it), and a step
reports ``recon_loss``, ``seg_loss`` and ``grad_norm``; ``predict_batch``
returns (prediction, segmentation logits); ``validate`` reports
``val_loss`` (the l1 of the max-normalised magnitudes), ``val_SSIM`` and
``val_DICE``; ``test`` writes each volume's reconstruction and predicted
classes with SSIM, PSNR, NMSE and MSE and DICE, IOU, F1 and HD95 (the JAX
package's inherited ``test`` indexes the (prediction, segmentation) pair as
if it were the batch of predictions, and its SSIM raises ``ValueError`` on
the shapes that gives).
The models whose widths follow the coil count are built at the first
batch's (``init_state``).

:func:`quantitative_loss_fn` is the reference's per-map loss with
accumulate-estimates semantics: per (cascade, time step, map) the target and
the prediction are each normalised by their own abs-max (``torch.amax``:
tied maxima share the gradient, as JAX's ``max`` splits it), gated by
|mask_brain|, l1/mse divided (ssim multiplied) by the map's factor; the
per-map total is summed over the steps and cascades and divided by C * C,
and the loss is the mean over the maps over 2.
:func:`quantitative_recon_loss_fn` is the per-echo reconstruction loss a
folded reconstruction module adds (l1/mse; ssim is refused, as the JAX
package refuses it).

:class:`QuantitativeTrainer` is the port's :class:`~mridc_tpu_torch.train.
trainer.Trainer` (``fit``, checkpoints, EMA, accumulation and the schedules
come with it) on quantitative batches: ``{"kspace" [B, E, C, H, W, 2],
"sensitivity_maps", "mask" [B, 1, H, W], "maps_init" [B, H, W, 4],
"maps_target", "TEs" [E], optional "mask_brain" [B, H, W], "target" [B, E, H,
W, 2]}``. ``validate`` reports ``val_loss`` (with the reconstruction loss
where the model has the module) and the NMSE of each map, reduced over
processes. ``test`` writes the predicted maps of each volume, [S, H, W, 4]
(the JAX package's inherited ``test`` reads a ``target`` that quantitative
batches carry only with the reconstruction module, and then of another
shape).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from mridc_tpu_torch.losses.segmentation import cross_entropy_loss, dice_loss
from mridc_tpu_torch.losses.ssim import ssim_loss
from mridc_tpu_torch.metrics.reconstruction import METRIC_FUNCS, ReconstructionMetrics, ssim
from mridc_tpu_torch.metrics.segmentation import SegmentationMetrics
from mridc_tpu_torch.parallel.multihost import reduce_mean_stats
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.trainer import Trainer, _host, _host_mag

__all__ = ["SegmentationTrainer", "MultitaskTrainer", "QuantitativeTrainer", "segmentation_loss_fn",
           "seg_loss_cfg_from_model_cfg",
           "quantitative_loss_fn", "quantitative_recon_loss_fn", "parse_loss_regularization_factors"]


def segmentation_loss_fn(target: torch.Tensor, logits: torch.Tensor, use_ce: bool = True, use_dice: bool = True,
                         ce_weight: float = 1.0, dice_weight: float = 1.0, dice_kwargs: Optional[Dict] = None,
                         ce_kwargs: Optional[Dict] = None, detach_ce: bool = True) -> torch.Tensor:
    """Weighted CE + Dice of ``logits`` against the one-hot ``target`` (module
    docstring); Dice's defaults are the reference's (no background, sigmoid,
    no batch reduction)."""
    if use_ce and not use_dice and detach_ce:
        raise ValueError("segmentation_loss_fn: cross-entropy-only with detach_ce=True has ZERO gradient everywhere "
                         "(the reference's CE is computed detached and only Dice trains) — pass detach_ce=False or "
                         "enable dice")
    preds = logits if logits.ndim == target.ndim + 1 else logits[None]
    loss = torch.zeros((), device=logits.device)
    if use_ce:
        labels = target.argmax(-1)
        ce_in = preds.detach() if detach_ce else preds
        ce = torch.stack([cross_entropy_loss(labels, ce_in[i], **(ce_kwargs or {})) for i in range(preds.shape[0])])
        loss = loss + ce_weight * ce.mean()
    if use_dice:
        kw = dict(include_background=False, softmax=False, sigmoid=True, batch=False)
        kw.update(dice_kwargs or {})
        dl = torch.stack([dice_loss(target, preds[i], **kw)[1] for i in range(preds.shape[0])])
        loss = loss + dice_weight * dl.mean()
    return loss


def seg_loss_cfg_from_model_cfg(model_cfg: Dict) -> Dict:
    """The reference YAML's ``segmentation_loss_fn``, ``cross_entropy_loss_*``
    and ``dice_loss_*`` keys as :func:`segmentation_loss_fn`'s arguments."""
    fns = model_cfg.get("segmentation_loss_fn", ["cross_entropy", "dice"])
    if isinstance(fns, str):
        fns = [fns]
    fns = list(fns or [])
    ce_w = model_cfg.get("cross_entropy_loss_weight")
    dice_kwargs = dict(
        include_background=bool(model_cfg.get("dice_loss_include_background", False)),
        to_onehot_y=bool(model_cfg.get("dice_loss_to_onehot_y", False)),
        sigmoid=bool(model_cfg.get("dice_loss_sigmoid", True)),
        softmax=bool(model_cfg.get("dice_loss_softmax", False)),
        squared_pred=bool(model_cfg.get("dice_loss_squared_pred", False)),
        jaccard=bool(model_cfg.get("dice_loss_jaccard", False)),
        smooth_nr=float(model_cfg.get("dice_loss_smooth_nr", 1e-5)),
        smooth_dr=float(model_cfg.get("dice_loss_smooth_dr", 1e-5)),
        batch=bool(model_cfg.get("dice_loss_batch", False)),
    )
    if ce_w in (None, "none", "None"):
        ce_w = None
    elif not isinstance(ce_w, (list, tuple)):
        ce_w = [float(ce_w)]  # the reference's torch.tensor() takes scalars
    else:
        ce_w = list(ce_w)
    return dict(
        use_ce="cross_entropy" in fns,
        use_dice="dice" in fns,
        ce_weight=float(model_cfg.get("cross_entropy_loss_weighting_factor", 1.0)),
        dice_weight=float(model_cfg.get("dice_loss_weighting_factor", 1.0)),
        dice_kwargs=dice_kwargs,
        ce_kwargs=dict(label_smoothing=float(model_cfg.get("cross_entropy_loss_label_smoothing", 0.0)), weight=ce_w),
    )


def _logits_joined(trainer: Trainer, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Segmentation logits joined over the processes along their batch axis
    (axis 1 under a leading stack axis: one more axis than the target)."""
    return trainer._joined(logits, 1 if logits.ndim == target.ndim + 1 else 0)


def _tie_safe_onehot(logits: np.ndarray) -> np.ndarray:
    """One-hot of the argmax: exactly one class per pixel, ties included."""
    return np.eye(logits.shape[-1], dtype=np.float32)[logits.argmax(-1)]


def _seg_pred_classes(logits: np.ndarray, thresholds=None) -> np.ndarray:
    """Predicted classes: each class thresholded on its own where
    ``segmentation_classes_thresholds`` is set (multi-hot), else the one-hot
    argmax."""
    if thresholds:
        thr = np.asarray([0.5 if t in (None, "none", "None") else float(t) for t in thresholds], np.float32)
        return (logits > thr).astype(np.float32)
    return _tie_safe_onehot(logits)


class SegmentationTrainer(Trainer):
    """Segmentation training and evaluation (module docstring) with the loss
    of ``seg_loss_cfg`` (:func:`segmentation_loss_fn`'s arguments)."""

    def __init__(self, *args, seg_loss_cfg: Optional[Dict] = None, segmentation_classes_thresholds=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.seg_loss_cfg = dict(seg_loss_cfg or {})
        self.segmentation_classes_thresholds = segmentation_classes_thresholds

    def _image(self, batch: Dict):
        """The model's input on the device and the [B, S] of a folded batch
        (None when it is not folded)."""
        image = self._tensor(batch["image"])
        if image.ndim == 5 and not getattr(self.model, "volumetric", False):
            return image.reshape((-1,) + tuple(image.shape[2:])), tuple(image.shape[:2])
        return image, None

    @staticmethod
    def _unfold(logits: torch.Tensor, fold) -> torch.Tensor:
        return logits if fold is None else logits.reshape(tuple(fold) + tuple(logits.shape[1:]))

    def init_state(self, sample_batch: Optional[Dict] = None):
        """The optimizer over the model's parameters; the trunk is built first
        at ``sample_batch``'s image width (and UNETR's patch count)."""
        model = self.model
        if not getattr(model, "materialized", True):
            if sample_batch is None:
                raise ValueError(f"{type(model).__name__} takes its input width from the data: init_state needs a "
                                 "batch")
            model.materialize(tuple(self._image(sample_batch)[0].shape), self.device)
        return super().init_state(sample_batch)

    def training_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One training step: ``{"loss", "grad_norm"}``."""
        if self.state is None:
            self.init_state(batch)
        image, fold = self._image(batch)
        logits = self._unfold(self.model(image, train=True), fold)
        target = self._tensor(batch["segmentation"])
        loss = segmentation_loss_fn(self._joined(target), _logits_joined(self, logits, target), **self.seg_loss_cfg)
        return {"loss": loss.detach(), "grad_norm": self._apply_loss(loss)}

    def predict_batch(self, batch: Dict, use_ema: bool = False) -> np.ndarray:
        """The logits [B, (S,) H, W, classes] (inference, no gradients),
        float32 on the host."""
        image, fold = self._image(batch)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if use_ema and self.state is not None and self.state.ema_params is not None:
                    out = torch.func.functional_call(self.model, self.state.ema_params, (image,))
                else:
                    out = self.model(image)
        finally:
            self.model.train(was_training)
        return _host(self._unfold(out, fold).float())

    def validate(self, val_loader: Iterable, use_ema: Optional[bool] = None,
                 limit: Optional[int] = None) -> Dict[str, float]:
        """``val_loss`` (the training loss of the inference logits, a mean over
        batches) and ``val_DICE`` (a mean over slices), reduced over
        processes."""
        use_ema = self.use_ema if use_ema is None else use_ema
        metrics = SegmentationMetrics()
        dices, losses = [], []
        for batch_idx, batch in enumerate(val_loader):
            if limit is not None and batch_idx >= limit:
                break
            logits = self.predict_batch(batch, use_ema=use_ema)
            target = _host(batch["segmentation"])
            losses.append(float(segmentation_loss_fn(torch.from_numpy(target), torch.from_numpy(logits),
                                                     **self.seg_loss_cfg)))
            pred = _seg_pred_classes(logits, self.segmentation_classes_thresholds)
            for i in range(target.shape[0]):
                dices.append(metrics(np.moveaxis(target[i], -1, 0), np.moveaxis(pred[i], -1, 0))["DICE"])
        reduced = reduce_mean_stats({"loss": float(np.sum(losses)), "DICE": float(np.sum(dices))},
                                    {"loss": float(len(losses)), "DICE": float(len(dices))})
        return {"val_loss": reduced["loss"], "val_DICE": reduced["DICE"]}

    def test(self, test_loader: Iterable, use_ema: Optional[bool] = None):
        """Per-volume predicted classes by file name (the slices, or the
        windows of consecutive slices, in order: [S, (window,) H, W, classes]
        float32), and each volume's DICE, IOU, F1 and HD95 against its labels,
        means over volumes reduced over processes."""
        use_ema = self.use_ema if use_ema is None else use_ema
        preds: Dict[str, list] = {}
        labels: Dict[str, list] = {}
        for batch in test_loader:
            pred = _seg_pred_classes(self.predict_batch(batch, use_ema=use_ema), self.segmentation_classes_thresholds)
            target = _host(batch["segmentation"])
            for i, fname in enumerate(batch["fname"]):
                preds.setdefault(fname, []).append((int(batch["slice_idx"][i]), pred[i]))
                labels.setdefault(fname, []).append((int(batch["slice_idx"][i]), target[i]))
        metrics = SegmentationMetrics()
        volumes, sums = {}, {"DICE": 0.0, "IOU": 0.0, "F1": 0.0, "HD95": 0.0}
        for fname, slices in preds.items():
            vol = np.stack([s for _, s in sorted(slices, key=lambda x: x[0])])
            tgt = np.stack([s for _, s in sorted(labels[fname], key=lambda x: x[0])])
            volumes[fname] = vol
            for k, v in metrics(np.moveaxis(tgt, -1, 0), np.moveaxis(vol, -1, 0)).items():
                sums[k] += v
        return volumes, reduce_mean_stats(sums, {k: float(len(volumes)) for k in sums})


class MultitaskTrainer(Trainer):
    """Joint reconstruction and segmentation training and evaluation (module
    docstring): ``segmentation_loss_weight`` and
    ``reconstruction_loss_weight`` (the YAMLs' ``total_*_loss_weight``),
    ``seg_loss_cfg`` (:func:`segmentation_loss_fn`'s arguments)."""

    def __init__(self, *args, segmentation_loss_weight: float = 1.0, reconstruction_loss_weight: float = 1.0,
                 seg_loss_cfg: Optional[Dict] = None, segmentation_classes_thresholds=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.segmentation_loss_weight = float(segmentation_loss_weight)
        self.reconstruction_loss_weight = float(reconstruction_loss_weight)
        self.seg_loss_cfg = dict(seg_loss_cfg or {})
        self.segmentation_classes_thresholds = segmentation_classes_thresholds

    def init_state(self, sample_batch: Optional[Dict] = None):
        """The optimizer over the model's parameters; a model whose widths
        follow the coil count is built first at ``sample_batch``'s."""
        model = self.model
        if not getattr(model, "materialized", True):
            if sample_batch is None:
                raise ValueError(f"{type(model).__name__} takes its widths from the data: init_state needs a batch")
            model.materialize(int(np.shape(sample_batch["masked_kspace"])[-4]), self.device)
        return super().init_state(sample_batch)

    def training_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One training step: ``{"loss", "recon_loss", "seg_loss",
        "grad_norm"}``."""
        if self.state is None:
            self.init_state(batch)
        out, seg_logits = self.model(*self._model_inputs(batch), train=True)
        recon = process_reconstruction_loss(self._joined_output(out), self._joined(self._tensor(batch["target"])),
                                            self.loss_type, self.loss_regularization_factor)
        target = self._tensor(batch["segmentation"])
        seg = segmentation_loss_fn(self._joined(target), _logits_joined(self, seg_logits, target), **self.seg_loss_cfg)
        loss = self.reconstruction_loss_weight * recon + self.segmentation_loss_weight * seg
        return {"loss": loss.detach(), "recon_loss": recon.detach(), "seg_loss": seg.detach(),
                "grad_norm": self._apply_loss(loss)}

    def predict_batch(self, batch: Dict, use_ema: bool = False):
        """(prediction [B, H, W, 2], segmentation logits [B, H, W, classes])
        of the inference forward, float32 on the host."""
        inputs = self._model_inputs(batch)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if use_ema and self.state is not None and self.state.ema_params is not None:
                    out, seg = torch.func.functional_call(self.model, self.state.ema_params, inputs)
                else:
                    out, seg = self.model(*inputs)
        finally:
            self.model.train(was_training)
        return _host(out.prediction.float()), _host(seg.float())

    def validate(self, val_loader: Iterable, use_ema: Optional[bool] = None,
                 limit: Optional[int] = None) -> Dict[str, float]:
        """``val_loss`` (a mean over batches), ``val_SSIM`` and ``val_DICE``
        (means over slices), reduced over processes."""
        use_ema = self.use_ema if use_ema is None else use_ema
        seg_metrics = SegmentationMetrics()
        losses, ssims, dices = [], [], []
        for batch_idx, batch in enumerate(val_loader):
            if limit is not None and batch_idx >= limit:
                break
            pred, seg_logits = self.predict_batch(batch, use_ema=use_ema)
            t, p = _host_mag(batch["target"]), _host_mag(pred)
            t = t / (t.max() or 1.0)
            p = p / (p.max() or 1.0)
            losses.append(float(np.abs(t - p).mean()))
            self._maybe_log_val_images(batch_idx, t, p)
            seg_target = _host(batch["segmentation"])
            seg_pred = _seg_pred_classes(seg_logits, self.segmentation_classes_thresholds)
            for i in range(t.shape[0]):
                ssims.append(ssim(t[i: i + 1], p[i: i + 1]))
                dices.append(seg_metrics(np.moveaxis(seg_target[i], -1, 0), np.moveaxis(seg_pred[i], -1, 0))["DICE"])
        reduced = reduce_mean_stats(
            {"loss": float(np.sum(losses)), "SSIM": float(np.sum(ssims)), "DICE": float(np.sum(dices))},
            {"loss": float(len(losses)), "SSIM": float(len(ssims)), "DICE": float(len(dices))})
        return {"val_loss": reduced["loss"], "val_SSIM": reduced["SSIM"], "val_DICE": reduced["DICE"]}

    def test(self, test_loader: Iterable, use_ema: Optional[bool] = None):
        """Per volume by file name (slices in order): ``{"reconstruction": [S,
        H, W] magnitudes normalised to their maximum, "segmentation": [S, H,
        W, classes] predicted classes}``; and the means over volumes, reduced
        over processes, of the reconstruction's SSIM, PSNR, NMSE and MSE
        against the target (each normalised to its maximum) and of the
        classes' DICE, IOU, F1 and HD95 against the labels."""
        use_ema = self.use_ema if use_ema is None else use_ema
        slices: Dict[str, list] = {}
        for batch in test_loader:
            pred, seg_logits = self.predict_batch(batch, use_ema=use_ema)
            classes = _seg_pred_classes(seg_logits, self.segmentation_classes_thresholds)
            target, labels = _host(batch["target"]), _host(batch["segmentation"])
            for i, fname in enumerate(batch["fname"]):
                slices.setdefault(fname, []).append((int(batch["slice_idx"][i]), _host_mag(pred[i]), classes[i],
                                                     _host_mag(target[i]), labels[i]))
        recon_metrics, seg_metrics = ReconstructionMetrics(METRIC_FUNCS), SegmentationMetrics()
        volumes, seg_sums = {}, {"DICE": 0.0, "IOU": 0.0, "F1": 0.0, "HD95": 0.0}
        for fname, rows in slices.items():
            rows = sorted(rows, key=lambda r: r[0])
            vol, cls, tgt, lab = (np.stack([r[j] for r in rows]) for j in range(1, 5))
            vol = vol / (vol.max() or 1.0)
            recon_metrics.push(tgt / (tgt.max() or 1.0), vol)
            for k, v in seg_metrics(np.moveaxis(lab, -1, 0), np.moveaxis(cls, -1, 0)).items():
                seg_sums[k] += v
            volumes[fname] = {"reconstruction": vol, "segmentation": cls}
        sums = {k: st.mean() * st.n for k, st in recon_metrics.metrics_scores.items()}
        counts = {k: float(st.n) for k, st in recon_metrics.metrics_scores.items()}
        sums.update(seg_sums)
        counts.update({k: float(len(volumes)) for k in seg_sums})
        return volumes, reduce_mean_stats(sums, counts)


_QMAP_NAMES = ("R2star", "S0", "B0", "phi")


def parse_loss_regularization_factors(factors) -> torch.Tensor:
    """The reference YAML's list of single-key dicts (``[{R2star: 3.0},
    {S0: 1.0}, ...]``), a flat dict, a list of 4 floats, a scalar, or None
    (all ones) -> float32 [4] in (R2*, S0, B0, phi) order."""
    if factors is None:
        return torch.ones(4, dtype=torch.float32)
    if isinstance(factors, dict):
        return torch.tensor([float(factors.get(n, 1.0)) for n in _QMAP_NAMES], dtype=torch.float32)
    if isinstance(factors, (list, tuple)):
        if all(isinstance(f, dict) for f in factors):
            merged: Dict = {}
            for f in factors:
                merged.update(f)
            return torch.tensor([float(merged.get(n, 1.0)) for n in _QMAP_NAMES], dtype=torch.float32)
        return torch.tensor([float(f) for f in factors], dtype=torch.float32)
    return torch.full((4,), float(factors), dtype=torch.float32)


def _floor(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.maximum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def quantitative_loss_fn(maps_target, preds, mask_brain, factors, loss_type: str = "ssim"):
    """``maps_target`` [B, H, W, 4], ``preds`` [C, T, B, H, W, 4] (both
    unnormalised), ``mask_brain`` [B, H, W] or None, ``factors`` [4] ->
    ``(total, per_map [4])``."""
    n_casc = preds.shape[0]
    factors = torch.as_tensor(factors, dtype=preds.dtype, device=preds.device)
    if mask_brain is not None:
        m = torch.abs(mask_brain).to(preds.dtype)
    else:
        m = torch.ones(maps_target.shape[:3], dtype=preds.dtype, device=preds.device)
    xn = maps_target / _floor(torch.amax(torch.abs(maps_target), dim=(0, 1, 2), keepdim=True), 1e-12)
    yn = preds / _floor(torch.amax(torch.abs(preds), dim=(2, 3, 4), keepdim=True), 1e-12)
    xm = xn * m[..., None]
    ym = yn * m[None, None, ..., None]
    lt = str(loss_type).lower()
    if "ssim" in lt:
        dr = torch.amax(torch.abs(yn), dim=(2, 3, 4)) - torch.amin(torch.abs(yn), dim=(2, 3, 4))  # [C, T, 4]
        xq = xm.movedim(-1, 0)  # [4, B, H, W]
        yq = ym.movedim(-1, 2)  # [C, T, 4, B, H, W]
        b = xq.shape[1]
        losses = torch.stack([
            torch.stack([
                torch.stack([ssim_loss(xq[q], yq[c, t, q], dr[c, t, q].expand(b)) for q in range(4)])
                for t in range(yq.shape[1])])
            for c in range(n_casc)])
        losses = losses * factors
    else:
        diff = xm[None, None] - ym
        per = (diff**2).mean(dim=(2, 3, 4)) if ("mse" in lt or lt == "l2") else torch.abs(diff).mean(dim=(2, 3, 4))
        losses = per / factors
    per_map = losses.sum(dim=(0, 1)) / (n_casc * n_casc)
    return per_map.mean() / 2.0, per_map


def quantitative_recon_loss_fn(target, recon_intermediates, loss_type: str = "l1") -> torch.Tensor:
    """The per-echo reconstruction loss: ``target`` [B, E, H, W, 2],
    ``recon_intermediates`` [E, C, T, B, H, W, 2]; per (echo, cascade) the
    sum over the steps of the l1/mse against the max-normalised magnitudes,
    times ``sum(logspace(-1, 0, T)) / T``; the mean over the cascades (sum /
    C) and the echoes."""
    lt = str(loss_type).lower()
    if "ssim" in lt:
        raise ValueError("quantitative reconstruction loss supports l1/mse only (the reference ssim branch is "
                         "shape-invalid; see PARITY.md)")
    e_dim, n_casc, t_steps = recon_intermediates.shape[:3]
    tgt = torch.abs(target) / _floor(torch.amax(torch.abs(target)), 1e-12)
    x = tgt.movedim(1, 0)  # [E, B, H, W, 2]
    x = x / _floor(torch.amax(torch.abs(x), dim=(1, 2, 3, 4), keepdim=True), 1e-12)
    y = torch.abs(recon_intermediates)
    y = y / _floor(torch.amax(y, dim=(3, 4, 5, 6), keepdim=True), 1e-12)
    diff = x[:, None, None] - y
    per_ect = (diff**2).mean(dim=(3, 4, 5, 6)) if ("mse" in lt or lt == "l2") else \
        torch.abs(diff).mean(dim=(3, 4, 5, 6))
    w_sum = float(np.sum(np.logspace(-1, 0, t_steps)))
    per_ec = per_ect.sum(dim=2) * (w_sum / t_steps)
    return (per_ec.sum(dim=1) / n_casc).sum() / e_dim


class QuantitativeTrainer(Trainer):
    """qMRI training with the per-map regularised loss (module docstring);
    ``loss_regularization_factors`` in any form
    :func:`parse_loss_regularization_factors` takes."""

    def __init__(self, *args, loss_regularization_factors=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.loss_regularization_factors = parse_loss_regularization_factors(loss_regularization_factors)

    def init_state(self, sample_batch: Optional[Dict] = None):
        """The optimizer over the model's parameters; a model whose widths
        follow the data (qVarNet's regularisers) is built first at
        ``sample_batch``'s."""
        model = self.model
        if not getattr(model, "materialized", True):
            if sample_batch is None:
                raise ValueError(f"{type(model).__name__} takes its widths from the data: init_state needs a batch")
            model.materialize(model.input_channels(tuple(sample_batch["kspace"].shape)), self.device)
        return super().init_state(sample_batch)

    def _inputs(self, batch: Dict):
        """(y, sens, mask, maps_init, TEs) on the device."""
        return (self._tensor(batch["kspace"]), self._tensor(batch["sensitivity_maps"]), self._tensor(batch["mask"]),
                self._tensor(batch["maps_init"]), self._tensor(batch["TEs"]).float())

    def _unnormalized_preds(self, out) -> torch.Tensor:
        """[C, T, B, H, W, 4]: the intermediates (gamma-normalised) times
        gamma, or the prediction alone."""
        if out.intermediates is not None and out.intermediates.ndim == out.prediction.ndim + 2:
            gamma = torch.tensor(getattr(self.model, "gamma", (1.0, 1.0, 1.0, 1.0)), dtype=torch.float32,
                                 device=out.intermediates.device)
            return out.intermediates * gamma
        return out.prediction[None, None]

    def training_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One training step: ``{"loss", "recon_loss", "grad_norm"}``."""
        if self.state is None:
            self.init_state(batch)
        out = self._joined_output(self.model(*self._inputs(batch), train=True))
        mask_brain = self._joined(self._tensor(batch["mask_brain"])) if "mask_brain" in batch else None
        total, _ = quantitative_loss_fn(self._joined(self._tensor(batch["maps_target"])),
                                        self._unnormalized_preds(out), mask_brain, self.loss_regularization_factors,
                                        self.loss_type)
        lossrecon = torch.zeros((), device=self.device)
        if getattr(self.model, "use_reconstruction_module", False) and "target" in batch \
                and out.recon_intermediates is not None:
            lossrecon = quantitative_recon_loss_fn(self._joined(self._tensor(batch["target"])),
                                                   out.recon_intermediates, self.loss_type)
        loss = total + lossrecon
        return {"loss": loss.detach(), "recon_loss": lossrecon.detach(), "grad_norm": self._apply_loss(loss)}

    def _eval_forward(self, batch: Dict, use_ema: bool):
        inputs = self._inputs(batch)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if use_ema and self.state is not None and self.state.ema_params is not None:
                    return torch.func.functional_call(self.model, self.state.ema_params, inputs)
                return self.model(*inputs)
        finally:
            self.model.train(was_training)

    def predict_batch(self, batch: Dict, use_ema: bool = False) -> np.ndarray:
        """The predicted maps [B, H, W, 4] (inference, no gradients), float32
        on the host."""
        return _host(self._eval_forward(batch, use_ema).prediction.float())

    def _val_recon_loss(self, batch: Dict, use_ema: bool) -> Optional[float]:
        """The reconstruction loss term of ``val_loss`` (a model with the
        module, a batch with a target, an l1/mse validation loss)."""
        if not getattr(self.model, "use_reconstruction_module", False) or "target" not in batch:
            return None
        if "ssim" in str(self.val_loss_type).lower():
            return None
        out = self._eval_forward(batch, use_ema)
        if out.recon_intermediates is None:
            return 0.0
        return float(quantitative_recon_loss_fn(self._tensor(batch["target"]), out.recon_intermediates,
                                                self.val_loss_type))

    def validate(self, val_loader: Iterable, use_ema: Optional[bool] = None,
                 limit: Optional[int] = None) -> Dict[str, float]:
        """``val_loss`` (the quantitative loss of the prediction, plus the
        reconstruction loss with the module) and ``val_NMSE_{map}``, means
        over batches, reduced over processes."""
        use_ema = self.use_ema if use_ema is None else use_ema
        sums = {"loss": 0.0, **{f"NMSE_{n}": 0.0 for n in _QMAP_NAMES}}
        counts = {k: 0.0 for k in sums}
        for batch_idx, batch in enumerate(val_loader):
            if limit is not None and batch_idx >= limit:
                break
            pred = self.predict_batch(batch, use_ema=use_ema)
            target = _host(batch["maps_target"])
            mask_brain = torch.from_numpy(_host(batch["mask_brain"])) if "mask_brain" in batch else None
            total, _ = quantitative_loss_fn(torch.from_numpy(target), torch.from_numpy(pred)[None, None], mask_brain,
                                            self.loss_regularization_factors, self.val_loss_type)
            lossrecon = self._val_recon_loss(batch, use_ema)
            sums["loss"] += float(total) + (lossrecon or 0.0)
            counts["loss"] += 1.0
            for i, n in enumerate(_QMAP_NAMES):
                t, p = target[..., i], pred[..., i]
                denom = float((t**2).sum()) or 1.0
                sums[f"NMSE_{n}"] += float(((p - t) ** 2).sum()) / denom
                counts[f"NMSE_{n}"] += 1.0
        reduced = reduce_mean_stats(sums, counts)
        out = {"val_loss": reduced.pop("loss")}
        out.update({f"val_{k}": float(v) for k, v in reduced.items()})
        return out

    def test(self, test_loader: Iterable, use_ema: Optional[bool] = None):
        """Per-volume predicted maps [S, H, W, 4] by file name (slices in
        order), and the NMSE of each map per volume against ``maps_target``,
        means over volumes reduced over processes."""
        use_ema = self.use_ema if use_ema is None else use_ema
        volumes: Dict[str, list] = {}
        targets: Dict[str, list] = {}
        for batch in test_loader:
            pred = self.predict_batch(batch, use_ema=use_ema)
            target = _host(batch["maps_target"])
            for i, fname in enumerate(batch["fname"]):
                volumes.setdefault(fname, []).append((int(batch["slice_idx"][i]), pred[i]))
                targets.setdefault(fname, []).append((int(batch["slice_idx"][i]), target[i]))
        recons = {}
        sums = {f"NMSE_{n}": 0.0 for n in _QMAP_NAMES}
        for fname, slices in volumes.items():
            vol = np.stack([s for _, s in sorted(slices, key=lambda x: x[0])])
            tgt = np.stack([s for _, s in sorted(targets[fname], key=lambda x: x[0])])
            recons[fname] = vol
            for i, n in enumerate(_QMAP_NAMES):
                sums[f"NMSE_{n}"] += float(((vol[..., i] - tgt[..., i]) ** 2).sum()) / (
                    float((tgt[..., i] ** 2).sum()) or 1.0)
        return recons, reduce_mean_stats(sums, {k: float(len(volumes)) for k in sums})
