"""Task trainers (counterpart of ``mridc_tpu/train/task_trainers.py``): the
quantitative half. The segmentation and multitask trainers come with M11 and
M12.

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

from mridc_tpu_torch.losses.ssim import ssim_loss
from mridc_tpu_torch.parallel.multihost import reduce_mean_stats
from mridc_tpu_torch.train.trainer import Trainer, _host

__all__ = ["QuantitativeTrainer", "quantitative_loss_fn", "quantitative_recon_loss_fn",
           "parse_loss_regularization_factors"]

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
        out = self.model(*self._inputs(batch), train=True)
        mask_brain = self._tensor(batch["mask_brain"]) if "mask_brain" in batch else None
        total, _ = quantitative_loss_fn(self._tensor(batch["maps_target"]), self._unnormalized_preds(out),
                                        mask_brain, self.loss_regularization_factors, self.loss_type)
        lossrecon = torch.zeros((), device=self.device)
        if getattr(self.model, "use_reconstruction_module", False) and "target" in batch \
                and out.recon_intermediates is not None:
            lossrecon = quantitative_recon_loss_fn(self._tensor(batch["target"]), out.recon_intermediates,
                                                   self.loss_type)
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
