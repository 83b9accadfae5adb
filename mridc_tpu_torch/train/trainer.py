"""Training engine (counterpart of ``mridc_tpu/train/trainer.py``): one
supervised training step (forward, loss, backward, gradient clipping, the
optimizer under its schedule, EMA) and the prediction step.

The step matches ``_build_train_step``'s supervised branch and
``_optimizer_tail``: the loss and gradients of
:func:`~mridc_tpu_torch.train.losses.process_reconstruction_loss` on the
model's train-mode output; ``clip_by_global_norm`` when
``gradient_clip_val`` is set (g / |g| * clip where |g| >= clip, as optax); the
optimizer at the schedule's rate for update k, ``sched(k)`` from k = 0; then
``ema = decay * ema + (1 - decay) * params``. It returns ``{"loss",
"grad_norm"}``, the norm of the gradients before clipping. Batches carry the
JAX package's keys (``masked_kspace``, ``sensitivity_maps``, ``mask``,
``target``, optional ``initial_prediction``) as numpy arrays or tensors, with
consecutive slices folded into the batch as ``_model_inputs`` folds them.

Not ported yet (each raises, ROADMAP.md M5): the noise2recon and SSDU
branches and gradient accumulation. The trainer runs on the CUDA device unless
it is given ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.optim import get_optimizer, parse_optimizer_args
from mridc_tpu_torch.train.schedulers import prepare_lr_schedule
from mridc_tpu_torch.utils.typecheck import resolve_device

__all__ = ["TrainState", "Trainer"]


@dataclass
class TrainState:
    step: int
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = field(default=None)


class Trainer:
    """Trainer for reconstruction models; parameters mirror the reference
    YAML ``trainer:`` / ``model.optim:`` blocks, as in the JAX package."""

    def __init__(
        self,
        model: torch.nn.Module,
        optim_cfg: Optional[Dict] = None,
        trainer_cfg: Optional[Dict] = None,
        loss_type: str = "l1",
        use_ema: bool = False,
        ema_decay: float = 0.999,
        loss_regularization_factor: float = 1.0,
        ssdu: bool = False,
        kspace_reconstruction_loss: bool = False,
        device=None,
    ):
        if ssdu:
            raise NotImplementedError("the SSDU training branch is not ported to mridc_tpu_torch yet: ROADMAP.md M5")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optim_cfg = dict(optim_cfg or {"name": "adam", "lr": 1e-3})
        self.trainer_cfg = dict(trainer_cfg or {})
        self.loss_type = loss_type
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.loss_regularization_factor = loss_regularization_factor
        self.kspace_reconstruction_loss = bool(kspace_reconstruction_loss)
        self.schedule: Optional[Callable] = None
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------------ setup

    def setup_optimization(self, num_samples: int = 1, batch_size: int = 1) -> Optional[Callable]:
        """The learning-rate schedule (reference modelPT.setup_optimization)."""
        accum = self.trainer_cfg.get("accumulate_grad_batches", 1)
        if accum and accum > 1:
            raise NotImplementedError(
                "gradient accumulation (accumulate_grad_batches > 1) is not ported to mridc_tpu_torch yet: "
                "ROADMAP.md M5")
        self.schedule = prepare_lr_schedule(self.optim_cfg, num_samples, batch_size, self.trainer_cfg)
        return self.schedule

    def init_state(self, sample_batch: Optional[Dict] = None) -> TrainState:
        """Optimizer state (and the EMA copy) over the model's parameters as
        they are; ``sample_batch`` is accepted for the JAX signature's sake."""
        del sample_batch
        if self.schedule is None:
            self.setup_optimization()
        params = [p for p in self.model.parameters() if p.requires_grad]
        opt = get_optimizer(self.optim_cfg.get("name", "adam"), params, self._lr(0),
                            **parse_optimizer_args(self.optim_cfg))
        ema = None
        if self.use_ema:
            ema = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        self.state = TrainState(step=0, optimizer=opt, ema_params=ema)
        return self.state

    def _lr(self, step: int) -> float:
        if self.schedule is None:
            return float(self.optim_cfg.get("lr", 1e-3))
        return float(self.schedule(step))

    # ------------------------------------------------------------------ batches

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v, device=self.device)

    @staticmethod
    def _num_slices(batch: Dict) -> int:
        y = batch["masked_kspace"]
        return int(y.shape[1]) if y.ndim == 6 else 1

    def _model_inputs(self, batch: Dict):
        """(y, sens, mask, init_pred) with [B, S, ...] slices folded into B."""
        slices = self._num_slices(batch)
        fold = lambda x: x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])) if x.ndim == 6 else x  # noqa: E731
        y = fold(self._tensor(batch["masked_kspace"]))
        sens = fold(self._tensor(batch["sensitivity_maps"]))
        mask = self._tensor(batch["mask"])
        if mask.ndim == 5 and mask.shape[1] == 2:  # SSDU [B, 2, 1, H, W]: train mask
            mask = mask[:, 0]
        if slices > 1 and mask.shape[0] * slices == y.shape[0]:
            mask = torch.repeat_interleave(mask, slices, dim=0)  # same mask for each slice
        init_pred = self._tensor(batch["initial_prediction"]) if "initial_prediction" in batch else None
        if init_pred is not None and slices > 1 and init_pred.ndim == 5:
            init_pred = init_pred.reshape((-1,) + tuple(init_pred.shape[2:]))
        return y, sens, mask, init_pred

    # ------------------------------------------------------------------ steps

    def training_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One training step on ``batch``: ``{"loss", "grad_norm"}`` as 0-d
        tensors on the device (reading them syncs the host)."""
        if "n2r_masked_kspace" in batch:
            raise NotImplementedError("the noise2recon training branch is not ported to mridc_tpu_torch yet: "
                                      "ROADMAP.md M5")
        if self.state is None:
            self.init_state()
        slices = self._num_slices(batch)
        y, sens, mask, init_pred = self._model_inputs(batch)
        target = self._tensor(batch["target"])
        if slices > 1 and target.ndim == 5:
            target = target.reshape((-1,) + tuple(target.shape[2:]))
        loss_mask = None
        raw_mask = self._tensor(batch["mask"])
        if raw_mask.ndim >= 4 and raw_mask.shape[1] == 2:  # SSDU loss mask
            loss_mask = raw_mask[:, 1, 0] if raw_mask.ndim == 5 else raw_mask[:, 1]
            if slices > 1 and loss_mask.shape[0] * slices == y.shape[0]:
                loss_mask = torch.repeat_interleave(loss_mask, slices, dim=0)

        opt = self.state.optimizer
        opt.zero_grad(set_to_none=True)
        out = self.model(y, sens, mask, init_pred, train=True)
        loss = process_reconstruction_loss(
            out, target, self.loss_type, self.loss_regularization_factor, loss_mask,
            sensitivity_maps=sens, kspace_loss=self.kspace_reconstruction_loss,
            fft_centered=bool(getattr(self.model, "fft_centered", False)),
            fft_normalization=str(getattr(self.model, "fft_normalization", "backward")),
        )
        loss.backward()
        grads = [p.grad for group in opt.param_groups for p in group["params"] if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        clip = self.trainer_cfg.get("gradient_clip_val", 0)
        if clip:
            # optax.clip_by_global_norm: g / |g| * clip where |g| >= clip, without a host sync
            scale = torch.where(grad_norm < clip, torch.ones_like(grad_norm), clip / grad_norm)
            torch._foreach_mul_(grads, scale)
        for group in opt.param_groups:
            group["lr"] = self._lr(self.state.step)
        opt.step()
        if self.state.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    e = self.state.ema_params[k]
                    e.mul_(d).add_(p, alpha=1 - d)
        self.state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    def predict_batch(self, batch: Dict, use_ema: bool = False) -> np.ndarray:
        """The model's (inference) prediction for ``batch``, as numpy; with
        ``use_ema`` from the EMA weights."""
        y, sens, mask, init_pred = self._model_inputs(batch)
        with torch.no_grad():
            if use_ema and self.state is not None and self.state.ema_params is not None:
                out = torch.func.functional_call(self.model, self.state.ema_params, (y, sens, mask, init_pred))
            else:
                out = self.model(y, sens, mask, init_pred)
        return out.prediction.float().cpu().numpy()
