"""Training engine (counterpart of ``mridc_tpu/train/trainer.py``): one
training step (forward, loss, backward, gradient clipping, gradient
accumulation, the optimizer under its schedule, EMA), the prediction step,
and the ``fit``/``validate``/``test`` loops with host metrics at skimage
parity.

The step matches ``_build_train_step`` and ``_optimizer_tail``: the loss and
gradients of :func:`~mridc_tpu_torch.train.losses.process_reconstruction_loss`
on the model's train-mode output; ``clip_by_global_norm`` when
``gradient_clip_val`` is set (g / |g| * clip where |g| >= clip, as optax); the
optimizer at the schedule's rate for update k, ``sched(k)`` from k = 0; then
``ema = decay * ema + (1 - decay) * params``. It returns ``{"loss",
"grad_norm"}``, the norm of the step's gradients before clipping (0 for a
model without parameters, which takes no optimizer). Batches carry the JAX
package's keys (``masked_kspace``, ``sensitivity_maps``, ``mask``,
``target``, optional ``initial_prediction``) as numpy arrays or tensors, with
consecutive slices folded into the batch as ``_model_inputs`` folds them.

The self-supervised branches follow the JAX step's gating. SSDU batches
carry ``mask`` [B, 2, 1, H, W]: the model takes the train mask ``mask[:, 0]``
and the loss gates the prediction's k-space with the loss mask ``mask[:, 1]``.
A batch with ``n2r_masked_kspace``/``n2r_mask`` (Noise2Recon) trains on
exactly one term: the (pseudo-)supervised loss, in k-space when ``ssdu``,
when ``ssdu`` is set or any slice's ``attrs["n2r_supervised"]`` is true;
otherwise the consistency loss of a second forward on the noisier k-space
against the first forward's prediction (gradients through both), weighted by
``trainer_cfg["n2r_loss_weight"]``. The term that is not chosen is not
computed: its value reaches neither the loss nor a gradient.

``accumulate_grad_batches`` = k > 1 is ``optax.MultiSteps``: each micro-step
adds its gradients to a running mean (acc + (g - acc) / (n + 1)); every k-th
the mean is clipped and the optimizer steps at the schedule's rate for the
count of such updates. ``state.step`` and the EMA advance on every
micro-step, and ``max_steps`` counts optimizer steps (``fit`` runs k times as
many micro-steps).

``fit`` takes the JAX trainer's knobs from ``trainer_cfg`` (``max_epochs``,
``max_steps``, ``limit_train_batches``, ``limit_val_batches``,
``check_val_every_n_epoch``, ``val_check_interval``,
``num_sanity_val_steps``, ``log_every_n_steps``: the loss is read on the
host, which waits for the card, only on logging steps); ReduceLROnPlateau
sets the next step's rate after each validation. Batches may come from any
loader stage: numpy leaves are copied to the device, leaves already on it are
taken as they are, and bfloat16/float16 leaves are upcast to float32 there.

With an ``exp_manager`` (``train/exp_manager.py``) ``fit`` logs the training
loss on logging steps, saves a top-k checkpoint and logs the metrics after
each validation, logs target/reconstruction/error images of the first
``log_images_limit`` validation batches when ``log_images`` is set, and saves
``last`` and the ``.mridc`` archive when it ends. On SIGTERM ``fit`` ends after
the step it is in, saves ``last`` (with an ``exp_manager``) and returns its
history; the previous handler is put back. ``trainer_cfg["profile_dir"]``
traces steps [``profile_start_step`` (3), + ``profile_steps`` (5)) with
``torch.profiler`` into a Chrome trace there. :meth:`Trainer.state_dict` and
:meth:`Trainer.load_state_dict` carry the model, optimizer, plateau
scheduler, step, epoch, accumulation and EMA state (the step checkpoints).

Across processes (``torch.distributed``, one process a card) the trainer
takes one step over the batch the processes hold together, as the JAX
trainer's step over the mesh's global batch: each process reads its shard,
the model's outputs and the batch's targets are gathered along their batch
axes before the loss (every batch-coupled reduction of the loss sees the
joined batch), and the gradients are summed over the processes once a
micro-step, after the backward and before accumulation, clipping, the
optimizer and the EMA (``parallel/mesh.py``). Every process starts from
process 0's weights. Process 0 alone writes checkpoints and the archive.

The trainer runs on the CUDA device unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from mridc_tpu_torch.metrics.reconstruction import METRIC_FUNCS, ReconstructionMetrics, ssim
from mridc_tpu_torch.models.base import ModelOutput
from mridc_tpu_torch.parallel.mesh import (Mesh, all_reduce_gradients, broadcast_module, gather, joins_processes,
                                           make_mesh)
from mridc_tpu_torch.parallel.multihost import all_sum_scalars, reduce_mean_stats
from mridc_tpu_torch.train.losses import process_reconstruction_loss
from mridc_tpu_torch.train.optim import get_optimizer, parse_optimizer_args
from mridc_tpu_torch.train.schedulers import ReduceLROnPlateau, prepare_lr_schedule
from mridc_tpu_torch.utils.logging import get_logger
from mridc_tpu_torch.utils.typecheck import resolve_device

logger = get_logger()

__all__ = ["TrainState", "Trainer"]


def _host_val_loss(t: np.ndarray, p: np.ndarray, kind: str) -> float:
    """Validation loss in the family of the configured val_loss_fn (reference
    models compute val_loss with val_loss_fn, nn/base.py): l1 | l2/mse |
    ssim (as 1 - SSIM, the fastMRI SSIMLoss convention)."""
    if kind in ("l2", "mse"):
        return float(((t - p) ** 2).mean())
    if kind == "ssim":
        return float(1.0 - ssim(t, p))
    return float(np.abs(t - p).mean())


def _limit_batches(limit, loader):
    """PTL ``limit_{train,val}_batches`` semantics: float fraction of the
    loader length (when known) or an absolute batch count; None/1.0 = all."""
    if limit is None or loader is None:
        return None
    if isinstance(limit, bool):
        return None
    if isinstance(limit, float):
        if limit >= 1.0:
            return None
        try:
            n = len(loader)
        except TypeError:
            return None
        return max(1, int(np.ceil(limit * n)))
    limit = int(limit)
    return limit if limit >= 0 else None


def _host(x) -> np.ndarray:
    """A batch leaf or prediction as a host numpy array (tensors from any
    device, half precision upcast to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x).cpu().numpy()
    return np.asarray(x)


def _host_mag(x) -> np.ndarray:
    """Magnitude of a host array in any layout (complex, [..., 2] rv, or real)."""
    x = _host(x)
    if np.iscomplexobj(x):
        return np.abs(x)
    if x.ndim >= 1 and x.shape[-1] == 2:
        return np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    return np.abs(x)


def _group_mesh(mesh: Optional[Mesh]) -> Mesh:
    """The mesh of the process group that stands (``make_mesh()``), which a
    given ``mesh`` must equal: the trainer joins its step over the same
    processes as the models' batch-coupled reductions
    (``parallel/mesh.py:joins_processes``)."""
    group = make_mesh()
    if mesh is not None and (mesh.size != group.size or mesh.distributed != group.distributed):
        raise ValueError(f"a trainer's mesh describes the process group that stands ({dict(group.shape)}, "
                         f"distributed={group.distributed}); got {dict(mesh.shape)}, distributed={mesh.distributed}: "
                         "build it with parallel.mesh.make_mesh()")
    return group if mesh is None else mesh


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all the gradients together."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


@dataclass
class TrainState:
    """``step`` counts micro-steps, ``gradient_step`` optimizer steps (the
    schedule's count), ``mini_step`` the micro-steps in the running mean
    ``acc_grads``; ``optimizer`` is None for a model without parameters."""

    step: int
    optimizer: Optional[torch.optim.Optimizer]
    ema_params: Optional[Dict[str, torch.Tensor]] = field(default=None)
    gradient_step: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = field(default=None)


class Trainer:
    """Trainer for reconstruction models; parameters mirror the reference
    YAML ``trainer:`` / ``model.optim:`` blocks, as in the JAX package."""

    def __init__(
        self,
        model: torch.nn.Module,
        optim_cfg: Optional[Dict] = None,
        trainer_cfg: Optional[Dict] = None,
        loss_type: str = "l1",
        val_loss_type: Optional[str] = None,
        mesh: Optional[Mesh] = None,
        use_ema: bool = False,
        ema_decay: float = 0.999,
        loss_regularization_factor: float = 1.0,
        exp_manager=None,
        ssdu: bool = False,
        kspace_reconstruction_loss: bool = False,
        log_images: bool = True,
        log_images_limit: int = 4,
        device=None,
    ):
        self.exp_manager = exp_manager
        self.log_images = bool(log_images)
        self.log_images_limit = int(log_images_limit)
        self.epoch = 0
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optim_cfg = dict(optim_cfg or {"name": "adam", "lr": 1e-3})
        self.trainer_cfg = dict(trainer_cfg or {})
        self.loss_type = loss_type
        # reference models carry a separate val_loss_fn (usually = train's);
        # the monitored val_loss and plateau scheduling follow it
        self.val_loss_type = (val_loss_type or loss_type).lower()
        # the default process group's data axis (one member without a group)
        self.mesh = _group_mesh(mesh)
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.loss_regularization_factor = loss_regularization_factor
        self.ssdu = bool(ssdu)
        self.kspace_reconstruction_loss = bool(kspace_reconstruction_loss)
        self.schedule: Optional[Callable] = None
        self.plateau: Optional[ReduceLROnPlateau] = None
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------------ setup

    def setup_optimization(self, num_samples: int = 1, batch_size: int = 1) -> Optional[Callable]:
        """The learning-rate schedule (reference modelPT.setup_optimization)."""
        sched = prepare_lr_schedule(self.optim_cfg, num_samples, batch_size, self.trainer_cfg)
        if isinstance(sched, ReduceLROnPlateau):
            # keep a live plateau (its reduced rate and patience bookkeeping)
            # if the optimisation is set up again
            self.plateau = self.plateau or sched
            sched = self.plateau
        self.schedule = sched
        return self.schedule

    def init_state(self, sample_batch: Optional[Dict] = None) -> TrainState:
        """Optimizer state (and the EMA copy) over the model's parameters as
        they are; ``sample_batch`` is accepted for the JAX signature's sake."""
        del sample_batch
        if self.schedule is None:
            self.setup_optimization()
        broadcast_module(self.model)  # every process starts from process 0's weights
        params = [p for p in self.model.parameters() if p.requires_grad]
        opt = None
        if params:  # a model without parameters (ZF) trains nothing: optax's empty tree
            opt = get_optimizer(self.optim_cfg.get("name", "adam"), params, self._lr(0),
                                **parse_optimizer_args(self.optim_cfg))
        ema = None
        if self.use_ema:
            ema = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        self.state = TrainState(step=0, optimizer=opt, ema_params=ema)
        return self.state

    @property
    def accumulate(self) -> int:
        """Micro-steps per optimizer step (``accumulate_grad_batches``)."""
        return max(1, int(self.trainer_cfg.get("accumulate_grad_batches", 1) or 1))

    def state_dict(self) -> Dict:
        """The training state a step checkpoint holds: the model's and the
        optimizer's state dicts, the plateau scheduler's state, the step, the
        epoch and the EMA weights."""
        if self.state is None:
            self.init_state()
        st = self.state
        return {
            "model": self.model.state_dict(),
            "optimizer": None if st.optimizer is None else st.optimizer.state_dict(),
            "scheduler": None if self.plateau is None else dict(vars(self.plateau)),
            "step": st.step,
            "epoch": self.epoch,
            "ema": st.ema_params,
            "gradient_step": st.gradient_step,
            "mini_step": st.mini_step,
            "acc_grads": st.acc_grads,
        }

    def load_state_dict(self, state: Dict) -> None:
        """Continue from a :meth:`state_dict` (on this trainer's device)."""
        self.model.load_state_dict(state["model"])
        self.init_state()
        if self.state.optimizer is not None:
            self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"])
        self.state.gradient_step = int(state.get("gradient_step", self.state.step))
        self.state.mini_step = int(state.get("mini_step", 0))
        if state.get("acc_grads") is not None:
            self.state.acc_grads = [a.detach().to(self.device).clone() for a in state["acc_grads"]]
        self.epoch = int(state.get("epoch", 0))
        if state.get("ema") is not None:
            self.state.ema_params = {k: v.detach().to(self.device).clone() for k, v in state["ema"].items()}
        if state.get("scheduler") is not None and self.plateau is not None:
            vars(self.plateau).update(state["scheduler"])

    def _lr(self, step: int) -> float:
        if self.schedule is None:
            return float(self.optim_cfg.get("lr", 1e-3))
        return float(self.schedule(step))

    # ------------------------------------------------------------------ batches

    def _tensor(self, v) -> torch.Tensor:
        """A batch leaf on the trainer's device: numpy leaves are copied there,
        tensors already there are taken as they are; bfloat16/float16 leaves
        are upcast to float32 on the device."""
        t = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v), device=self.device)
        return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t

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

    @staticmethod
    def _joined(x: Optional[torch.Tensor], axis: int = 0) -> Optional[torch.Tensor]:
        """``x`` joined over the mesh's processes along its batch ``axis``
        (``x`` itself at one process)."""
        return gather(x, axis)

    def _joined_output(self, out: ModelOutput) -> ModelOutput:
        """A model output joined over the processes: the prediction along
        axis 0, the stacks along the batch axis after their leading stack
        axes ([C, T, B, ...] on axis 2, a quantitative model's per-echo
        [E, C, T, B, ...] on axis 3)."""
        if not joins_processes():
            return out
        nd = out.prediction.ndim

        def stack(t):
            return None if t is None else self._joined(t, t.ndim - nd)

        return ModelOutput(prediction=self._joined(out.prediction), intermediates=stack(out.intermediates),
                           recon_intermediates=stack(out.recon_intermediates))

    # ------------------------------------------------------------------ steps

    def training_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One training (micro-)step on ``batch``: ``{"loss", "grad_norm"}`` as
        0-d tensors on the device (reading them syncs the host)."""
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
        n2r = "n2r_masked_kspace" in batch
        fc = bool(getattr(self.model, "fft_centered", False))
        fn = str(getattr(self.model, "fft_normalization", "backward"))

        def loss_of(out, tgt, kspace_loss):
            # over the processes' joined batch (the maps and the loss mask only where the k-space loss reads them)
            return process_reconstruction_loss(
                self._joined_output(out), self._joined(tgt), self.loss_type, self.loss_regularization_factor,
                self._joined(loss_mask) if kspace_loss else loss_mask,
                sensitivity_maps=self._joined(sens) if kspace_loss else sens,
                kspace_loss=kspace_loss, fft_centered=fc, fft_normalization=fn)

        out = self.model(y, sens, mask, init_pred, train=True)
        supervised = not n2r or self.ssdu or any(bool(a.get("n2r_supervised", False))
                                                 for a in (batch.get("attrs") or []))
        if n2r and joins_processes():  # any slice of the joined batch, as the JAX step reads its global batch
            supervised = all_sum_scalars({"supervised": float(supervised)})["supervised"] > 0
        if supervised:
            loss = loss_of(out, target, self.kspace_reconstruction_loss or (self.ssdu and n2r))
        else:
            out_n = self.model(self._tensor(batch["n2r_masked_kspace"]), sens, self._tensor(batch["n2r_mask"]),
                               init_pred, train=True)
            loss = float(self.trainer_cfg.get("n2r_loss_weight", 1.0)) * loss_of(
                ModelOutput(prediction=out_n.prediction), out.prediction, self.kspace_reconstruction_loss)
        return {"loss": loss.detach(), "grad_norm": self._apply_loss(loss)}

    def _apply_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's tail on its loss: the backward, the gradients' sum over
        the processes, the gradients' global norm (returned), accumulation,
        clipping and the optimizer, the EMA and the step count."""
        st = self.state
        opt = st.optimizer
        if opt is None:  # no parameters: the loss, and the norm of no gradients
            grad_norm = torch.zeros((), device=self.device)
        else:
            opt.zero_grad(set_to_none=True)
            loss.backward()
            params = [p for group in opt.param_groups for p in group["params"]]
            for p in params:
                # optax hands every parameter a gradient, zeros where the loss
                # does not reach it (a frozen BatchNorm's running statistics):
                # the optimizer's rule then runs on it (weight decay moves it)
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            # the joined batch's gradient: each process holds the part that
            # flows through its own rows (parallel/mesh.py); nothing runs
            # without a process group
            all_reduce_gradients(params)
            grad_norm = _global_norm([p.grad for p in params])
            if self.accumulate > 1:
                # optax.MultiSteps: a running mean of the micro-steps' gradients
                if st.acc_grads is None:
                    st.acc_grads = [torch.zeros_like(p) for p in params]
                for p, acc in zip(params, st.acc_grads):
                    acc.add_((p.grad - acc) / (st.mini_step + 1))
                st.mini_step += 1
                if st.mini_step == self.accumulate:
                    for p, acc in zip(params, st.acc_grads):
                        p.grad = acc.clone()
                        acc.zero_()
                    st.mini_step = 0
                    self._optimizer_step(opt, params)
            else:
                self._optimizer_step(opt, params, grad_norm)
        if st.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    e = st.ema_params[k]
                    e.mul_(d).add_(p, alpha=1 - d)
        st.step += 1
        return grad_norm.detach()

    def _optimizer_step(self, opt: torch.optim.Optimizer, params: List[torch.Tensor],
                        norm: Optional[torch.Tensor] = None) -> None:
        """Clip the gradients in ``params``' ``.grad`` by their global norm
        (``norm`` when the caller has it; ``gradient_clip_val``) and step the
        optimizer at the schedule's rate for this optimizer step."""
        clip = self.trainer_cfg.get("gradient_clip_val", 0)
        if clip:
            grads = [p.grad for p in params if p.grad is not None]
            norm = _global_norm(grads) if norm is None else norm
            # optax.clip_by_global_norm: g / |g| * clip where |g| >= clip, without a host sync
            torch._foreach_mul_(grads, torch.where(norm < clip, torch.ones_like(norm), clip / norm))
        for group in opt.param_groups:
            group["lr"] = self._lr(self.state.gradient_step)
        opt.step()
        self.state.gradient_step += 1

    def predict_batch(self, batch: Dict, use_ema: bool = False) -> np.ndarray:
        """The model's (inference) prediction for ``batch``, in eval mode and
        without gradients, as a float32 host array; with ``use_ema`` from the
        EMA weights."""
        y, sens, mask, init_pred = self._model_inputs(batch)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if use_ema and self.state is not None and self.state.ema_params is not None:
                    out = torch.func.functional_call(self.model, self.state.ema_params, (y, sens, mask, init_pred))
                else:
                    out = self.model(y, sens, mask, init_pred)
        finally:
            self.model.train(was_training)
        return _host(out.prediction.float())

    # ------------------------------------------------------------------ loops

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            max_epochs: Optional[int] = None, log_every_n_steps: int = 10):
        """Train over ``train_loader``'s epochs (and validate on
        ``val_loader``) under ``trainer_cfg``'s knobs; returns one dict of
        epoch metrics per epoch (``train_loss`` and the validation metrics).

        Across processes each loader yields its process's shard and every
        step is one step over the joined batch (module docstring); the
        validation metrics are reduced over the processes."""
        max_epochs = max_epochs or self.trainer_cfg.get("max_epochs", 1)
        ms = self.trainer_cfg.get("max_steps")
        # max_steps counts optimizer steps (PTL); the loop counts micro-steps
        max_steps = (float("inf") if ms is None or float(ms) < 0 else float(ms)) * self.accumulate
        # PTL-compatible knobs (reference core/conf/trainer.py TrainerConfig)
        log_every_n_steps = int(self.trainer_cfg.get("log_every_n_steps", log_every_n_steps))
        check_val_every = int(self.trainer_cfg.get("check_val_every_n_epoch", 1) or 1)
        limit_train = _limit_batches(self.trainer_cfg.get("limit_train_batches", 1.0), train_loader)
        limit_val = _limit_batches(self.trainer_cfg.get("limit_val_batches", 1.0), val_loader)
        sanity_steps = int(self.trainer_cfg.get("num_sanity_val_steps", 0) or 0)
        val_interval_steps = None
        vci = self.trainer_cfg.get("val_check_interval")
        if vci is not None:
            if isinstance(vci, float) and vci < 1.0:
                try:
                    val_interval_steps = max(1, int(round(vci * len(train_loader))))
                except TypeError:
                    val_interval_steps = None
            elif int(vci) >= 1:
                val_interval_steps = int(vci)

        if self.schedule is None:
            self.setup_optimization(num_samples=len(getattr(train_loader, "dataset", [])) or 1,
                                    batch_size=getattr(train_loader, "batch_size", 1))
        if self.state is None:
            # the JAX trainer initialises from a first batch of a fresh
            # iteration, which advances the loader's epoch (its shuffle
            # order): the same here, so both train on the same batches
            it = iter(train_loader)
            self.init_state(next(it))
            getattr(it, "close", lambda: None)()

        step = self.state.step
        history = []
        if sanity_steps and val_loader is not None:
            # reference num_sanity_val_steps: run a few val batches before
            # training to fail fast on broken eval paths
            sanity = self.validate(val_loader, limit=sanity_steps)
            logger.info("sanity check: " + " ".join(f"{k}={v:.5f}" for k, v in sanity.items()))

        # on SIGTERM (a preempted job) end after the current step, save "last"
        # and return, so that resume_if_exists picks the run up
        preempted = {"flag": False}

        def _on_sigterm(signum, frame):  # noqa: ARG001
            preempted["flag"] = True
            logger.warning("SIGTERM received: checkpointing before exit")

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            prev_handler = None  # not in the main thread: no handler

        # trainer.profile_dir traces steps [profile_start_step, + profile_steps)
        profile_dir = self.trainer_cfg.get("profile_dir")
        profile_start = int(self.trainer_cfg.get("profile_start_step", 3))
        profile_len = int(self.trainer_cfg.get("profile_steps", 5))
        profiler = None

        try:
            for epoch in range(max_epochs):
                self.epoch = epoch
                epoch_start = time.perf_counter()
                losses = []
                for batch_idx, batch in enumerate(train_loader):
                    if step >= max_steps:
                        break
                    if limit_train is not None and batch_idx >= limit_train:
                        break
                    if profile_dir is not None:
                        if profiler is None and step == profile_start:
                            profiler = self._start_profiler()
                        elif profiler is not None and step >= profile_start + profile_len:
                            self._stop_profiler(profiler, profile_dir, profile_start)
                            profiler = None
                    t0 = time.perf_counter()
                    metrics = self.training_batch(batch)
                    # the loss stays on the device: reading it would make the host
                    # wait for the card every step
                    losses.append(metrics["loss"])
                    step += 1
                    if step % log_every_n_steps == 0:
                        loss = metrics["loss"].item()
                        logger.info(f"epoch {epoch} step {step} loss {loss:.5f} "
                                    f"step_time {time.perf_counter() - t0:.3f}s")
                        if self.exp_manager is not None:
                            self.exp_manager.log_scalar("train_loss", loss, step)
                    if val_interval_steps and val_loader is not None and step % val_interval_steps == 0:
                        val = self._run_validation(val_loader, step, limit_val)
                        logger.info(f"step {step} validation: " + " ".join(f"{k}={v:.5f}" for k, v in val.items()))
                    if step >= max_steps or preempted["flag"]:
                        break
                if preempted["flag"]:
                    if self.exp_manager is not None:
                        # the unmanaged "last": a save without a metric stays
                        # out of the top-k bookkeeping
                        self.exp_manager.checkpointer.save_last(self.state_dict())
                    break
                epoch_metrics = {
                    "epoch": epoch,
                    "train_loss": float(np.mean(_host(torch.stack(losses)))) if losses else float("nan"),
                }
                if val_loader is not None and (epoch + 1) % check_val_every == 0:
                    epoch_metrics.update(self._run_validation(val_loader, step, limit_val))
                logger.info(
                    f"epoch {epoch} done in {time.perf_counter() - epoch_start:.1f}s: "
                    + " ".join(f"{k}={v:.5f}" for k, v in epoch_metrics.items() if isinstance(v, float))
                )
                history.append(epoch_metrics)
                if step >= max_steps:
                    break
        finally:
            if profiler is not None:
                self._stop_profiler(profiler, profile_dir, profile_start)
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            if self.exp_manager is not None:
                self.exp_manager.on_train_end(self)
        return history

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, profile_dir, start: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        path = Path(profile_dir) / f"trace_steps{start}-{self.state.step}.pt.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(path))
        logger.info(f"Wrote profiler trace to {path}")

    def _run_validation(self, val_loader, step: int, limit_val=None) -> Dict[str, float]:
        """Validate, let ReduceLROnPlateau set the rate of the next steps, and
        call the experiment manager's hook (shared by epoch-end and mid-epoch
        ``val_check_interval`` validation)."""
        val = self.validate(val_loader, limit=limit_val)
        if self.plateau is not None:
            old_lr = self.plateau.lr
            self.plateau.update(val["val_loss"])
            if self.plateau.lr != old_lr:
                logger.info(f"ReduceLROnPlateau: lr {old_lr:.2e} -> {self.plateau.lr:.2e}")
        if self.exp_manager is not None:
            self.exp_manager.on_validation_end(self, val, step)
        return val

    def _maybe_log_val_images(self, batch_idx: int, target_mag: np.ndarray, pred_mag: np.ndarray):
        """Target/reconstruction/|error| panels of the first two slices of the
        first ``log_images_limit`` validation batches."""
        if self.exp_manager is None or not self.log_images or batch_idx >= self.log_images_limit:
            return
        step = self.state.step if self.state is not None else 0
        for i in range(min(target_mag.shape[0], 2)):
            t, p = target_mag[i], pred_mag[i]
            while t.ndim > 2:  # consecutive-slice volumes: the middle slice
                t, p = t[t.shape[0] // 2], p[p.shape[0] // 2]
            self.exp_manager.log_image_triplet(f"val/batch{batch_idx}_{i}", t, p, step)

    def validate(self, val_loader: Iterable, use_ema: Optional[bool] = None,
                 limit: Optional[int] = None) -> Dict[str, float]:
        """Host-side metric computation at skimage parity (reference
        validation_epoch_end nn/base.py:857-913): ``val_loss`` and
        ``val_{MSE,NMSE,PSNR,SSIM}``, each a mean over slices, reduced over
        processes. With EMA on, the averaged weights are evaluated (the
        reference EMA callback's weight swap, common/callbacks/ema.py:19)."""
        use_ema = self.use_ema if use_ema is None else use_ema
        losses = []
        metrics = ReconstructionMetrics(METRIC_FUNCS)
        for batch_idx, batch in enumerate(val_loader):
            if limit is not None and batch_idx >= limit:
                break
            t = _host_mag(batch["target"])
            p = _host_mag(self.predict_batch(batch, use_ema=use_ema))
            t = t / (t.max() or 1.0)
            p = p / (p.max() or 1.0)
            losses.append(_host_val_loss(t, p, self.val_loss_type))
            self._maybe_log_val_images(batch_idx, t, p)
            for i in range(t.shape[0]):
                metrics.push(t[i : i + 1], p[i : i + 1])
        # cross-process reduction (reference DistributedMetricSum sums metric
        # values and counts over DDP workers, nn/base.py:890-913); identity on
        # a single process
        sums = {"loss": float(np.sum(losses))}
        counts = {"loss": float(len(losses))}
        for k, stat in metrics.metrics_scores.items():
            sums[k] = stat.mean() * stat.n
            counts[k] = float(stat.n)
        reduced = reduce_mean_stats(sums, counts)
        out = {"val_loss": reduced.pop("loss")}
        out.update({f"val_{k}": float(v) for k, v in reduced.items()})
        return out

    def test(self, test_loader: Iterable, use_ema: Optional[bool] = None):
        """Per-volume reconstructions (magnitudes normalised to their maximum,
        by file name) and their metrics against the targets (reference
        test_epoch_end nn/base.py:915-982); EMA weights when EMA is on."""
        use_ema = self.use_ema if use_ema is None else use_ema
        volumes: Dict[str, list] = {}
        targets: Dict[str, list] = {}
        for batch in test_loader:
            pred = self.predict_batch(batch, use_ema=use_ema)
            target = _host(batch["target"])
            for i, fname in enumerate(batch["fname"]):
                volumes.setdefault(fname, []).append((int(batch["slice_idx"][i]), _host_mag(pred[i])))
                targets.setdefault(fname, []).append((int(batch["slice_idx"][i]), _host_mag(target[i])))
        recons = {}
        metrics = ReconstructionMetrics(METRIC_FUNCS)
        for fname, slices in volumes.items():
            vol = np.stack([s for _, s in sorted(slices, key=lambda x: x[0])])
            tgt = np.stack([s for _, s in sorted(targets[fname], key=lambda x: x[0])])
            vol = vol / (vol.max() or 1.0)
            tgt = tgt / (tgt.max() or 1.0)
            recons[fname] = vol
            metrics.push(tgt, vol)
        sums = {k: s.mean() * s.n for k, s in metrics.metrics_scores.items()}
        counts = {k: float(s.n) for k, s in metrics.metrics_scores.items()}
        return recons, reduce_mean_stats(sums, counts)
