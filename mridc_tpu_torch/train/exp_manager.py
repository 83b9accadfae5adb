"""Experiment manager (counterpart of ``mridc_tpu/train/exp_manager.py``): the
run directory, logging, the checkpoint policy, resume and provenance.

The run dir is ``exp_dir/name/version`` (version: a timestamp, ``"run"`` when
resuming), with the per-process log file, ``git-info.log``, ``cmd-args.log``,
``hparams.yaml``, ``checkpoints/`` (top k on a monitored metric and ``last``),
``tb/`` when a TensorBoard writer is made, and ``<name>.mridc`` at the end of
training, from the best monitored weights. Configs are written as JSON text
(``train/config.py``). TensorBoard (``torch.utils.tensorboard``) and wandb are
imported when asked for; when they are missing the manager warns and logs
nowhere, as the JAX package does.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mridc_tpu_torch.train.checkpoints import StepCheckpointer, save_archive
from mridc_tpu_torch.train.config import save_config
from mridc_tpu_torch.utils.logging import add_file_handler, get_logger, is_global_rank_zero

logger = get_logger()

__all__ = ["ExpManager"]


def _shared_stamp() -> float:
    """This process's clock, or process 0's when a process group with more
    than one process is initialised: every process must name the same run
    dir. A failed broadcast raises: each process falling back to its own
    clock would split the run over several dirs."""
    stamp = time.time()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        box = [stamp]
        dist.broadcast_object_list(box, src=0)
        stamp = float(box[0])
    return stamp


class ExpManager:
    def __init__(
        self,
        exp_dir: str = "experiments",
        name: str = "default",
        version: Optional[str] = None,
        resume_if_exists: bool = False,
        create_tensorboard_logger: bool = False,
        create_wandb_logger: bool = False,
        wandb_kwargs: Optional[Dict] = None,
        checkpoint_monitor: str = "val_loss",
        checkpoint_mode: str = "min",
        save_top_k: int = 3,
        model_config: Optional[Dict] = None,
        map_location=None,
    ):
        self.name = name
        if version is None:
            version = "run" if resume_if_exists else time.strftime("%Y-%m-%d_%H-%M-%S",
                                                                   time.localtime(_shared_stamp()))
        self.log_dir = Path(exp_dir) / name / version
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir = self.log_dir / "checkpoints"
        self.model_config = model_config or {}
        self.resume_if_exists = resume_if_exists

        if is_global_rank_zero():
            if resume_if_exists:
                self._rotate_previous_logs()
            add_file_handler(self.log_dir)
            self._save_provenance()
            if model_config:
                save_config(model_config, self.log_dir / "hparams.yaml")

        self.checkpointer = StepCheckpointer(self.checkpoint_dir, max_to_keep=save_top_k, monitor=checkpoint_monitor,
                                             mode=checkpoint_mode, map_location=map_location)
        self.writer = None
        if create_tensorboard_logger:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(str(self.log_dir / "tb"))
            except Exception as e:  # the tensorboard package is optional
                logger.warning(f"TensorBoard logger unavailable: {e}")
        self.wandb_run = None
        if create_wandb_logger and is_global_rank_zero():
            try:
                import wandb

                self.wandb_run = wandb.init(dir=str(self.log_dir), name=f"{name}/{version}", config=self.model_config,
                                            **(wandb_kwargs or {}))
            except Exception as e:
                logger.warning(f"WandB logger unavailable: {e}")

    def _save_provenance(self):
        """Git hash and working-tree diff, and the command line, into the run
        dir."""
        try:
            sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5).stdout.strip()
            diff = subprocess.run(["git", "diff", "HEAD"], capture_output=True, text=True, timeout=15).stdout
            if sha:
                (self.log_dir / "git-info.log").write_text(f"commit: {sha}\n\n# git diff HEAD\n{diff}")
        except Exception:
            pass
        try:
            (self.log_dir / "cmd-args.log").write_text(" ".join(sys.argv) + "\n")
        except Exception:
            pass

    def _rotate_previous_logs(self):
        """Move a previous run's log and event files into ``run_{N}/`` before
        resuming."""
        stale = [p for p in self.log_dir.iterdir() if p.is_file() and p.suffix == ".log"]
        stale += list((self.log_dir / "tb").glob("events.*")) if (self.log_dir / "tb").exists() else []
        if not stale:
            return
        n = 0
        while (self.log_dir / f"run_{n}").exists():
            n += 1
        dest = self.log_dir / f"run_{n}"
        dest.mkdir()
        for p in stale:
            p.rename(dest / p.name)
        logger.info(f"Rotated previous run logs into {dest}")

    def log_scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        if self.wandb_run is not None:
            self.wandb_run.log({tag: value}, step=step)

    def log_image_triplet(self, tag: str, target, prediction, step: int):
        """The target, the reconstruction and |error| side by side, each
        normalised to its maximum."""
        if self.writer is None:
            return
        t = np.abs(np.asarray(target))
        p = np.abs(np.asarray(prediction))
        t = t / max(t.max(), 1e-12)
        p = p / max(p.max(), 1e-12)
        panel = np.concatenate([t, p, np.abs(t - p)], axis=-1)
        self.writer.add_image(tag, panel[None], step, dataformats="CHW")

    def on_validation_end(self, trainer, metrics: Dict[str, float], step: int):
        self.checkpointer.save(step, trainer.state_dict(), metrics)
        for k, v in metrics.items():
            self.log_scalar(k, v, step)

    def on_train_end(self, trainer):
        if trainer.state is not None:
            # the final state goes to the unmanaged "last", so that a save
            # without a metric never enters the top-k bookkeeping
            self.checkpointer.save_last(trainer.state_dict())
            if is_global_rank_zero():
                # the archive carries the best monitored weights, else the final ones
                weights = trainer.model.state_dict()
                try:
                    best = self.checkpointer.restore_best()
                    if best is not None:
                        weights = best["model"]
                except Exception as e:
                    logger.warning(f"best checkpoint unreadable, archiving the final weights: {e}")
                save_archive(self.log_dir / f"{self.name}.mridc", self.model_config, weights)
        if self.writer is not None:
            self.writer.flush()
        if self.wandb_run is not None:
            self.wandb_run.finish()

    def maybe_resume(self, trainer) -> bool:
        """Load the newer of the latest top-k checkpoint and ``last`` into
        ``trainer`` (which has a state to load into)."""
        if not self.resume_if_exists or trainer.state is None:
            return False
        candidates = [s for s in (self.checkpointer.restore(), self.checkpointer.restore_last()) if s is not None]
        if not candidates:
            return False
        trainer.load_state_dict(max(candidates, key=lambda s: int(s["step"])))
        logger.info(f"Resumed from step {trainer.state.step}")
        return True
