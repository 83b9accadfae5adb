"""Worker side of ``test_torch_port_parallel.py``: a pool of processes joined
in one gloo group that run training cases of ``mridc_tpu_torch`` on their
shards of a batch. Imports torch, numpy and the port only, so that the
spawned workers start fast.

Every case is a function ``case(**kwargs) -> dict`` of numpy leaves; the same
function, called without a process group, is the one-process reference on
the joined batch.
"""

from __future__ import annotations

import logging
import traceback

import numpy as np
import torch


def _numpy(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors}


def train_steps(cfg, batches, state=None, optim=None, trainer_cfg=None, loss_type="l1", task="reconstruction",
                seg_loss_cfg=None):
    """``len(batches)`` training (micro-)steps from ``state`` (or the model's
    seeded init): the losses and gradient norms of each, the gradients after
    the last and the state dict after all."""
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.parallel.mesh import make_mesh
    from mridc_tpu_torch.train.task_trainers import MultitaskTrainer, SegmentationTrainer
    from mridc_tpu_torch.train.trainer import Trainer

    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    kw = dict(optim_cfg=optim or {"name": "sgd", "lr": 0.1}, trainer_cfg=trainer_cfg or {}, loss_type=loss_type,
              device="cpu", mesh=make_mesh())
    if task == "segmentation":
        trainer = SegmentationTrainer(model, seg_loss_cfg=seg_loss_cfg, **kw)
    elif task == "multitask":
        trainer = MultitaskTrainer(model, seg_loss_cfg=seg_loss_cfg, **kw)
    else:
        trainer = Trainer(model, **kw)
    trainer.setup_optimization()
    trainer.init_state(batches[0])  # builds a trunk that takes its width from the data
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    before = _numpy(model.state_dict().items())
    losses, norms = [], []
    for b in batches:
        out = trainer.training_batch(b)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "before": before,
            "grads": _numpy((k, p.grad) for k, p in model.named_parameters() if p.grad is not None),
            "state": _numpy(model.state_dict().items())}


def shard_batch_case(batch):
    """``shard_batch`` of a process-local batch on the mesh of the group:
    what it warned about, each leaf's type and device, and the leaves."""
    from mridc_tpu_torch.parallel import mesh as pmesh

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("mridc_tpu")
    log.addHandler(handler)
    try:
        m = pmesh.make_mesh()
        out = pmesh.shard_batch(batch, m)
    finally:
        log.removeHandler(handler)
    return {"warned": sorted(k for k in batch if any(repr(k) in r.getMessage() for r in records)),
            "mesh": (dict(m.shape), m.rank, m.distributed),
            "kinds": {k: (type(v).__name__, str(v.device) if isinstance(v, torch.Tensor) else None)
                      for k, v in out.items()},
            "values": {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}}


CASES = {"train_steps": train_steps, "shard_batch": shard_batch_case}


def serve(rank: int, world: int, port: int, inbox, outbox) -> None:
    """Join the gloo group, then run ``(case, kwargs)`` items from ``inbox``
    until a None, putting ``(rank, result)`` (or ``{"error": ...}``) on
    ``outbox``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        while True:
            item = inbox.get()
            if item is None:
                break
            case, kwargs = item
            try:
                res = CASES[case](**kwargs)
            except Exception:  # reported to the test, which would otherwise wait for the queue
                res = {"error": traceback.format_exc()}
            outbox.put((rank, res))
    finally:
        dist.destroy_process_group()
