"""Checkpoints (counterpart of ``mridc_tpu/train/checkpoints.py``): the
portable ``.mridc`` model archive and the trainer's step checkpoints.

The archive the port writes is the reference torch format: a tar.gz of
``model_config.yaml`` (the model config as JSON text, which YAML readers read
unchanged) and ``model_weights.ckpt`` (``torch.save`` of the model's
``state_dict``). The port's CIRIM and VarNet state-dict keys are the reference
names, so ``mridc_tpu.train.checkpoints.restore_model`` restores a port
archive as it restores any reference archive.

The port also reads archives that ``mridc_tpu`` wrote (``model_config.yaml``
and ``model_weights.msgpack``, flax's msgpack serialisation): the ``msgpack``
package decodes them (flax stores an array as msgpack extension type 1
holding its shape, dtype name and bytes), and the JAX param tree is mapped to
the port's state dict by ``utils/params.py``. A model with live BatchNorm
statistics (``train_batch_stats``) is archived in that format, as
``{"params", "batch_stats"}`` the way the JAX package saves it, so that each
package restores the other's archive with its statistics; so is every model
whose reference torch weights ``mridc_tpu`` does not read (RecurrentVarNet,
MultiDomainNet, JointICNet, the quantitative, segmentation and multitask
models) and every model with ``use_sens_net``: ``mridc_tpu`` restores no
reference archive of a wrapped model (its importer names the wrapped scope
``{Class}_0`` where its ``WithSensNet`` has ``model``), while the port reads
one (``sens_net.*`` beside the model's reference keys) as it reads any.

Step checkpoints stand in for orbax: ``torch.save`` of the trainer's state
(``{model, optimizer, scheduler, step, epoch, ema}``) under
``<dir>/<step>/``, the top k kept by a monitored metric, and an unmanaged
``<dir>/last/``, with :class:`StepCheckpointer`'s methods named as the JAX
package's ``OrbaxCheckpointer``'s.
"""

from __future__ import annotations

import io
import json
import math
import shutil
import tarfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mridc_tpu_torch.train.config import loads

__all__ = ["save_archive", "load_archive", "restore_model", "decode_flax_msgpack", "encode_flax_msgpack",
           "StepCheckpointer"]

CONFIG_NAME = "model_config.yaml"
WEIGHTS_NAME = "model_weights.ckpt"
FLAX_WEIGHTS_NAME = "model_weights.msgpack"
_STATE_NAME = "checkpoint.pt"


def save_archive(path, cfg: Dict, state_dict: Dict[str, torch.Tensor]) -> Path:
    """Write a ``.mridc`` archive of the model config ``cfg`` and the model's
    ``state_dict`` (tensors saved from the CPU): reference torch format, or
    the JAX package's flax msgpack where ``mridc_tpu`` reads no torch weights
    of the model: ``{"params", "batch_stats"}`` where the state holds live
    BatchNorm statistics (``running_mean``), the bare param tree for
    RecurrentVarNet, MultiDomainNet, JointICNet, qCIRIM, qVarNet, the
    segmentation and multitask models and every model with
    ``use_sens_net``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flax_params = str(cfg.get("model_name", "")).upper() in _FLAX_ARCHIVED or cfg.get("use_sens_net", False)
    if flax_params or any(k.endswith("running_mean") for k in state_dict):
        from mridc_tpu_torch.utils.params import params_to_jax

        tree = params_to_jax(state_dict, cfg)
        weights = (FLAX_WEIGHTS_NAME, encode_flax_msgpack(tree if "batch_stats" in tree else tree["params"]))
    else:
        buf = io.BytesIO()
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
        weights = (WEIGHTS_NAME, buf.getvalue())
    members = ((CONFIG_NAME, (json.dumps(cfg, indent=2) + "\n").encode()), weights)
    with tarfile.open(path, "w:gz") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def _ndarray(data: bytes) -> np.ndarray:
    """A flax-serialised array: msgpack of (shape, dtype name, C-order bytes);
    bfloat16 (which numpy lacks) comes back as float32."""
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def decode_flax_msgpack(data: bytes) -> Any:
    """The tree ``flax.serialization.to_bytes`` wrote, with numpy leaves,
    decoded with the ``msgpack`` package (flax's extension types: 1 an array, 2
    a complex scalar, 3 a numpy scalar)."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading a mridc_tpu (flax msgpack) archive needs the msgpack package "
                          "(pip install msgpack)") from e

    def ext_hook(code, data):
        if code in (1, 3):
            arr = _ndarray(data)
            return arr if code == 1 else arr[()]
        if code == 2:
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        return msgpack.ExtType(code, data)

    tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("chunked flax arrays (leaves over 2 GiB) are not read by the port")
            for v in node.values():
                check(v)

    check(tree)
    return tree


def encode_flax_msgpack(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts and numpy arrays,
    written with the ``msgpack`` package (each array as extension type 1 of
    its shape, dtype name and C-order bytes)."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("writing a mridc_tpu (flax msgpack) archive needs the msgpack package "
                          "(pip install msgpack)") from e

    def ext(obj):
        if isinstance(obj, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True))
        raise TypeError(f"cannot serialise {type(obj).__name__} in a flax archive")

    return msgpack.packb(tree, default=ext, strict_types=True)


_FLAX_ARCHIVED = {"RVN", "RECURRENTVARNET", "MULTIDOMAINNET", "MULTIDOMAIN", "QCIRIM", "QRIM", "QVN", "QVARNET",
                  "SEGMENTATIONUNET", "SEGMENTATION2DUNET", "SEGMENTATION3DUNET", "SEGMENTATIONATTENTIONUNET",
                  "SEGMENTATIONLAMBDAUNET", "SEGMENTATIONVNET", "SEGMENTATIONDYNUNET", "SEGMENTATIONUNETR",
                  "MTLRS", "JRSCIRIM", "IDSLR", "IDSLRUNET", "SEGNET", "RECSEGNET", "RECSEGUNET", "SERANET",
                  "JOINTICNET"}



def load_archive(path) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """(model config, state dict) of a ``.mridc`` archive in either format:
    reference torch (``model_weights.ckpt``) or ``mridc_tpu``'s flax msgpack
    (``model_weights.msgpack``)."""
    with tarfile.open(path, "r:*") as tar:
        members = {m.name.lstrip("./").rsplit("/", 1)[-1]: m for m in tar.getmembers() if m.isfile()}
        if CONFIG_NAME not in members:
            raise ValueError(f"archive {path} has no {CONFIG_NAME} member")
        weights = next((n for n in (WEIGHTS_NAME, FLAX_WEIGHTS_NAME) if n in members), None)
        if weights is None:
            raise ValueError(f"archive {path} has no model weights: neither {WEIGHTS_NAME} (torch) nor "
                             f"{FLAX_WEIGHTS_NAME} (mridc_tpu) is a member (members: {sorted(members)})")
        cfg = loads(tar.extractfile(members[CONFIG_NAME]).read().decode()) or {}
        payload = tar.extractfile(members[weights]).read()
    if isinstance(cfg, dict) and "model" in cfg and "model_name" not in cfg:
        cfg = dict(cfg["model"])  # archives saved with the full config tree
    if weights == WEIGHTS_NAME:
        state = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        return cfg, dict(state)
    from mridc_tpu_torch.utils.params import params_from_jax

    return cfg, params_from_jax(decode_flax_msgpack(payload), cfg)  # with the live BatchNorm statistics, if any


def restore_model(path, override_config: Optional[Dict] = None, device=None):
    """Rebuild ``(model, state_dict, cfg)`` from an archive of either format:
    the model built from the archive's config (updated by
    ``override_config``) on ``device`` (the card unless the caller names
    another) with the archive's weights."""
    from mridc_tpu_torch.models import build_model

    cfg, state = load_archive(path)
    if override_config:
        cfg = {**cfg, **override_config}
    model = build_model(cfg, device=device)
    model.load_state_dict(state)
    return model, state, cfg


def _rank_zero() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class StepCheckpointer:
    """The trainer's step checkpoints in ``directory``: ``save`` keeps the
    ``max_to_keep`` best by ``monitor`` (``mode`` min or max; a checkpoint
    without the metric ranks worst), ``save_last`` an unmanaged ``last``.
    States are the trainer's ``state_dict()``; restores are loaded onto
    ``map_location``. Process 0 writes; every process reads."""

    def __init__(self, directory, max_to_keep: int = 3, monitor: str = "val_loss", mode: str = "min",
                 map_location=None):
        if mode not in ("min", "max"):
            raise ValueError(f"checkpoint mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.map_location = map_location

    def _steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir() if p.name.isdigit()
                      and (p / _STATE_NAME).exists())

    def _metric(self, step: int) -> float:
        metrics = json.loads((self.directory / str(step) / "metrics.json").read_text())
        value = metrics.get(self.monitor)
        worst = -math.inf if self.mode == "max" else math.inf
        return worst if value is None or math.isnan(value) else float(value)

    def _ranked(self):
        """Kept steps, best first (ties: the later step first)."""
        sign = 1.0 if self.mode == "min" else -1.0
        return sorted(self._steps(), key=lambda s: (sign * self._metric(s), -s))

    def _write(self, path: Path, state: Dict, metrics: Optional[Dict[str, float]] = None) -> None:
        if _rank_zero():
            if path.exists():
                shutil.rmtree(path)
            tmp = path.with_name(path.name + ".tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            torch.save(state, tmp / _STATE_NAME)
            (tmp / "metrics.json").write_text(json.dumps({k: float(v) for k, v in (metrics or {}).items()}))
            tmp.rename(path)
        _barrier()

    def save(self, step: int, state: Dict, metrics: Optional[Dict[str, float]] = None) -> None:
        self._write(self.directory / str(int(step)), state, metrics)
        if _rank_zero():
            for s in self._ranked()[self.max_to_keep:]:
                shutil.rmtree(self.directory / str(s))
        _barrier()

    def _load(self, path: Path) -> Optional[Dict]:
        if not (path / _STATE_NAME).exists():
            return None
        return torch.load(path / _STATE_NAME, map_location=self.map_location, weights_only=False)

    def restore(self, step: Optional[int] = None) -> Optional[Dict]:
        """The checkpoint of ``step`` (default: the latest kept); None if none."""
        step = self.latest_step() if step is None else step
        return None if step is None else self._load(self.directory / str(int(step)))

    def save_last(self, state: Dict) -> None:
        """The unmanaged ``last`` checkpoint (end of training, SIGTERM), outside
        the top-k bookkeeping."""
        self._write(self.directory / "last", state)

    def restore_last(self) -> Optional[Dict]:
        return self._load(self.directory / "last")

    def restore_best(self) -> Optional[Dict]:
        """The best monitored checkpoint (None if nothing is kept)."""
        step = self.best_step()
        return None if step is None else self.restore(step)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[0] if ranked else None
