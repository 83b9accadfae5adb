"""Multi-process data sharding and metric reduction (counterpart of
``mridc_tpu/parallel/multihost.py``), on ``torch.distributed``.

The reference gets per-worker dataset sharding from PTL's DistributedSampler
and sums val/test metrics across workers with DistributedMetricSum
(reference: mridc/collections/common/nn/base.py:26-62, metric aggregation at
reconstruction/nn/base.py:890-913). Here the process index and count are the
default process group's rank and world size, (0, 1) when it is not
initialised, and the reduction is one ``all_reduce`` of a float64 vector:

  - sharding is deterministic and padded to equal per-process length (like
    DistributedSampler: wrap-around padding) so every process runs the same
    number of steps, bit-identical to the JAX package's shards;
  - without an initialised process group both reductions are the identity.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["process_info", "initialize", "shard_indices", "all_sum_scalars", "reduce_mean_stats"]


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info() -> tuple:
    """(process_index, process_count); (0, 1) when not distributed."""
    if not _distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def initialize(device: torch.device) -> bool:
    """Join the default process group from the standard env vars (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when ``WORLD_SIZE`` > 1:
    NCCL on the card (one device a process, by ``LOCAL_RANK``), gloo on the
    CPU. False, and nothing done, for one process or a group already joined."""
    import os

    if _distributed() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return True


def shard_indices(n: int, process_index: int, process_count: int) -> np.ndarray:
    """Disjoint, equal-length index shard for this process.

    Pads the index list to a multiple of process_count by wrapping around
    (torch DistributedSampler semantics) so each process sees the same number
    of examples; strided assignment keeps shards disjoint for the unpadded
    prefix.
    """
    if process_count <= 1:
        return np.arange(n)
    total = ((n + process_count - 1) // process_count) * process_count
    idx = np.arange(total) % max(n, 1)
    return idx[process_index::process_count]


def _all_reduce(values: np.ndarray) -> np.ndarray:
    """Sum a float64 vector over every process of the default group (on the
    card under NCCL, on the CPU under gloo)."""
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_sum_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Sum a dict of scalars across all processes (identity on 1 process)."""
    if not _distributed() or dist.get_world_size() == 1:
        return dict(values)
    keys = sorted(values)
    # guard: values are paired positionally after the sort, so every process
    # must report the SAME key set — a mismatch would silently sum unrelated
    # metrics into each other. The key signature is summed too: every process
    # must see world_size times its own
    sig = np.asarray([len(keys), zlib.crc32(",".join(keys).encode())], np.float64)
    if not np.array_equal(_all_reduce(sig), sig * dist.get_world_size()):
        raise ValueError(f"all_sum_scalars: metric key sets differ across processes (local keys: {keys})")
    summed = _all_reduce(np.asarray([float(values[k]) for k in keys], np.float64))
    return {k: float(v) for k, v in zip(keys, summed)}


def reduce_mean_stats(sums: Dict[str, float], counts: Dict[str, float]) -> Dict[str, float]:
    """Cross-process mean of per-key (sum, count) pairs.

    Keys of ``sums`` and ``counts`` must match; returns sum/count after
    all-reducing both (reference DistributedMetricSum divides the summed
    metric by the summed number of volumes, nn/base.py:890-913).
    """
    merged = {f"s:{k}": v for k, v in sums.items()}
    merged.update({f"n:{k}": float(counts[k]) for k in sums})
    red = all_sum_scalars(merged)
    return {k: red[f"s:{k}"] / max(red[f"n:{k}"], 1.0) for k in sums}
