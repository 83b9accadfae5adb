"""Run context (counterpart of ``mridc_tpu/utils/run_context.py``): the
explicit replacement for the reference's AppState singleton
(reference: mridc/utils/app_state.py:22-71, world, rank and model-parallel
fields with the restore state).

The mesh (``parallel/mesh.py``) is the parallelism state; the world size and
the process index are the default process group's (one process and index 0
without a group; the rank of the cluster's env vars before the group is
joined). A module-level default serves logging and checkpoint code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["RunContext", "get_run_context", "set_run_context", "is_global_rank_zero"]


def is_global_rank_zero() -> bool:
    from mridc_tpu_torch.utils.logging import is_global_rank_zero as _izr

    return _izr()


@dataclass
class RunContext:
    mesh: Optional[Any] = None  # parallel.mesh.Mesh
    log_dir: Optional[Path] = None
    exp_dir: Optional[Path] = None
    checkpoint_dir: Optional[Path] = None
    exp_name: Optional[str] = None
    restore_path: Optional[Path] = None
    is_model_being_restored: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def world_size(self) -> int:
        from mridc_tpu_torch.parallel.mesh import distributed_world

        return distributed_world() or 1

    @property
    def process_index(self) -> int:
        from mridc_tpu_torch.utils.logging import _rank

        return _rank()

    @property
    def data_parallel_size(self) -> int:
        if self.mesh is not None and "data" in self.mesh.shape:
            return self.mesh.shape["data"]
        return self.world_size


_DEFAULT: Optional[RunContext] = None


def get_run_context() -> RunContext:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = RunContext()
    return _DEFAULT


def set_run_context(ctx: RunContext):
    global _DEFAULT
    _DEFAULT = ctx
