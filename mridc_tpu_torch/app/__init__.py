"""Interactive run-builder app (counterpart of ``mridc_tpu/app``; reference:
mridc/app/run.py:27-2833, a Streamlit page).

Pick a task, a model and a mode, edit every config field, export the config
and launch the port's run: a dependency-free stdlib HTTP app driven by the
``projects/`` config zoo and the structured schemas
(``train/schemas.py``). ``python -m mridc_tpu_torch app``, then open the
printed URL.
"""

from mridc_tpu_torch.app.core import (
    build_config,
    export_config,
    flatten_config,
    launch_run,
    list_models,
    list_tasks,
    load_defaults,
    run_command,
)

__all__ = [
    "build_config",
    "export_config",
    "flatten_config",
    "launch_run",
    "list_models",
    "list_tasks",
    "load_defaults",
    "run_command",
]
