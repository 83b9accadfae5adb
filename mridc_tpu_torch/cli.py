"""Console interface: ``python -m mridc_tpu_torch <subcommand>`` (counterpart of
``mridc_tpu/cli.py``): ``run -c <config> [k=v ...]`` trains or tests from a
config, ``models`` lists the names that build, ``sweep -c <config> --set
key=v1,v2 ...`` runs the product of the swept values as jobs of the port's
launcher (``utils/sweep.py``), and ``app`` serves the run-builder
(``app/``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

__all__ = ["main"]


def _cmd_run(args):
    from mridc_tpu_torch.launch import run_from_config
    from mridc_tpu_torch.train.config import load_config

    run_from_config(load_config(args.config, args.overrides))


def _cmd_models(_args):
    from mridc_tpu_torch.models import available_models

    for name in available_models():
        print(name)


def _cmd_sweep(args):
    from mridc_tpu_torch.utils.sweep import launch_sweep

    sweep = {}
    for item in args.set or []:
        key, eq, values = item.partition("=")
        if not eq or not values:
            raise SystemExit(f"--set expects key=v1,v2,...; got {item!r}")
        sweep[key] = values.split(",")
    cfg_path = Path(args.config)
    codes = launch_sweep(str(cfg_path.parent), cfg_path.name, sweep, num_slots=args.num_slots,
                         jobs_per_slot=args.jobs_per_slot)
    # a job killed by a signal has a negative return code: max() would hide it
    sys.exit(0 if all(c == 0 for c in codes) else 1)


def _cmd_app(args):
    from mridc_tpu_torch.app.server import serve

    serve(host=args.host, port=args.port)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mridc_tpu_torch", description="MRI reconstruction on the GPU (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="Train or evaluate a model from a YAML config")
    run_p.add_argument("-c", "--config", required=True)
    run_p.add_argument("overrides", nargs="*", help="key=value dotlist overrides")
    run_p.set_defaults(func=_cmd_run)

    models_p = sub.add_parser("models", help="List registered model names")
    models_p.set_defaults(func=_cmd_models)

    sweep_p = sub.add_parser("sweep", help="Multirun over config overrides")
    sweep_p.add_argument("-c", "--config", required=True)
    sweep_p.add_argument("--set", action="append", help="key=v1,v2,... (repeatable)")
    sweep_p.add_argument("--num-slots", type=int, default=1)
    sweep_p.add_argument("--jobs-per-slot", type=int, default=1)
    sweep_p.set_defaults(func=_cmd_sweep)

    app_p = sub.add_parser("app", help="Interactive run-builder (stdlib HTTP)")
    app_p.add_argument("--host", default="127.0.0.1")
    app_p.add_argument("--port", type=int, default=8501)
    app_p.set_defaults(func=_cmd_app)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
