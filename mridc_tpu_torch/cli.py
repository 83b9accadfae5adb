"""Console interface: ``python -m mridc_tpu_torch <subcommand>`` (counterpart of
``mridc_tpu/cli.py``): ``run -c <config> [k=v ...]`` trains or tests from a
config, ``models`` lists the names that build. ``sweep`` and ``app`` take the
JAX package's arguments and raise: they are ROADMAP.md M13.
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def _cmd_run(args):
    from mridc_tpu_torch.launch import run_from_config
    from mridc_tpu_torch.train.config import load_config

    run_from_config(load_config(args.config, args.overrides))


def _cmd_models(_args):
    from mridc_tpu_torch.models import available_models

    for name in available_models():
        print(name)


def _unported(what):
    def cmd(_args):
        raise NotImplementedError(f"{what} is not ported to mridc_tpu_torch yet: ROADMAP.md M13")

    return cmd


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mridc_tpu_torch", description="MRI reconstruction on the GPU (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="Train or evaluate a model from a YAML config")
    run_p.add_argument("-c", "--config", required=True)
    run_p.add_argument("overrides", nargs="*", help="key=value dotlist overrides")
    run_p.set_defaults(func=_cmd_run)

    models_p = sub.add_parser("models", help="List registered model names")
    models_p.set_defaults(func=_cmd_models)

    sweep_p = sub.add_parser("sweep", help="Multirun over config overrides (not ported: M13)")
    sweep_p.add_argument("-c", "--config", required=True)
    sweep_p.add_argument("--set", action="append", help="key=v1,v2,... (repeatable)")
    sweep_p.add_argument("--num-slots", type=int, default=1)
    sweep_p.add_argument("--jobs-per-slot", type=int, default=1)
    sweep_p.set_defaults(func=_unported("the sweep command (utils/sweep.py)"))

    app_p = sub.add_parser("app", help="Interactive run-builder (not ported: M13)")
    app_p.add_argument("--host", default="127.0.0.1")
    app_p.add_argument("--port", type=int, default=8501)
    app_p.set_defaults(func=_unported("the app command (app/)"))

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
