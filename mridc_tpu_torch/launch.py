"""Entry point: ``python -m mridc_tpu_torch.launch --config-path conf
--config-name x.yaml [k=v ...]`` (counterpart of ``mridc_tpu/launch.py``): the
``model:/trainer:/exp_manager:/mode:`` config, ``mode: train`` validates and
then fits, any other mode tests and writes the reconstructions.

The run is on the card unless ``run_from_config`` is given ``device="cpu"``
or the config says ``trainer.accelerator: cpu``; the configs' ``tpu`` means the
card here. Reconstruction, segmentation, multitask and quantitative
models. The segmentation task reads volumes with their labels through
``SegmentationMRIDataset``, ``SegmentationDataTransforms`` and
``SegBatchLoader``, trains with ``SegmentationTrainer`` and its ``mode:
test`` writes each volume's predicted classes (``segmentation``). The
multitask task reads them through ``RSMRIDataset``, ``RSMRIDataTransforms``
(every transform knob of the dataset config, as the reconstruction loader
takes them) and ``RSBatchLoader``, trains with ``MultitaskTrainer`` (the
``total_{segmentation,reconstruction}_loss_weight`` keys) and its ``mode:
test`` writes each volume's ``reconstruction`` and ``segmentation``. The
quantitative task reads
AHEAD-format volumes through ``qMRIDataset`` and ``QBatchLoader`` (the
model config's ``TEs``; ``fft_centered`` true and ``fft_normalization``
"ortho" where the model config omits them, as the JAX package does) and
trains with ``QuantitativeTrainer``. ``pretrained: true`` takes a ``.mridc``
archive path (of the reference torch format or ``mridc_tpu``'s), a URL or a
registered pretrained name as ``checkpoint``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from mridc_tpu_torch.train.config import load_config, save_config
from mridc_tpu_torch.utils.logging import get_logger

logger = get_logger()

__all__ = ["model_task", "run_from_config", "main", "maybe_init_distributed"]

SEGMENTATION_MODELS = {
    "SEGMENTATIONUNET", "SEGMENTATION2DUNET", "SEGMENTATION3DUNET",
    "SEGMENTATIONATTENTIONUNET", "SEGMENTATIONLAMBDAUNET", "SEGMENTATIONVNET",
    "SEGMENTATIONDYNUNET", "SEGMENTATIONUNETR",
}
MULTITASK_MODELS = {"MTLRS", "JRSCIRIM", "IDSLR", "IDSLRUNET", "SEGNET", "RECSEGNET", "RECSEGUNET", "SERANET"}


def model_task(model_name: str) -> str:
    name = str(model_name).upper()
    if name in SEGMENTATION_MODELS:
        return "segmentation"
    if name in MULTITASK_MODELS:
        return "multitask"
    if name.startswith("Q"):
        return "quantitative"
    return "reconstruction"


def _build_task_loader(task, ds_cfg, model_cfg, shuffle, device):
    from mridc_tpu_torch.data.factory import async_loader, build_dataloader

    if task == "segmentation":
        from mridc_tpu_torch.data.seg_pipeline import SegBatchLoader, SegmentationDataTransforms
        from mridc_tpu_torch.data.task_loaders import SegmentationMRIDataset

        tfm = SegmentationDataTransforms(
            complex_data=ds_cfg.get("complex_data", True), magnitude_input=model_cfg.get("magnitude_input", True),
            input_channels=model_cfg.get("segmentation_module_input_channels", 1),
            output_classes=model_cfg.get("segmentation_module_output_channels"),
            fft_centered=ds_cfg.get("fft_centered", model_cfg.get("fft_centered", False)),
            fft_normalization=ds_cfg.get("fft_normalization", model_cfg.get("fft_normalization", "backward")),
            coil_combination_method=ds_cfg.get("coil_combination_method", "RSS"))
        ds = SegmentationMRIDataset(root=ds_cfg["data_path"], segmentations_root=ds_cfg.get("segmentations_path"),
                                    complex_data=ds_cfg.get("complex_data", True),
                                    sample_rate=ds_cfg.get("sample_rate"),
                                    consecutive_slices=ds_cfg.get("consecutive_slices", 1), transform=tfm)
        return async_loader(lambda **kw: SegBatchLoader(ds, batch_size=ds_cfg.get("batch_size", 1), shuffle=shuffle,
                                                        **kw), ds_cfg, device=device)
    if task == "multitask":
        from mridc_tpu_torch.data.factory import transform_kwargs
        from mridc_tpu_torch.data.seg_pipeline import RSBatchLoader, RSMRIDataTransforms
        from mridc_tpu_torch.data.task_loaders import RSMRIDataset

        tfm = RSMRIDataTransforms(output_classes=model_cfg.get("segmentation_module_output_channels"),
                                  **transform_kwargs(ds_cfg, model_cfg))
        ds = RSMRIDataset(root=ds_cfg["data_path"], segmentations_root=ds_cfg.get("segmentations_path"),
                          sample_rate=ds_cfg.get("sample_rate"),
                          consecutive_slices=ds_cfg.get("consecutive_slices", 1), transform=tfm)
        return async_loader(lambda **kw: RSBatchLoader(ds, batch_size=ds_cfg.get("batch_size", 1), shuffle=shuffle,
                                                       **kw), ds_cfg, device=device)
    if task != "quantitative":
        return build_dataloader(ds_cfg, model_cfg, shuffle=shuffle, device=device)
    from mridc_tpu_torch.data.seg_pipeline import QBatchLoader
    from mridc_tpu_torch.data.subsample import create_masker
    from mridc_tpu_torch.data.task_loaders import qMRIDataset

    mask_args = ds_cfg.get("mask_args") or {}
    mask_func = None
    if mask_args.get("type"):
        mask_func = create_masker(mask_args["type"], mask_args.get("center_fractions", [0.08]),
                                  mask_args.get("accelerations", [4]))
    ds = qMRIDataset(root=ds_cfg["data_path"], sample_rate=ds_cfg.get("sample_rate"),
                     consecutive_slices=ds_cfg.get("consecutive_slices", 1))
    return async_loader(
        lambda **kw: QBatchLoader(
            ds, tes=model_cfg.get("TEs", [3.0, 11.5, 20.0, 28.5]), mask_func=mask_func,
            batch_size=ds_cfg.get("batch_size", 1), shuffle=shuffle,
            fft_centered=model_cfg.get("fft_centered", True),
            fft_normalization=model_cfg.get("fft_normalization", "ortho"),
            compute_target=bool(model_cfg.get("use_reconstruction_module", False)), **kw),
        ds_cfg, device=device)


def maybe_init_distributed(trainer_cfg: dict, device):
    """Join the process group from the standard env vars when the config asks
    for several nodes or ``WORLD_SIZE`` > 1 (``parallel/multihost.py``)."""
    from mridc_tpu_torch.parallel.multihost import initialize, process_info

    num_nodes = trainer_cfg.get("num_nodes", 1)
    if (num_nodes and num_nodes > 1) or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if initialize(device):
            rank, count = process_info()
            logger.info(f"torch.distributed initialized: process {rank}/{count}")


_PSF1D_MASK_TYPES = {"random1d", "equispaced1d", "gaussian1d"}
_PSF1D_MODELS = {"CIRIM", "RIM", "MTLRS", "JRSCIRIM", "VN", "E2EVN", "VARNET"}
# VarNet's reduced-state psf1d cascade also needs the DC term and SENSE
_PSF1D_VN_NAMES = {"VN", "E2EVN", "VARNET"}


def _auto_dc_mode(model_cfg: dict) -> dict:
    """``dc_mode: psf1d`` (the exact 1D-mask DC) when the data config
    guarantees 1D column masks: every dataset block draws a 1D mask type,
    loads no mask files and applies no partial-Fourier half-scan, and SSDU and
    noise2recon are off. An explicit ``dc_mode`` wins."""
    name = str(model_cfg.get("model_name", "")).upper()
    if "dc_mode" in model_cfg or name not in _PSF1D_MODELS:
        return model_cfg
    if model_cfg.get("ssdu") or model_cfg.get("n2r"):
        return model_cfg
    if name in _PSF1D_VN_NAMES and (
        model_cfg.get("no_dc") or str(model_cfg.get("coil_combination_method", "SENSE")).upper() != "SENSE"
    ):
        return model_cfg
    blocks = [
        model_cfg.get(k)
        for k in ("train_ds", "validation_ds", "test_ds")
        if isinstance(model_cfg.get(k), dict) and model_cfg[k].get("data_path")
    ]
    if not blocks:
        return model_cfg
    for ds in blocks:
        mask_args = ds.get("mask_args") or {}
        if str(mask_args.get("type", "")).lower() not in _PSF1D_MASK_TYPES:
            return model_cfg
        if ds.get("mask_path") or ds.get("half_scan_percentage") or ds.get("ssdu"):
            return model_cfg
    model_cfg = dict(model_cfg)
    model_cfg["dc_mode"] = "psf1d"
    logger.info("1D column masks detected: enabling dc_mode=psf1d (exact DC fast path)")
    return model_cfg


def _pretrained_state(ckpt):
    """The weights of a ``pretrained: true`` checkpoint: a ``.mridc`` archive
    path, a URL or a registered pretrained name (``models/pretrained.py``)."""
    if ckpt in (None, "", "None", "null"):
        raise ValueError("pretrained: true requires checkpoint: <path | url | registered name>")
    from mridc_tpu_torch.models.pretrained import resolve_pretrained
    from mridc_tpu_torch.train.checkpoints import load_archive

    # the name or URL resolves as from_pretrained resolves it; the weights go
    # into the launcher's own model, so none is built here
    _, state = load_archive(resolve_pretrained(str(ckpt)))
    logger.info(f"Loaded pretrained weights from {ckpt}")
    return state


def run_from_config(cfg: dict, device=None):
    """Train (``mode: train``) or test a model from a run config; returns
    ``(trainer, history)`` or ``(trainer, test metrics)``. On the card unless
    ``device="cpu"`` or ``trainer.accelerator: cpu``."""
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.train.exp_manager import ExpManager
    from mridc_tpu_torch.train.task_trainers import (MultitaskTrainer, QuantitativeTrainer, SegmentationTrainer,
                                                     seg_loss_cfg_from_model_cfg)
    from mridc_tpu_torch.train.trainer import Trainer, _limit_batches
    from mridc_tpu_torch.utils.typecheck import resolve_device

    model_cfg = dict(cfg.get("model") or {})
    trainer_cfg = dict(cfg.get("trainer") or {})
    exp_cfg = dict(cfg.get("exp_manager") or {})
    mode = cfg.get("mode", "train")
    if device is None and str(trainer_cfg.get("accelerator", "")).lower() == "cpu":
        device = "cpu"
    dev = resolve_device(device)

    task = model_task(model_cfg.get("model_name", ""))
    maybe_init_distributed(trainer_cfg, dev)
    model_cfg = _auto_dc_mode(model_cfg)
    model = build_model(model_cfg, device=dev)

    ckpt_params = exp_cfg.get("checkpoint_callback_params") or {}
    exp = ExpManager(
        exp_dir=exp_cfg.get("exp_dir", "experiments"),
        name=exp_cfg.get("name", model_cfg.get("model_name", "run")),
        version=exp_cfg.get("version"),
        resume_if_exists=exp_cfg.get("resume_if_exists", False),
        create_tensorboard_logger=exp_cfg.get("create_tensorboard_logger", False),
        checkpoint_monitor=ckpt_params.get("monitor", "val_loss"),
        checkpoint_mode=ckpt_params.get("mode", "min"),
        save_top_k=ckpt_params.get("save_top_k", 3),
        model_config=model_cfg,
        map_location=dev,
    )
    save_config(cfg, exp.log_dir / "config.yaml")

    ema_cfg = exp_cfg.get("ema")
    if ema_cfg is True:  # `ema: true` shorthand for `ema: {enable: true}`
        ema_cfg = {"enable": True}
    use_ema = bool(ema_cfg.get("enable", False)) if isinstance(ema_cfg, dict) else False
    # the unselfsupervised configs use the reference's `loss_fn` /
    # `n2r_loss_regularization_factor` / `reconstruction_loss_regularization_factor`
    # spellings (reference nn/base.py:86-92)
    if "n2r_loss_regularization_factor" in model_cfg:
        trainer_cfg.setdefault("n2r_loss_weight", float(model_cfg["n2r_loss_regularization_factor"]))
    task_kwargs = {}
    trainer_cls = Trainer
    if task == "segmentation":
        trainer_cls = SegmentationTrainer
        task_kwargs["seg_loss_cfg"] = seg_loss_cfg_from_model_cfg(model_cfg)
        task_kwargs["segmentation_classes_thresholds"] = model_cfg.get("segmentation_classes_thresholds")
    elif task == "multitask":
        trainer_cls = MultitaskTrainer
        task_kwargs["segmentation_loss_weight"] = float(model_cfg.get("total_segmentation_loss_weight", 1.0))
        task_kwargs["reconstruction_loss_weight"] = float(model_cfg.get("total_reconstruction_loss_weight", 1.0))
        task_kwargs["seg_loss_cfg"] = seg_loss_cfg_from_model_cfg(model_cfg)
        task_kwargs["segmentation_classes_thresholds"] = model_cfg.get("segmentation_classes_thresholds")
    elif task == "quantitative":
        trainer_cls = QuantitativeTrainer
        task_kwargs["loss_regularization_factors"] = model_cfg.get("loss_regularization_factors")
    trainer = trainer_cls(
        model,
        **task_kwargs,
        optim_cfg=model_cfg.get("optim"),
        trainer_cfg=trainer_cfg,
        loss_type=model_cfg.get("train_loss_fn", model_cfg.get("loss_fn", "l1")),
        val_loss_type=model_cfg.get("val_loss_fn"),
        use_ema=use_ema,
        loss_regularization_factor=float(model_cfg.get("reconstruction_loss_regularization_factor", 1.0)),
        exp_manager=exp,
        ssdu=bool(model_cfg.get("ssdu", False)),
        kspace_reconstruction_loss=bool(model_cfg.get("kspace_reconstruction_loss", False)),
        log_images=bool(model_cfg.get("log_images", True)),
        device=dev,
    )
    pretrained = _pretrained_state(cfg.get("checkpoint")) if cfg.get("pretrained") else None

    def _first_batch(loader):
        # a first batch of a fresh iteration, where the JAX launcher takes one
        # (it advances a shuffled loader's epoch); a model whose widths follow
        # the data is built at its shapes
        it = iter(loader)
        batch = next(it)
        getattr(it, "close", lambda: None)()
        return batch

    def _install_pretrained(loader):
        batch = _first_batch(loader)
        if trainer.schedule is None:
            trainer.setup_optimization(num_samples=len(getattr(loader, "dataset", [])) or 1,
                                       batch_size=getattr(loader, "batch_size", 1))
        model.load_state_dict(pretrained)
        trainer.init_state(batch)

    if mode == "train":
        train_loader = _build_task_loader(task, model_cfg["train_ds"], model_cfg, True, dev)
        val_ds = model_cfg.get("validation_ds")
        val_loader = (_build_task_loader(task, val_ds, model_cfg, False, dev)
                      if val_ds and val_ds.get("data_path") else None)
        trainer.setup_optimization(num_samples=len(train_loader.dataset), batch_size=train_loader.batch_size)
        if pretrained is not None:
            _install_pretrained(train_loader)
        if exp_cfg.get("resume_if_exists") and trainer.state is None:
            # restore before the initial validation and fit, or a preempted
            # run would restart from fresh weights in its own run dir
            trainer.init_state(_first_batch(train_loader))
            exp.maybe_resume(trainer)
        if val_loader is not None:
            # the starting point on record: validate before fit
            if trainer.state is None:
                trainer.init_state(_first_batch(val_loader))
            initial = trainer.validate(val_loader,
                                       limit=_limit_batches(trainer_cfg.get("limit_val_batches", 1.0), val_loader))
            logger.info("initial validation: " + " ".join(f"{k}={v:.5f}" for k, v in initial.items()))
            for k, v in initial.items():
                exp.log_scalar(k, v, trainer.state.step)
        history = trainer.fit(train_loader, val_loader, max_epochs=trainer_cfg.get("max_epochs", 1))
        return trainer, history
    # test / eval
    test_loader = _build_task_loader(task, model_cfg["test_ds"], model_cfg, False, dev)
    if trainer.state is None:
        if pretrained is not None:
            _install_pretrained(test_loader)
        else:
            batch = _first_batch(test_loader)
            trainer.setup_optimization()
            trainer.init_state(batch)
            exp.maybe_resume(trainer)
    recons, means = trainer.test(test_loader)
    logger.info("Test metrics: " + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
    try:
        import h5py
    except ImportError as e:
        raise ImportError("writing the reconstructions (mode: test) needs h5py (pip install h5py)") from e
    import numpy as np

    out_dir = exp.log_dir / "reconstructions"
    out_dir.mkdir(parents=True, exist_ok=True)
    key = "segmentation" if task == "segmentation" else "reconstruction"  # the predicted classes
    for fname, vol in recons.items():
        with h5py.File(out_dir / fname, "w") as hf:
            for name, data in (vol.items() if isinstance(vol, dict) else ((key, vol),)):
                hf.create_dataset(name, data=np.asarray(data))
    return trainer, means


def main(argv=None):
    parser = argparse.ArgumentParser(description="mridc_tpu_torch launcher")
    parser.add_argument("--config-path", default=".", help="Directory containing the config file")
    parser.add_argument("--config-name", required=True, help="YAML config file name")
    parser.add_argument("overrides", nargs="*", help="key=value dotlist overrides")
    parser.add_argument("--skip-validation", action="store_true",
                        help="Skip structured-schema validation of trainer/optim/exp_manager blocks")
    args = parser.parse_args(argv)

    cfg_file = Path(args.config_path) / args.config_name
    if not cfg_file.suffix:
        cfg_file = cfg_file.with_suffix(".yaml")
    cfg = load_config(cfg_file, args.overrides)
    if not args.skip_validation:
        from mridc_tpu_torch.train.schemas import validate_config

        validate_config(cfg)
    run_from_config(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
