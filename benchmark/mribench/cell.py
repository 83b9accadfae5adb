"""One run of one cell: set-up from the seed, the timed window, the traced
calls, then the reference and the verdict.

Set-up builds the program (``Trainer`` over the configuration's model with
the seed's weights), makes the pool of distinct slices and warms every shape
the window uses. Serving warms with ``mix["warmup"]`` batches; training takes
its first three steps, which the check reads, through the window's own call
on three distinct batches, and hands the same trainer to the window. The
window then calls ``Trainer.predict_batch`` or ``Trainer.training_batch``
back to back on host numpy batches (a closed loop, one caller) until
``seconds`` have passed, and ends with the last call's result on the host or
a synchronise. With ``trace`` the run then profiles ``mix["trace_calls"]``
more calls, each in a harness span.

Once the window has closed, the peak memory been read and the program freed,
the reference recomputes what the check compares (see ``checks``).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mribench import checks, devtrace
from mribench.flops import MODEL_PEAK
from mribench.models import draw_weights
from mribench.spec import Cell, limits_of, metric_reader
from mribench.traffic import Pool, make_pool, seed_stream
from reference.common import Precision, as_complex
from reference.train import Adam, loss_and_grads, lr_at, max_steps_of

__all__ = ["Program", "setup", "run", "program_config", "reference_predictions", "reference_training",
           "serving_numbers", "first_steps"]

WINDOW_SPAN = "bench.profiled_calls"
CALL_SPAN = {"serve": "bench.predict_batch", "train": "bench.training_batch"}
CHECKED_STEPS = 3
REFERENCE_ROWS = 2  # rows a block of the reference's training gradient: what fits the card in float32


def program_config(cell: Cell) -> dict:
    """The configuration the program is built from: the configuration file's
    model block with the mix's settings of path and precision over it."""
    return {**cell.cfg["model"], **cell.mix.get("model", {})}


def make_weights(cell: Cell, pcfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw_weights(cell.model.weight_shapes(pcfg, float(cell.cfg["weights_gain"])), seed, device)


class Program:
    """The system under test as the window drives it."""

    def __init__(self, cell: Cell, pcfg: dict, weights: Dict[str, torch.Tensor], device):
        from mridc_tpu_torch.train.trainer import Trainer

        model = cell.model.build_program(pcfg, weights, device)
        if cell.serving:
            self.trainer = Trainer(model, device=device)
        else:
            t = cell.mix["train"]
            self.trainer = Trainer(model, optim_cfg=t["optim"], trainer_cfg=t["trainer"], loss_type=t["loss"],
                                   device=device)
            self.trainer.setup_optimization(int(t["num_samples"]), int(cell.mix["batch"]))
            self.trainer.init_state()
        self.serving = cell.serving

    def __call__(self, batch):
        if self.serving:
            return self.trainer.predict_batch(batch)
        return self.trainer.training_batch(batch)


def _tensors(batch: dict, device) -> Tuple[torch.Tensor, ...]:
    y = as_complex(batch["masked_kspace"]).to(device)
    sens = as_complex(batch["sensitivity_maps"]).to(device)
    mask = torch.as_tensor(batch["mask"]).to(device)
    target = torch.as_tensor(batch["target"]).to(device) if "target" in batch else None
    return y, sens, mask, target


def first_steps(program: Program, pool: Pool, beta1: float) -> dict:
    """The three checked steps: each step's loss, the first gradient's norm
    by leaf (from Adam's first moment after one step, m = (1 - beta1) g) and
    the parameters' change after three steps by leaf."""
    trainer = program.trainer
    params = dict(trainer.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grad = [], {}
    for i in range(CHECKED_STEPS):
        out = program(pool.batch(i))
        losses.append(float(out["loss"]))
        if i == 0:
            state = trainer.state.optimizer.state
            # a parameter the optimizer has not stepped has no moment: no reading
            grad = {k: float(state[p]["exp_avg"].norm()) / (1 - beta1) if "exp_avg" in state.get(p, {})
                    else math.nan for k, p in params.items()}
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grad": grad, "change": change}


def setup(cell: Cell, seed: int, device):
    """(program config, weights, pool, program)."""
    pcfg = program_config(cell)
    weights = make_weights(cell, pcfg, seed, device)
    pool = make_pool(cell.cfg, pcfg, cell.mix, seed, device)
    program = Program(cell, pcfg, weights, device)
    return pcfg, weights, pool, program


def _window(program: Program, pool: Pool, start: int, seconds: float, keep: int, rng) -> dict:
    """Calls back to back until ``seconds`` have passed; serving keeps a
    reservoir sample of ``keep`` answers (pool index, prediction)."""
    lat, kept, n = [], [], 0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        i = start + n
        t = time.perf_counter()
        out = program(pool.batch(i))
        if program.serving:
            lat.append(time.perf_counter() - t)
            if len(kept) < keep:
                kept.append((i % len(pool.batches), out))
            else:
                j = int(rng.integers(0, n + 1))
                if j < keep:
                    kept[j] = (i % len(pool.batches), out)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if not program.serving and torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"calls": n, "seconds": time.perf_counter() - t0, "latencies": lat, "kept": kept}


def _traced(program: Program, pool: Pool, start: int, calls: int, mode: str) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            for j in range(calls):
                with record_function(CALL_SPAN[mode]):
                    program(pool.batch(start + j))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return devtrace.collect(prof, WINDOW_SPAN, [CALL_SPAN[mode]])


def reference_predictions(cell: Cell, pcfg: dict, weights, pool: Pool, indices, prec: Precision, device):
    """{pool index: the reference's prediction [B, H, W] complex}."""
    out = {}
    with prec.flags(), torch.no_grad():
        for i in sorted(set(indices)):
            y, sens, mask, _ = _tensors(pool.batch(i), device)
            out[i] = cell.model.reference.forward(weights, pcfg, y, sens, mask, bool(pcfg["fft_centered"]),
                                                  str(pcfg["fft_normalization"]), prec)[-1]
    return out


def serving_numbers(kept: List[Tuple[int, np.ndarray]], refs: Dict[int, torch.Tensor], batch: int) -> dict:
    """The sampled answers' relative l2 gap to the reference's, pooled over
    every slice of them: sqrt(sum ||p - r||^2 / sum ||r||^2)."""
    err, ref = 0.0, 0.0
    for i, pred in kept:
        r = refs[i]
        p = torch.as_tensor(np.asarray(pred, np.float32)).to(r.device)
        if p.shape != (batch,) + tuple(r.shape[1:]) + (2,):
            return {"pred_rel_l2": math.inf}  # an answer missing or of another shape
        p = torch.view_as_complex(p.contiguous())
        err += float((p - r).abs().pow(2).sum())
        ref += float(r.abs().pow(2).sum())
    return {"pred_rel_l2": math.sqrt(err / ref) if ref > 0 else math.nan}


def reference_training(cell: Cell, pcfg: dict, weights, pool: Pool, prec: Precision, device) -> dict:
    """The three checked steps computed by the reference: losses, first
    gradient norms by leaf, change norms by leaf."""
    t = cell.mix["train"]
    b = int(cell.mix["batch"])
    max_steps = max_steps_of(t["trainer"], int(t["num_samples"]), b)
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    adam = Adam(params, betas=t["optim"]["betas"], eps=float(t["optim"].get("eps", 1e-8)))
    losses, grad = [], {}
    steps = cell.model.time_steps(pcfg)
    centered, norm = bool(pcfg["fft_centered"]), str(pcfg["fft_normalization"])
    with prec.flags():
        for i in range(CHECKED_STEPS):
            y, sens, mask, target = _tensors(pool.batch(i), device)

            def fwd(p, rows):
                return cell.model.reference.forward(p, pcfg, y[rows], sens[rows], mask[rows], centered, norm, prec)

            loss, grads = loss_and_grads(params, fwd, target, steps, REFERENCE_ROWS)
            losses.append(float(loss))
            if i == 0:
                grad = {k: float(g.norm()) for k, g in grads.items()}
            adam.step(grads, lr_at(i, t["optim"], max_steps))
            del grads
    change = {k: float((params[k] - weights[k].float()).norm()) for k in params}
    return {"losses": losses, "grad": grad, "change": change}


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run: {"correct", "attempted", "failed", "metrics", "device", "breakdown"?, "checks"}."""
    mode = cell.mix["mode"]
    b = int(cell.mix["batch"])
    cuda = torch.device(device).type == "cuda"
    phases = {"process_to_setup": time.time() - t_start}
    t = time.perf_counter()
    pcfg, weights, pool, program = setup(cell, seed, device)
    phases["weights_pool_program"] = time.perf_counter() - t
    t = time.perf_counter()
    readings: Optional[dict] = None
    if cell.serving:
        for i in range(int(cell.mix["warmup"])):
            program(pool.batch(i))
        start = 0
    else:
        readings = first_steps(program, pool, float(cell.mix["train"]["optim"]["betas"][0]))
        start = CHECKED_STEPS
    phases["warmup"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    win = _window(program, pool, start, seconds, int(cell.mix.get("sample_batches", 0)),
                  np.random.default_rng(seed_stream(seed, 2)))
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    slices = win["calls"] * b
    rate = slices / win["seconds"]
    e2e = {"setup_s": setup_s, "peak_mem_gib": window_peak / 2**30}
    if cell.serving:
        e2e["recon_slices_per_s"] = rate
        e2e["recon_batch_p95_ms"] = float(np.percentile(np.asarray(win["latencies"]) * 1e3, 95))
    else:
        e2e["train_slices_per_s"] = rate
    result = {"attempted": slices, "failed": 0, "setup_phases_s": phases}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1}
    metrics = {}
    if trace:
        calls = int(cell.mix["trace_calls"])
        ctx = _traced(program, pool, start + win["calls"], calls, mode)
        scale = 3.0 if mode == "train" else 1.0  # a training step: the forward and twice its work backward
        ctx.update(slices=calls * b, slices_per_s=rate, bounds=cell.model.kernel_bounds(cell.cfg, pcfg, b),
                   flops_per_slice=scale * cell.model.forward_flops(cell.cfg, pcfg),
                   peak_flops=MODEL_PEAK[str(pcfg.get("compute_dtype") or "float32")])
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = ctx["window"]
        dev.update(busy_s=devtrace.busy_s(ctx), window_s=(hi - lo) / 1e6)
        result["breakdown"] = devtrace.breakdown(ctx)
        del ctx
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    dev["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated() if cuda else 0)
    kept = win.pop("kept")
    program.trainer = None  # the program's model, optimizer and state go
    _free()

    t = time.perf_counter()
    prec = Precision("float32")
    if cell.serving:
        refs = reference_predictions(cell, pcfg, weights, pool, [i for i, _ in kept], prec, device)
        numbers = serving_numbers(kept, refs, b)
    else:
        numbers = checks.training_numbers(readings, reference_training(cell, pcfg, weights, pool, prec, device))
    phases["reference_after_window"] = time.perf_counter() - t
    ok, shown = checks.verdict(numbers, limits_of(cell))
    result.update(correct=ok, metrics=metrics, device=dev)
    result["checks"] = shown
    return result
