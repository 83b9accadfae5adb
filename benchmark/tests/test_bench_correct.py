"""``correct`` on the CPU at a tiny size: sound runs pass, runs with the timed
path broken underneath fail, and the lower-precision control fails.

Each test drives the rest of a run (``mribench.cell.run``: set-up, window,
trace, reference, verdict) past the harness's look for a card, with the
package's CPU path as the program."""

import time

import numpy as np
import pytest
import torch

from mribench import cell as C
from mribench.spec import limits_of

SERVE = ["cirim_psf1d_bf16_serve", "varnet_psf1d_bf16_serve"]
TRAIN = ["cirim_full_f32_train"]
SEED = 2**31 + 977


def _run(cell, trace=False):
    return C.run(cell, SEED, 0.5, trace, torch.device("cpu"), time.time())


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_run_is_correct(tiny, name):
    r = _run(tiny(name), trace=True)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"] and all(m["value"] == m["value"] for m in r["metrics"].values())


def _broken_predict(kind):
    from mridc_tpu_torch.train.trainer import Trainer

    plain = Trainer.predict_batch

    def predict(self, batch, use_ema=False):
        out = plain(self, batch, use_ema)
        if kind == "answers_swapped":  # each slice handed its neighbour's answer
            out = np.roll(out, 1, axis=0)
        else:  # half of the batch never computed
            out = out.copy()
            out[out.shape[0] // 2:] = 0
        return out

    return predict


@pytest.mark.parametrize("kind", ["answers_swapped", "half_batch_missing"])
@pytest.mark.parametrize("name", SERVE)
def test_broken_serving_is_not_correct(tiny, monkeypatch, name, kind):
    from mridc_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "predict_batch", _broken_predict(kind))
    r = _run(tiny(name))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch_mean", "gradient_altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_broken_training_is_not_correct(tiny, monkeypatch, name, kind):
    from mridc_tpu_torch.train.trainer import Trainer

    if kind == "state_unchanged":  # the optimizer never steps
        def step(self, opt, params, norm=None):
            self.state.gradient_step += 1
        monkeypatch.setattr(Trainer, "_optimizer_step", step)
    elif kind == "gradient_altered":  # the gradient the optimizer gets is off by half
        plain_step = Trainer._optimizer_step

        def step(self, opt, params, norm=None):
            for p in params:
                p.grad.mul_(1.5)
            plain_step(self, opt, params, norm)
        monkeypatch.setattr(Trainer, "_optimizer_step", step)
    else:  # half of each batch left out, the mean taken over the rest
        plain_batch = Trainer.training_batch

        def batch_half(self, batch):
            half = batch["masked_kspace"].shape[0] // 2
            return plain_batch(self, {k: v[:half] for k, v in batch.items()})
        monkeypatch.setattr(Trainer, "training_batch", batch_half)
    r = _run(tiny(name))
    assert not r["correct"], r["checks"]


# image side at which the published depths and widths run in seconds on the CPU
# (VarNet's four pools want a multiple of 16)
CONTROL_HW = {"cirim_psf1d_bf16_serve": 32, "varnet_psf1d_bf16_serve": 64}


def _published(tiny, name):
    """The cell at its configuration's depths and widths, 3 coils, a small image, batch 2."""
    from mribench.spec import load_cell

    cell = tiny(name, batch=2)
    cell.cfg["model"] = load_cell(name).cfg["model"]
    cell.cfg.update(height=CONTROL_HW[name], width=CONTROL_HW[name])
    return cell


@pytest.mark.parametrize("name", sorted(CONTROL_HW))
def test_fp8_control_is_not_correct(tiny, name):
    """The reference in fp8 in the program's place reads outside the cell's
    limits, where the program reads inside them (the bfloat16 cells: fp8 is
    the precision below)."""
    import calibrate

    cell = _published(tiny, name)
    recs = list(calibrate.readings(cell, [SEED], 0.3, True, False, torch.device("cpu")))
    limits = limits_of(cell)
    assert any(recs[0]["control"][k] > limits[k] for k in limits), (recs[0]["control"], limits)
    assert all(recs[0]["program"][k] <= limits[k] for k in limits), (recs[0]["program"], limits)


@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_the_card(tiny):
    """The float32 cell's control, the reference with TF32 products, needs the
    card's TF32 path: it reads outside the cell's limits there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist on the card only")
    import calibrate

    cell = tiny("cirim_full_f32_train", batch=4)
    cell.cfg.update(height=128, width=128)
    recs = list(calibrate.readings(cell, [SEED], 0.5, True, False, torch.device("cuda")))
    limits = limits_of(cell)
    assert any(recs[0]["control"][k] > limits[k] for k in limits), (recs[0]["control"], limits)
