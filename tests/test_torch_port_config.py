"""Port parity: config loading and validation. ``mridc_tpu_torch.train.config``
and ``train.schemas`` against ``mridc_tpu``'s on every ``projects/`` config
(the dicts and the problem lists must be equal), the override syntax on a
table of values, the port's JSON-text configs read back by the JAX package,
and chip_smoke.py's phase-L literal against the YAML it stands for.
"""

import sys
from pathlib import Path

import pytest
import yaml

from mridc_tpu.train import config as jconfig
from mridc_tpu.train import schemas as jschemas
from mridc_tpu_torch.train import config, schemas

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(ROOT.glob("projects/*/conf/*.yaml"))


def test_every_project_config_is_listed():
    assert len(CONFIGS) == 87


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: f"{p.parent.parent.name}/{p.stem}")
def test_load_and_validate_match_jax(path):
    got, want = config.load_config(path), jconfig.load_config(path)
    assert got == want
    raw = yaml.safe_load(path.read_text())
    assert config.maybe_update_config_version(raw) == jconfig.maybe_update_config_version(raw)
    assert schemas.validate_config(got, strict=False) == jschemas.validate_config(want, strict=False)


OVERRIDES = [
    "model.optim.lr=1e-3", "model.optim.betas=[0.9, 0.98]", "trainer.max_steps=-1", "mode=test",
    "checkpoint=null", "pretrained=true", "model.train_ds.data_path=/data/knee/train", "+new.key=1",
    "model.conv_filters=[8,8,2]", "exp_manager.name=run_1", "trainer.val_check_interval=0.5",
    "model.fft_normalization=ortho", "x.y=yes", "x.z=~", "x.w=1_000", "x.v='quoted'", 'x.u="dq"',
    "x.t={a: 1}", "x.s=1.5e+3", "x.r=NaNx",
]


@pytest.mark.parametrize("item", OVERRIDES)
def test_overrides_match_jax(item):
    base = {"model": {"optim": {"lr": 0.1}, "train_ds": {}}, "trainer": {}, "exp_manager": {}}
    assert config.apply_overrides(base, [item]) == jconfig.apply_overrides(base, [item])
    value = item.partition("=")[2]
    assert config.parse_value(value) == jconfig.parse_value(value)


@pytest.mark.parametrize("bad", ["model.optim.lr.x=1", "no_equals_sign"])
def test_bad_overrides_raise_as_jax(bad):
    base = {"model": {"optim": {"lr": 0.1}}}
    for mod in (config, jconfig):
        with pytest.raises(ValueError):
            mod.apply_overrides(base, [bad])


def test_port_config_file_is_read_back_by_jax(tmp_path):
    """The port writes JSON text; the JAX package's load_config (PyYAML) and
    the port's reader give the config back unchanged."""
    cfg = jconfig.load_config(ROOT / "projects/reconstruction/conf/base_cirim_train.yaml", ["+x.nan=1e-3"])
    config.save_config(cfg, tmp_path / "config.yaml")
    assert jconfig.load_config(tmp_path / "config.yaml") == cfg
    assert config.load_config(tmp_path / "config.yaml") == cfg
    assert yaml.safe_load((tmp_path / "config.yaml").read_text()) == cfg


def test_validate_config_raises_on_a_typo():
    cfg = config.load_config(ROOT / "projects/reconstruction/conf/base_cirim_train.yaml",
                             ["trainer.max_epoch=3", "model.optim.name=adamm"])
    with pytest.raises(schemas.ConfigValidationError, match="max_epochs"):
        schemas.validate_config(cfg)
    assert schemas.validate_config(cfg, strict=False) == jschemas.validate_config(cfg, strict=False)


def test_chip_smoke_launch_config_is_the_yaml():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.LAUNCH_CFG == yaml.safe_load(
        (ROOT / "projects/reconstruction/conf/base_cirim_train.yaml").read_text())
