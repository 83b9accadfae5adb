"""Port parity: the auxiliary modules of ``mridc_tpu_torch`` against
``mridc_tpu``'s, on the CPU: timers, env parsing, the run context, the sweep's
expansion and slots, debug statistics, the decorators and exceptions
(``tests/test_utils_aux.py:26-158``), ``AggregatorLoss``, the run-builder app
and its HTTP surface on a free local port (``tests/test_app.py:19-169``), and
pretrained models with the download cache (a registered name, an alias, the
first registration winning, a URL cached under the JAX package's key, a
missing name, and a ``mridc_tpu`` archive restored by the port against
``mridc_tpu``'s forward at rtol 2e-3 / atol 2e-4).
"""

import json
import sys
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu.app import forms as jforms
from mridc_tpu.losses.aggregator import AggregatorLoss as JAggregatorLoss
from mridc_tpu.train import checkpoints as jckpt
from mridc_tpu.utils import cloud as jcloud
from mridc_tpu.utils import sweep as jsweep
from mridc_tpu_torch.app import core
from mridc_tpu_torch.app import forms
from mridc_tpu_torch.app.server import serve_in_thread
from mridc_tpu_torch.losses.aggregator import AggregatorLoss
from mridc_tpu_torch.models import pretrained
from mridc_tpu_torch.train.config import load_config
from mridc_tpu_torch.train.schemas import ConfigValidationError
from mridc_tpu_torch.utils import cloud, sweep
from mridc_tpu_torch.utils.debug import intermediate_stats, tree_stats
from mridc_tpu_torch.utils.env import (CoercionError, RequiredSettingMissingError, get_envbool, get_envdict,
                                       get_envfloat, get_envint, get_envlist)
from mridc_tpu_torch.utils.run_context import RunContext, get_run_context, set_run_context
from mridc_tpu_torch.utils.timers import NamedTimer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_cirim import _cfg as cirim_cfg  # noqa: E402
from test_torch_port_cirim import _data as cirim_data  # noqa: E402
from test_torch_port_cirim import _jax_forward, _jax_params  # noqa: E402

# ---- tests/test_utils_aux.py ----


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_named_timer():
    t = NamedTimer()
    t.start("a")
    t.stop("a")
    assert t.get("a") >= 0
    t.start("b")
    assert "b" in t.active_timers
    t.stop("b")
    assert t.export().keys() == {"a", "b"}
    with pytest.raises(RuntimeError):
        t.stop("nope")
    with pytest.raises(RuntimeError, match="twice"):
        t.start("c")
        t.start("c")
    t2 = NamedTimer(buffer_size=2, sync_device=True, reduction="max")
    for _ in range(4):
        t2.start()
        t2.stop(probe=torch.zeros(1))
    assert t2.get() >= 0 and len(t2.timers[""]["buffer"]) == 2


def test_env_parsing(monkeypatch):
    monkeypatch.setenv("MRIDC_T_INT", "42")
    monkeypatch.setenv("MRIDC_T_BOOL", "false")
    monkeypatch.setenv("MRIDC_T_FLOAT", "1.5")
    monkeypatch.setenv("MRIDC_T_LIST", "a b c")
    monkeypatch.setenv("MRIDC_T_DICT", '{"a": 1}')
    assert get_envint("MRIDC_T_INT") == 42
    assert get_envbool("MRIDC_T_BOOL") is False
    # the reference's truth table: f/none falsy, off/empty truthy (env_var_parsing.py:74-87)
    monkeypatch.setenv("MRIDC_T_BOOL2", "f")
    assert get_envbool("MRIDC_T_BOOL2") is False
    monkeypatch.setenv("MRIDC_T_BOOL3", "off")
    assert get_envbool("MRIDC_T_BOOL3") is True
    assert get_envfloat("MRIDC_T_FLOAT") == 1.5
    assert get_envlist("MRIDC_T_LIST") == ["a", "b", "c"]
    monkeypatch.setenv("MRIDC_T_LIST2", "a,b")
    assert get_envlist("MRIDC_T_LIST2", separator=",") == ["a", "b"]
    assert get_envdict("MRIDC_T_DICT") == {"a": 1}
    assert get_envint("MRIDC_T_MISSING", 7) == 7
    with pytest.raises(RequiredSettingMissingError):
        get_envint("MRIDC_T_MISSING2")
    monkeypatch.setenv("MRIDC_T_BAD", "notanint")
    with pytest.raises(CoercionError):
        get_envint("MRIDC_T_BAD")


def test_run_context():
    """One process without a group: world size 1, index 0; a context with a
    mesh reads its data axis."""
    from mridc_tpu_torch.parallel.mesh import make_mesh

    ctx = get_run_context()
    assert ctx.process_index == 0 and ctx.world_size == 1 and ctx.data_parallel_size == 1
    ctx2 = RunContext(exp_name="x", mesh=make_mesh())
    assert ctx2.data_parallel_size == 1
    set_run_context(ctx2)
    try:
        assert get_run_context() is ctx2
    finally:
        set_run_context(ctx)


def test_expand_sweep_matches_jax():
    spec = {"model.lr": [1e-3, 1e-4], "model.n": [2, 4]}
    jobs = sweep.expand_sweep(spec)
    assert jobs == jsweep.expand_sweep(spec) and len(jobs) == 4
    assert ["model.lr=0.001", "model.n=2"] in jobs


def test_launch_sweep_slots_and_commands(monkeypatch, tmp_path):
    """Four jobs over two slots, one job a slot at a time: each runs the
    port's launcher with its overrides and its slot's card, and every return
    code comes back in job order."""
    seen = []
    real = sweep.subprocess.Popen

    def popen(cmd, env):
        seen.append((cmd, env["CUDA_VISIBLE_DEVICES"], env["MRIDC_TPU_SWEEP_SLOT"]))
        code = 3 if cmd[-1] == "model.n=4" and cmd[-2] == "model.lr=0.0001" else 0
        return real([sys.executable, "-c", f"import sys; sys.exit({code})"])

    monkeypatch.setattr(sweep.subprocess, "Popen", popen)
    codes = sweep.launch_sweep(str(tmp_path), "x.yaml", {"model.lr": [1e-3, 1e-4], "model.n": [2, 4]},
                               num_slots=2, poll_interval=0.05)
    assert codes == [0, 0, 0, 3]
    assert [c[-2:] for c, _, _ in seen] == [o for o in sweep.expand_sweep({"model.lr": [1e-3, 1e-4],
                                                                           "model.n": [2, 4]})]
    assert all(c[:3] == [sys.executable, "-m", "mridc_tpu_torch.launch"] for c, _, _ in seen)
    assert all(dev == slot for _, dev, slot in seen) and {dev for _, dev, _ in seen} == {"0", "1"}


def test_debug_stats():
    """Forward hooks keyed by module path; a state dict's and the gradients'
    statistics keyed by name."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.ReLU(), torch.nn.Linear(8, 4))
    x = torch.ones(2, 3)
    stats = intermediate_stats(m, x)
    assert set(stats) == {"", "0", "1", "2"}
    np.testing.assert_allclose(stats["2"]["mean"], float(m(x).detach().mean()), rtol=1e-6)
    assert stats["1"]["abs_max"] == pytest.approx(float(m[0](x).detach().clamp(min=0).max()))
    (m(x) ** 2).mean().backward()
    gs = tree_stats({k: p.grad for k, p in m.named_parameters()})
    assert set(gs) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    assert tree_stats(m.state_dict(), prefix="m")


def test_deprecated_and_experimental_decorators():
    from mridc_tpu_torch.utils.decorators import deprecated, experimental

    calls = []

    @deprecated(version="9.9", explanation="use new_fn")
    def old_fn(x):
        calls.append(x)
        return x * 2

    assert old_fn(3) == 6 and old_fn(4) == 8
    assert calls == [3, 4]

    @experimental
    class Thing:
        def __init__(self, v):
            self.v = v

    assert Thing(5).v == 5


def test_framework_exceptions():
    from mridc_tpu_torch.utils.exceptions import CheckpointCompatibilityError, MRIDCBaseException

    assert issubclass(CheckpointCompatibilityError, MRIDCBaseException)
    with pytest.raises(MRIDCBaseException):
        raise CheckpointCompatibilityError("bad ckpt")


@pytest.mark.parametrize("weights", [None, [0.5, 2.0, -1.0]])
def test_aggregator_loss_matches_jax(weights):
    vals = [0.25, 1.5, 3.0]
    got = AggregatorLoss(3, weights)(*(torch.tensor(v) for v in vals))
    want = JAggregatorLoss(3, weights)(*(jnp.asarray(v) for v in vals))
    assert float(got) == float(want)
    with pytest.raises(ValueError, match="Expected 3"):
        AggregatorLoss(3, weights)(1.0)
    with pytest.raises(ValueError, match="Length of weights"):
        AggregatorLoss(2, [1.0])


# ---- tests/test_app.py ----


def test_list_tasks_and_models():
    tasks = core.list_tasks()
    assert set(tasks) >= {"reconstruction", "segmentation", "quantitative", "multitask"}
    models = {m["name"]: m for m in core.list_models("reconstruction")}
    assert "cirim" in models
    assert "train" in models["cirim"]["modes"]
    assert models["cirim"]["display"] == "CIRIM"


def test_load_defaults_and_flatten():
    cfg = core.load_defaults("reconstruction", "cirim", "train")
    assert cfg["mode"] == "train"
    fields = dict(core.flatten_config(cfg))
    assert fields["model.model_name"] == "CIRIM"
    assert "model.optim.lr" in fields


def test_build_config_overrides_and_validation():
    cfg = core.build_config("reconstruction", "cirim", "train", {"model.optim.lr": 3e-4, "trainer.max_epochs": 2})
    assert cfg["model"]["optim"]["lr"] == 3e-4
    assert cfg["trainer"]["max_epochs"] == 2
    with pytest.raises(ConfigValidationError, match="max_epochs"):
        core.build_config("reconstruction", "cirim", "train", {"trainer.max_epoch": 2})


def test_export_and_run_command(tmp_path):
    cfg = core.build_config("reconstruction", "cirim", "train", {})
    path = core.export_config(cfg, str(tmp_path))
    assert path.name == "cirim_train.yaml"
    assert load_config(path)["model"]["model_name"] == "CIRIM"
    cmd = core.run_command(str(path))
    assert cmd[1:3] == ["-m", "mridc_tpu_torch.launch"] and cmd[-2:] == ["--config-name", "cirim_train.yaml"]


@pytest.mark.parametrize("task,model,mode", [("reconstruction", "cirim", "train"),
                                             ("segmentation", "segmentation_unet3d", "run"),
                                             ("quantitative", "qvn", "train"), ("multitask", "mtlrs", "train")])
def test_form_spec_equals_the_jax_form(task, model, mode):
    """The same groups, fields, types, defaults and choices as
    ``mridc_tpu``'s form: the port validates the same keys."""
    assert forms.form_spec(task, model, mode) == jforms.form_spec(task, model, mode)


def test_form_spec_groups_types_choices():
    spec = forms.form_spec("reconstruction", "cirim", "train")
    groups = {g["prefix"]: g for g in spec["groups"]}
    assert "model" in groups and "trainer" in groups and "model.optim" in groups
    fields = {f["key"]: f for g in spec["groups"] for f in g["fields"]}
    assert fields["model.optim.name"]["type"] == "choice" and "adam" in fields["model.optim.name"]["choices"]
    assert fields["model.model_name"]["type"] == "choice" and "CIRIM" in fields["model.model_name"]["choices"]
    mask_keys = [k for k in fields if k.endswith("mask_args.type")]
    assert mask_keys and "poisson2d" in fields[mask_keys[0]]["choices"]
    assert any(k.startswith("trainer.") for k, f in fields.items() if f["optional"])
    assert [f for f in fields.values() if f["type"] == "bool"]


@pytest.fixture(scope="module")
def app_url():
    httpd, url = serve_in_thread()
    yield url
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"content-type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_page_tasks_config_and_form(app_url):
    with urllib.request.urlopen(app_url + "/", timeout=30) as r:
        assert r.status == 200 and b"mridc_tpu_torch run builder" in r.read()
    status, tasks = _get(app_url + "/api/tasks")
    assert status == 200 and "reconstruction" in tasks
    status, d = _get(app_url + "/api/models?task=reconstruction")
    assert status == 200 and any(m["name"] == "cirim" for m in d)
    status, d = _get(app_url + "/api/config?task=reconstruction&model=cirim&mode=train")
    keys = [k for k, _ in d["fields"]]
    assert status == 200 and "model.model_name" in keys and "model.optim.lr" in keys
    status, spec = _get(app_url + "/api/form?task=reconstruction&model=cirim&mode=train")
    f0 = spec["groups"][0]["fields"][0]
    assert status == 200 and "text" in f0 and "type" in f0
    status, d = _get(app_url + "/api/log?path=/etc/passwd")
    assert status == 403


def test_http_export_roundtrip_and_typo(app_url, tmp_path):
    status, d = _post(app_url + "/api/export", {
        "task": "reconstruction", "model": "cirim", "mode": "train", "export_dir": str(tmp_path),
        "overrides": {"model.optim.lr": "3e-4", "trainer.max_epochs": "2", "model.optim.name": "adamw"}})
    assert status == 200, d
    cfg = load_config(d["path"])
    assert cfg["model"]["optim"]["lr"] == 3e-4 and cfg["trainer"]["max_epochs"] == 2
    assert cfg["model"]["optim"]["name"] == "adamw"
    assert "mridc_tpu_torch.launch" in d["command"]
    status, d = _post(app_url + "/api/export", {
        "task": "reconstruction", "model": "cirim", "mode": "train", "export_dir": str(tmp_path),
        "overrides": {"trainer.max_epoch": "2"}})
    assert status == 400 and "max_epochs" in d["error"]


# ---- pretrained models and the cache ----


@pytest.fixture
def registry(monkeypatch, tmp_path):
    monkeypatch.setattr(pretrained, "_PRETRAINED", {})
    monkeypatch.setenv("MRIDC_TPU_CACHE_DIR", str(tmp_path / "cache"))
    return pretrained


@pytest.fixture(scope="module")
def jax_archive(tmp_path_factory):
    """A ``mridc_tpu`` archive of a small CIRIM, with its inputs and the JAX
    forward's prediction."""
    y, sens, mask = cirim_data(24, 24, seed=2)
    cfg = cirim_cfg(dc_mode="full")
    params = _jax_params(cfg, y, sens, mask, 6)
    want, _ = _jax_forward(cfg, params, y, sens, mask)
    path = jckpt.save_archive(tmp_path_factory.mktemp("pre") / "cirim_small.mridc", cfg, params)
    return Path(path), (y, sens, mask), want


def test_registry_names_aliases_and_first_registration_wins(registry, jax_archive, tmp_path):
    first = registry.PretrainedModelInfo("cirim_small", "CIRIM, 2 cascades", str(jax_archive[0]),
                                         aliases=("cirim_tiny",))
    registry.register_pretrained_model(first)
    registry.register_pretrained_model(registry.PretrainedModelInfo("cirim_small", "another", str(tmp_path / "x")))
    assert registry.get_available_model_names() == ["cirim_small"]
    assert registry.list_available_models() == [first]
    assert registry.resolve_pretrained("cirim_small") == registry.resolve_pretrained("cirim_tiny") == jax_archive[0]
    assert "pretrained_model_name=cirim_small" in repr(first)
    with pytest.raises(FileNotFoundError, match=r"'nope' is neither a registered pretrained model \(\['cirim_small'"):
        registry.resolve_pretrained("nope")


def test_a_url_cached_under_the_jax_key_is_found_by_both(registry, jax_archive):
    url = "https://models.example.org/cirim/cirim_small.mridc"
    dest = cloud.cache_path(url, "cirim_small.mridc")
    assert dest == jcloud.resolve_cache_dir() / dest.parent.name / "cirim_small.mridc"
    dest.parent.mkdir(parents=True)
    dest.write_bytes(jax_archive[0].read_bytes())
    assert cloud.maybe_download_from_cloud(url, "cirim_small.mridc") == dest
    assert jcloud.maybe_download_from_cloud(url, "cirim_small.mridc") == dest
    registry.register_pretrained_model(registry.PretrainedModelInfo("remote", "by url", url))
    assert registry.resolve_pretrained("remote") == registry.resolve_pretrained(url) == dest


def test_from_pretrained_restores_a_jax_archive_to_the_jax_forward(registry, jax_archive):
    path, (y, sens, mask), want = jax_archive
    registry.register_pretrained_model(registry.PretrainedModelInfo("cirim_small", "CIRIM", str(path)))
    model, state, cfg = registry.from_pretrained("cirim_small", device="cpu")
    _, state2, cfg2 = registry.from_pretrained_variables(str(path), device="cpu",
                                                         override_config={"num_cascades": 2})
    assert cfg["model_name"] == cfg2["model_name"] == "CIRIM" and cfg2["num_cascades"] == 2
    assert all(torch.equal(state[k], state2[k]) for k in state)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (y, sens, mask))).prediction.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(want).max())))
