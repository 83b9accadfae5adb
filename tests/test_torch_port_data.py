"""Port parity: the data layer of mridc_tpu_torch (masks, transforms, h5
datasets and the batcher, host and device prefetch, the host and device
dataset caches, the loader factory, multi-process sharding and reduction, and
the host metrics) against mridc_tpu's on the CPU.

Every comparison is bit for bit: the same seeded numpy inputs go through
both packages, and masks, transformed samples, batch leaves and metrics must
be equal (bfloat16 leaves by their bit patterns). Device stages run here with
``device="cpu"``.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from mridc_tpu.data import factory as jfactory
from mridc_tpu.data import subsample as jsubsample
from mridc_tpu.data import transforms as jtransforms
from mridc_tpu.data.cache import DeviceDatasetCache as JDeviceDatasetCache
from mridc_tpu.data.loaders import BatchLoader as JBatchLoader
from mridc_tpu.data.loaders import ReconstructionMRIDataset as JDataset
from mridc_tpu.metrics import reconstruction as jmetrics
from mridc_tpu.parallel import multihost as jmultihost
from mridc_tpu_torch.data import factory, subsample, transforms
from mridc_tpu_torch.data.cache import DeviceDatasetCache
from mridc_tpu_torch.data.loaders import BatchLoader, ReconstructionMRIDataset
from mridc_tpu_torch.data.prefetch import DevicePrefetcher
from mridc_tpu_torch.metrics import reconstruction as metrics
from mridc_tpu_torch.parallel import multihost

from fixtures import create_dataset

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "projects/reconstruction/conf/base_cirim_train.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are small, and parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    create_dataset(root, n_files=2, slices=3, coils=4, h=32, w=32)
    return root


def _train_ds():
    with open(YAML) as f:
        return yaml.safe_load(f)["model"]["train_ds"]


# ---- comparison helpers ----


def _np(x):
    """A leaf as numpy; bfloat16 tensors as their ml_dtypes twin (same bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _equal(got, want, where=""):
    """Bit-identical leaves (recursively through lists, tuples and dicts)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (np.ndarray, torch.Tensor, jax.Array)) or isinstance(got, torch.Tensor):
        g, w = _np(got), _np(want)
        if g.dtype != w.dtype and {g.dtype, w.dtype} <= {np.dtype(np.float32), np.dtype(ml_dtypes.bfloat16)}:
            # a stage that upcasts bf16 on the device: exact in float32
            g, w = g.astype(np.float32), w.astype(np.float32)
        assert g.dtype == w.dtype, f"{where}: dtype {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{where}: shape {g.shape} != {w.shape}"
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), f"{where}: values differ"
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


# ---- masks ----

MASK_CASES = {
    "fastmri_320": dict(shape=(1, 15, 320, 320, 2), cf=[0.08], acc=[4], seed=tuple(map(ord, "file_1000.h5"))),
    "odd_37x45_two_choices": dict(shape=(1, 1, 37, 45, 2), cf=[0.08, 0.04], acc=[4, 8], seed=7),
    "half_scan_64": dict(shape=(1, 1, 64, 64, 2), cf=[0.16], acc=[6], seed=(1, 2, 3), half_scan_percentage=0.2,
                         scale=0.05),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
@pytest.mark.parametrize("name", sorted(jsubsample.MASKER_REGISTRY))
def test_every_masker_is_bit_identical(name, case):
    spec = dict(MASK_CASES[case])
    if name == "poisson2d" and spec["shape"][-2] > 64:
        spec["shape"] = (1, 1, 48, 52, 2)  # pure-Python dart throwing: ~2 min a mask at 320 x 320
    assert sorted(subsample.MASKER_REGISTRY) == sorted(jsubsample.MASKER_REGISTRY)
    kw = {k: spec[k] for k in ("half_scan_percentage", "scale") if k in spec}
    got_f = subsample.create_masker(name, spec["cf"], spec["acc"])
    want_f = jsubsample.create_masker(name, spec["cf"], spec["acc"])
    for _ in range(2):  # the shared RandomState is restored after each seeded draw
        got, want = got_f(spec["shape"], spec["seed"], **kw), want_f(spec["shape"], spec["seed"], **kw)
        _equal(got[0], want[0], name)
        assert got[1] == want[1]


def test_create_masker_errors_match_jax():
    with pytest.raises(NotImplementedError, match="not supported"):
        subsample.create_masker("spiral", [0.08], [4])
    with pytest.raises(ValueError, match="should match"):
        subsample.create_masker("random1d", [0.08, 0.04], [4])
    assert subsample.create_masker("equispaced1d", 0.08, 4).accelerations == [4]


def test_temp_seed_keeps_threaded_masks_identical():
    """Worker threads draw seeded masks from one shared RandomState at once:
    each must equal its serial draw (the lock around seed/draw/restore)."""
    masker = subsample.create_masker("gaussian2d", [0.08], [4])
    seeds = [tuple(map(ord, f"file_{i}.h5")) for i in range(16)]
    serial = [masker((1, 1, 48, 48, 2), s)[0] for s in seeds]
    results = [None] * len(seeds)

    def work(i):
        for _ in range(3):
            results[i] = masker((1, 1, 48, 48, 2), seeds[i])[0]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(seeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(results, serial):
        np.testing.assert_array_equal(got, want)


# ---- transforms ----


def _sample(seed=0, coils=4, h=32, w=32):
    """One fixture slice: k-space, maps, no mask, no prediction, RSS target,
    h5-like attrs."""
    from fixtures import make_phantom_volume

    kspace, sens, rss = make_phantom_volume(np.random.default_rng(seed), 1, coils, h, w)
    attrs = {"max": float(rss.max()), "norm": float(np.linalg.norm(rss)), "padding_left": 0, "padding_right": 0,
             "encoding_size": (0, 0, 0), "recon_size": (0, 0, 0)}
    return kspace[0], sens[0], None, np.array([]), rss[0], attrs, "file_0.h5", 0


def _masks(mod, spec):
    if spec is None:
        return None
    return [mod.create_masker(t, [cf], [acc]) for t, cf, acc in spec]


TRANSFORM_CASES = {
    "yaml_train_ds": dict(ds=True),
    "equispaced1d_centered_ortho": dict(masks=[("equispaced1d", 0.08, 4)], kw=dict(fft_centered=True,
                                                                                  fft_normalization="ortho")),
    "gaussian2d_crop_zero_fill": dict(masks=[("gaussian2d", 0.08, 4)], kw=dict(crop_size=(24, 20),
                                                                              kspace_zero_filling_size=(40, 40))),
    "random1d_kspace_crop_after_masking": dict(masks=[("random1d", 0.08, 4)], kw=dict(
        crop_size=(24, 24), kspace_crop=True, crop_before_masking=False)),
    "equispaced2d_rss_minmax": dict(masks=[("equispaced2d", 0.08, 4)], kw=dict(coil_combination_method="RSS",
                                                                              normalization_type="minmax")),
    "gaussian1d_mean_kspace_norm": dict(masks=[("gaussian1d", 0.08, 4)], kw=dict(normalization_type="mean",
                                                                                kspace_normalization=True)),
    "prewhitening_gcc": dict(masks=[("equispaced1d", 0.08, 4)], kw=dict(apply_prewhitening=True,
                                                                       prewhitening_patch_length=8,
                                                                       apply_gcc=True, gcc_virtual_coils=2,
                                                                       gcc_calib_lines=8)),
    "half_scan_shift_mask": dict(masks=[("random1d", 0.08, 4)], kw=dict(half_scan_percentage=0.1, shift_mask=True)),
    "two_accelerations": dict(masks=[("equispaced1d", 0.08, 4), ("equispaced1d", 0.04, 8)], kw={}),
    "no_mask_no_normalisation": dict(masks=None, kw=dict(normalize_inputs=False)),
    "given_mask": dict(masks=[("equispaced1d", 0.08, 4)], kw={}, given_mask=True),
    "ssdu_gaussian": dict(masks=[("poisson2d", 0.7, 4)], kw=dict(ssdu=True, ssdu_acs_block_size=(4, 4))),
    "ssdu_uniform_outer": dict(masks=[("gaussian2d", 0.08, 4)], kw=dict(ssdu=True, ssdu_mask_type="Uniform",
                                                                       ssdu_outer_kspace_fraction=0.3)),
    "n2r": dict(masks=[("gaussian2d", 0.08, 4)], kw=dict(n2r=True, n2r_probability=1.0, n2r_std_devs=(0.1, 0.2),
                                                        n2r_rhos=(0.3, 0.5))),
    "n2r_use_mask": dict(masks=[("gaussian1d", 0.08, 4)], kw=dict(n2r=True, n2r_probability=0.5,
                                                                 n2r_std_devs=(0.0, 0.0), n2r_rhos=(0.4, 0.4),
                                                                 n2r_use_mask=True)),
    "unseeded_with_seeded_rng": dict(masks=[("random1d", 0.08, 4)], kw=dict(use_seed=False)),
}


def _build_transform(mods, spec):
    tmod, smod, fmod = mods
    if spec.get("ds"):
        return fmod.build_transforms(_train_ds())
    return tmod.MRIDataTransforms(mask_func=_masks(smod, spec["masks"]), **spec["kw"])


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transforms_are_bit_identical(case):
    spec = TRANSFORM_CASES[case]
    sample = list(_sample())
    if spec.get("given_mask"):
        sample[2] = (np.random.default_rng(3).random(32) < 0.3).astype(np.float32)
    outs = []
    for mods in ((transforms, subsample, factory), (jtransforms, jsubsample, jfactory)):
        tfm = _build_transform(mods, spec)
        # the unseeded randomness (SSDU, N2R, masks without use_seed) drawn
        # from equal seeded states on both sides
        for name in ("ssdu_masking", "n2r_masking"):
            if getattr(tfm, name, None) is not None:
                getattr(tfm, name).rng = np.random.RandomState(5)
        for mf in tfm.masking.mask_func or []:
            mf.rng = np.random.RandomState(6)
        outs.append([tfm(*sample) for _ in range(2)])
    _equal(outs[0], outs[1], case)


# ---- datasets, loaders and their stages ----

LOADER_CASES = {
    "plain_shuffled": dict(ds={"shuffle": True}),
    "drop_last_b4": dict(ds={"shuffle": True, "drop_last": True, "batch_size": 4}),
    "two_workers": dict(ds={"shuffle": True, "num_workers": 2}),
    "prefetcher": dict(ds={"shuffle": True, "prefetch_batches": 2}),
    "device_prefetch": dict(ds={"shuffle": True, "device_prefetch": True}),
    "device_cache": dict(ds={"shuffle": True, "device_cache_dataset": True}),
    "device_cache_drop_last_prefetched": dict(ds={"shuffle": True, "device_cache_dataset": True, "drop_last": True,
                                                  "batch_size": 4, "device_prefetch": True, "num_workers": 2}),
    "device_cache_over_budget": dict(ds={"shuffle": True, "device_cache_dataset": True, "device_cache_bytes": 1e5}),
    "cache_memory": dict(ds={"cache_dataset": "memory", "shuffle": True}),
    "cache_disk": dict(ds={"cache_dataset": "disk", "shuffle": True}, disk=True),
    "bf16_transfer": dict(ds={"shuffle": True, "transfer_dtype": "bfloat16"}),
    "bf16_transfer_device_cache": dict(ds={"shuffle": True, "transfer_dtype": "bfloat16",
                                           "device_cache_dataset": True}),
    "two_accelerations_random": dict(ds={"shuffle": True, "mask_args": {"type": "equispaced1d",
                                                                       "accelerations": [4, 8],
                                                                       "center_fractions": [0.08, 0.04]}}),
    "yaml_train_ds_poisson2d": dict(ds={}, yaml=True),
}


def _loader_cfg(dataset_dir, spec, tmp_path):
    base = _train_ds() if spec.get("yaml") else {
        "mask_args": {"type": "equispaced1d", "accelerations": [4], "center_fractions": [0.08]},
        "fft_centered": True, "fft_normalization": "ortho", "batch_size": 2}
    cfg = {**base, **spec["ds"], "data_path": str(dataset_dir), "batch_size": spec["ds"].get("batch_size", 2)}
    if spec.get("disk"):
        cfg["cache_dir"] = str(tmp_path)
    return cfg


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_are_bit_identical(dataset_dir, tmp_path, case):
    spec = LOADER_CASES[case]
    cfg = _loader_cfg(dataset_dir, spec, tmp_path)
    got_loader = factory.build_dataloader(cfg, device="cpu")
    want_loader = jfactory.build_dataloader({**cfg, "cache_dir": str(tmp_path / "jax")} if spec.get("disk") else cfg)
    assert len(got_loader) == len(want_loader)
    for epoch in range(2 if not spec.get("yaml") else 1):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        _equal(got, want, f"{case}/epoch{epoch}")
    if "device_cache_bytes" in spec["ds"]:  # over budget: the cache passes the host batches through
        assert got_loader._disabled and want_loader._disabled and not got_loader._resident
    elif "device_cache_dataset" in spec["ds"]:
        assert got_loader._populated and want_loader._populated  # the second epoch was gathered


@pytest.mark.parametrize("index", [0, 1])
def test_two_process_shards_are_bit_identical(dataset_dir, index):
    """process_count 2: each process iterates its own equal-length shard."""
    cfg = _loader_cfg(dataset_dir, {"ds": {}}, None)
    kw = dict(batch_size=2, shuffle=True, seed=3, process_index=index, process_count=2)
    got = BatchLoader(ReconstructionMRIDataset(dataset_dir, transform=factory.build_transforms(cfg)), **kw)
    want = JBatchLoader(JDataset(dataset_dir, transform=jfactory.build_transforms(cfg)), **kw)
    for _ in range(2):
        _equal(list(got), list(want), f"shard{index}")
    assert len(got) == 2  # 6 samples over 2 processes: 3 each, in batches of 2


def test_bf16_transfer_rounds_to_nearest_even_like_ml_dtypes():
    """The collated bf16 leaves: torch's float32 -> bfloat16 cast against
    ml_dtypes' on the same floats, bit for bit, ties and specials included."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 2**16, 1000, dtype=np.uint64).astype(np.uint32) << 16) | 0x8000  # exact halfway
    near = np.concatenate([ties - 1, ties + 1])
    x = np.concatenate([bits, ties, near]).view(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, np.inf, -np.inf, 3.4e38, 1e-45, -1e-40, 1.0, 1.00390625])])
    loader = BatchLoader([], transfer_dtype="bfloat16")
    got = torch.from_numpy(x).to(loader.transfer_dtype)
    want = x.astype(ml_dtypes.bfloat16)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(_np(got)[finite].view(np.uint16), want[finite].view(np.uint16))
    assert np.isnan(_np(got)[~finite & np.isnan(x)].astype(np.float32)).all()
    np.testing.assert_array_equal(_np(got)[np.isinf(x)].view(np.uint16), want[np.isinf(x)].view(np.uint16))
    with pytest.raises(ValueError, match="transfer_dtype"):
        BatchLoader([], transfer_dtype="float16")


# ---- the device dataset cache: the two fixes over the JAX package ----


class _Counting:
    def __init__(self, dataset):
        self.dataset, self.calls = dataset, 0

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        self.calls += 1
        return self.dataset[i]


def _small_cache_loader(dataset_dir, mod_loader, mod_dataset, mod_factory, **kw):
    cfg = _loader_cfg(dataset_dir, {"ds": {}}, None)
    ds = _Counting(mod_dataset(dataset_dir, transform=mod_factory.build_transforms(cfg)))
    return ds, mod_loader(ds, batch_size=2, shuffle=True, seed=0, pad_shape=(4, 32, 32), **kw)


def test_device_cache_gathers_once_every_sample_is_resident_although_epochs_end_early(dataset_dir):
    """A consumer that stops every epoch after two batches: once the
    populating epochs have made every sample resident, the next epoch is
    gathered (the JAX package's cache keeps running the host pipeline)."""
    ds, loader = _small_cache_loader(dataset_dir, BatchLoader, ReconstructionMRIDataset, factory)
    cache = DeviceDatasetCache(loader, exclude=("kspace",), device="cpu")
    jds, jloader = _small_cache_loader(dataset_dir, JBatchLoader, JDataset, jfactory)
    jcache = JDeviceDatasetCache(jloader, exclude=("kspace",))
    for epoch in range(6):
        for c in (cache, jcache):
            for i, _ in enumerate(c):
                if i == 1:
                    break
    assert cache._have.all() and jcache._have.all()
    assert cache._populated and not jcache._populated
    calls = ds.calls
    batches = [b for _, b in zip(range(2), cache)]
    assert ds.calls == calls  # gathered: no host pipeline work
    want = [b for _, b in zip(range(2), jcache)]  # same epoch counter, same order
    _equal([{k: b[k] for k in cache._resident} for b in batches],
           [{k: b[k] for k in cache._resident} for b in want], "gathered")


def test_device_cache_disabled_mid_epoch_loads_each_sample_once(dataset_dir):
    """After the cache is disabled, a gathered batch whose samples were never
    resident is served from the host pipeline alone: one load per sample
    (the JAX package loads the missing ones twice)."""
    for mod_loader, mod_dataset, mod_factory, cache_cls, kw, want_calls in (
            (BatchLoader, ReconstructionMRIDataset, factory, DeviceDatasetCache, {"device": "cpu"}, 2),
            (JBatchLoader, JDataset, jfactory, JDeviceDatasetCache, {}, 4)):
        ds, loader = _small_cache_loader(dataset_dir, mod_loader, mod_dataset, mod_factory, drop_last=True)
        loader.batch_size = 4  # 6 samples, drop_last: 2 never resident after the first pass
        cache = cache_cls(loader, exclude=("kspace",), **kw)
        list(cache)
        missing = np.flatnonzero(~cache._have)
        assert len(missing) == 2 and cache._populated
        cache._disabled = True  # a later batch tripped a guard: the residents are dropped
        cache._resident.clear()
        ds.calls = 0
        batch = cache._gathered(missing)
        assert ds.calls == want_calls, cache_cls
        assert list(batch["sample_indices"]) == list(missing)


# ---- entry points, import rules and the chip script's dataset section ----


def test_device_stages_and_the_factory_need_cuda_unless_told_cpu(monkeypatch, dataset_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _loader_cfg(dataset_dir, {"ds": {}}, None)
    loader = factory.build_dataloader(cfg, device="cpu")
    for make in (lambda: DevicePrefetcher(loader), lambda: DeviceDatasetCache(loader),
                 lambda: factory.build_dataloader(cfg), lambda: DevicePrefetcher(loader, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert DevicePrefetcher(loader, device="cpu").device.type == "cpu"


def test_port_modules_import_without_jax_ml_dtypes_h5py_or_yaml(tmp_path):
    """In a fresh interpreter where jax, ml_dtypes, h5py and PyYAML cannot be
    imported: the data layer, metrics, parallel and ops import; BatchLoader
    batches an in-memory source; an h5 dataset raises an ImportError naming
    h5py."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "h5py", "yaml"):
    sys.modules[name] = None
import numpy as np
import mridc_tpu_torch.data, mridc_tpu_torch.data.factory, mridc_tpu_torch.data.cache
import mridc_tpu_torch.metrics.reconstruction, mridc_tpu_torch.parallel.multihost
import mridc_tpu_torch.ops.complex, mridc_tpu_torch.ops.masking, mridc_tpu_torch.train.trainer
from mridc_tpu_torch.data.factory import build_transforms
from mridc_tpu_torch.data.loaders import BatchLoader, ReconstructionMRIDataset
rng = np.random.default_rng(0)
k = (rng.standard_normal((2, 16, 16)) + 1j * rng.standard_normal((2, 16, 16))).astype(np.complex64)
tfm = build_transforms({{"mask_args": {{"type": "equispaced1d", "accelerations": [4], "center_fractions": [0.08]}}}})
src = [tfm(k, k, None, np.array([]), np.abs(k).sum(0), {{}}, "v.h5", i) for i in range(3)]
batch = next(iter(BatchLoader(src, batch_size=3, transfer_dtype="bfloat16")))
assert batch["masked_kspace"].shape == (3, 2, 16, 16, 2), batch["masked_kspace"].shape
try:
    ReconstructionMRIDataset({str(tmp_path)!r})
except ImportError as exc:
    assert "h5py" in str(exc), exc
else:
    raise AssertionError("no ImportError")
assert not any(m in sys.modules and sys.modules[m] is not None for m in ("jax", "h5py", "yaml", "ml_dtypes"))
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_chip_smoke_dataset_section_is_the_yaml_train_ds():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.TRAIN_DS == _train_ds()


def test_chip_smoke_source_with_the_volumes_mask_equals_the_drawn_one():
    """chip_smoke.py hands each volume's poisson2d mask, drawn beforehand by
    the transform's own masker, to the transform as an h5 ``mask`` would:
    every output equals the transform's own draw but the acceleration, which
    then reads the mask's sampled share."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    mask, _ = chip_smoke.poisson2d_mask(chip_smoke.TRAIN_DS, 32, 32, "d1_0.h5")
    tfm = factory.build_transforms(chip_smoke.TRAIN_DS)
    drawn = chip_smoke.PhantomSource(chip_smoke.d_volumes("d1", 1, 2, 3, 32, 32, seed=1), tfm)
    given = chip_smoke.PhantomSource(chip_smoke.d_volumes("d1", 1, 2, 3, 32, 32, seed=1, masks=[mask]), tfm)
    for i in range(2):
        a, b = drawn[i], given[i]
        _equal(a[:8] + a[9:], b[:8] + b[9:], f"slice{i}")
        assert a[8] == [10] and b[8] == [float(mask.sum() / mask.size)]


# ---- multi-process sharding and reduction ----


@pytest.mark.parametrize("n,pc", [(6, 2), (7, 3), (1, 4), (10, 1)])
def test_shard_indices_are_bit_identical(n, pc):
    for pi in range(pc):
        np.testing.assert_array_equal(multihost.shard_indices(n, pi, pc), jmultihost.shard_indices(n, pi, pc))


def test_single_process_reduction_is_the_identity():
    assert multihost.process_info() == (0, 1)
    vals = {"a": 1.5, "b": -2.0}
    assert multihost.all_sum_scalars(vals) == vals
    assert multihost.reduce_mean_stats({"x": 6.0}, {"x": 3.0}) == jmultihost.reduce_mean_stats({"x": 6.0}, {"x": 3.0})


def _gloo_worker(rank, world, port, out):
    import torch.distributed as dist

    from mridc_tpu_torch.data.loaders import BatchLoader as Loader
    from mridc_tpu_torch.parallel import multihost as mh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    res = {}
    try:
        loader = Loader(list(range(5)))
        res = {"info": mh.process_info(), "loader": (loader.process_index, loader.process_count),
               "sum": mh.all_sum_scalars({"a": rank + 1.0, "b": 2.0 * rank}),
               "mean": mh.reduce_mean_stats({"m": 3.0 * (rank + 1)}, {"m": rank + 1.0})}
        try:
            mh.all_sum_scalars({"a": 1.0} if rank == 0 else {"z": 1.0})
        except ValueError as exc:
            res["mismatch"] = str(exc)
    except Exception as exc:  # reported to the test, which would otherwise wait for the queue
        res["error"] = repr(exc)
    finally:
        out.put((rank, res))
        dist.destroy_process_group()


def test_two_process_gloo_reduction_and_process_info():
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gloo_worker, args=(r, 2, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    res = dict(out.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    assert not any(p.is_alive() for p in procs) and all(p.exitcode == 0 for p in procs)
    for rank in range(2):
        r = res[rank]
        assert "error" not in r, r["error"]
        assert r["info"] == (rank, 2) and r["loader"] == (rank, 2)
        assert r["sum"] == {"a": 3.0, "b": 2.0}
        assert r["mean"] == {"m": 9.0 / 3.0}
        assert "key sets differ" in r["mismatch"]


def _fit_batch(seed):
    """One [1, 2, 8, 8] reconstruction batch drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((1, 1, 8, 8)) < 0.5).astype(np.float32)
    return {"masked_kspace": rng.standard_normal((1, 2, 8, 8, 2)).astype(np.float32) * mask[..., None],
            "sensitivity_maps": rng.standard_normal((1, 2, 8, 8, 2)).astype(np.float32), "mask": mask,
            "target": np.abs(rng.standard_normal((1, 8, 8))).astype(np.float32)}


def _fit_trainer(exp_dir=None):
    from mridc_tpu_torch.models import build_model
    from mridc_tpu_torch.train.exp_manager import ExpManager
    from mridc_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    exp = None if exp_dir is None else ExpManager(exp_dir=exp_dir, name="fit", version="run", save_top_k=1,
                                                  model_config=_FIT_MODEL, map_location="cpu")
    return Trainer(build_model(_FIT_MODEL, device="cpu"), optim_cfg={"name": "sgd", "lr": 0.1},
                   trainer_cfg={"max_steps": 2}, device="cpu", exp_manager=exp)


_FIT_MODEL = {"model_name": "UNet", "channels": 4, "pooling_layers": 1}


def _joined_fit_batches():
    """Two steps' batches of each of two processes, and the same rows joined
    (process 0's first, as the gather orders them)."""
    shards = [[_fit_batch(10 + 2 * step + rank) for step in range(2)] for rank in range(2)]
    joined = [{k: np.concatenate([shards[0][step][k], shards[1][step][k]]) for k in shards[0][step]}
              for step in range(2)]
    return shards, joined


def _gloo_fit_worker(rank, world, port, out, exp_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    res = {}
    try:
        trainer = _fit_trainer(exp_dir)
        res["history"] = trainer.fit(_joined_fit_batches()[0][rank], max_epochs=1)
        res["step"] = trainer.state.step
        res["state"] = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()}
        res["val"] = trainer.validate([_fit_batch(20 + rank)])
    except Exception as exc:  # reported to the test, which would otherwise wait for the queue
        res["error"] = repr(exc)
    finally:
        out.put((rank, res))
        dist.destroy_process_group()


def test_two_process_fit_refuses_and_validate_reduces(tmp_path):
    """Two gloo processes fit two SGD steps on their shards of each batch:
    their weights, their training loss and process 0's ``.mridc`` archive
    equal one process's fit on the joined batches (loss rtol 1e-5, weights
    rtol 1e-4 / atol 1e-6), and both processes hold the same weights.
    ``validate`` still runs on each rank's shard and returns the metrics of
    both shards together, as one process holding the fitted weights gives them
    for both batches (rel 1e-12, as before ``fit`` ran across processes).
    (The name is the one the test had while ``fit`` refused at world size 2.)"""
    import socket

    import torch.multiprocessing as mp

    from mridc_tpu_torch.train.checkpoints import load_archive

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gloo_fit_worker, args=(r, 2, port, out, str(tmp_path / "two"))) for r in range(2)]
    for p in procs:
        p.start()
    res = dict(out.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    assert not any(p.is_alive() for p in procs) and all(p.exitcode == 0 for p in procs)
    one = _fit_trainer(str(tmp_path / "one"))
    history = one.fit(_joined_fit_batches()[1], max_epochs=1)
    want_state = {k: v.numpy() for k, v in one.model.state_dict().items()}
    _, archived = load_archive(tmp_path / "two" / "fit" / "run" / "fit.mridc")
    fitted = _fit_trainer()
    fitted.model.load_state_dict({k: torch.from_numpy(v) for k, v in res[0]["state"].items()})
    want = fitted.validate([_fit_batch(20), _fit_batch(21)])
    for rank in range(2):
        r = res[rank]
        assert "error" not in r, r["error"]
        assert r["step"] == 2
        np.testing.assert_allclose(r["history"][0]["train_loss"], history[0]["train_loss"], rtol=1e-5)
        for k, v in want_state.items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(r["state"][k], res[0]["state"][k], err_msg=k)
        assert sorted(r["val"]) == sorted(want)
        for k, v in want.items():
            assert r["val"][k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    for k, v in want_state.items():
        np.testing.assert_array_equal(archived[k].numpy(), res[0]["state"][k], err_msg=k)


# ---- host metrics ----


def test_metrics_are_bit_identical():
    rng = np.random.default_rng(4)
    t = np.abs(rng.standard_normal((3, 40, 36))).astype(np.float32)
    p = (t + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
    assert sorted(metrics.METRIC_FUNCS) == sorted(jmetrics.METRIC_FUNCS)
    for name, fn in metrics.METRIC_FUNCS.items():
        assert fn(t, p) == jmetrics.METRIC_FUNCS[name](t, p), name
    assert metrics.psnr(t, t) == float("inf") and metrics.ssim(t[:, :2, :2], p[:, :2, :2]) == jmetrics.ssim(
        t[:, :2, :2], p[:, :2, :2])
    got, want = metrics.ReconstructionMetrics(), jmetrics.ReconstructionMetrics()
    for i in range(3):
        got.push(t[i : i + 1], p[i : i + 1])
        want.push(t[i : i + 1], p[i : i + 1])
    assert got.means() == want.means() and got.stddevs() == want.stddevs() and repr(got) == repr(want)
