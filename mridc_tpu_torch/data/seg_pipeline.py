"""Task host pipelines (counterpart of ``mridc_tpu/data/seg_pipeline.py``):
the segmentation transform and batcher, :class:`SegmentationDataTransforms`
and :class:`SegBatchLoader`, the joint reconstruction-segmentation ones,
:class:`RSMRIDataTransforms` (the reconstruction transform's 10-tuple plus
one-hot labels) and :class:`RSBatchLoader` (the reconstruction batch plus
the labels, padded to the target's H and W; missing labels raise), and the
quantitative batcher, :class:`QBatchLoader`, the same numpy code but for two
repairs.

The repairs: :class:`QBatchLoader` folds consecutive slices into one sample a
slice; labels of consecutive slices stored one-hot as [S, classes, H, W]
become [S, H, W, classes] (the JAX package's ``_to_onehot`` reads such a
stack as integer labels), and :class:`SegBatchLoader` pads a sample's H and W
(the JAX package's pads its first two axes, the slices and H of a
consecutive-slice image).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mridc_tpu_torch.data.loaders import BatchLoader, _pad_to
from mridc_tpu_torch.data.transforms import MRIDataTransforms, _np_ifft2

__all__ = ["SegmentationDataTransforms", "RSMRIDataTransforms", "SegBatchLoader", "RSBatchLoader", "QBatchLoader"]

_MISSING_LABELS = ("segmentation labels missing for at least one sample — provide segmentations_path or files "
                   "with a 'segmentation' dataset")


def _is_onehot(seg: np.ndarray) -> bool:
    return bool(seg.min() >= 0 and seg.max() <= 1 and (np.mod(seg, 1) == 0).all())


def _to_onehot(seg: np.ndarray, num_classes: Optional[int]) -> np.ndarray:
    """Labels -> float32 one-hot with the class axis last: a one-hot stack
    [classes, H, W] or, for consecutive slices, [S, classes, H, W] is moved;
    integer labels are expanded; empty labels pass through (the batcher
    refuses them)."""
    seg = np.asarray(seg)
    if seg.size == 0:
        return seg.astype(np.float32)
    if seg.ndim == 4 and _is_onehot(seg) and (num_classes is None or seg.shape[1] == num_classes):
        return np.moveaxis(seg, 1, -1).astype(np.float32)
    if seg.ndim >= 3 and _is_onehot(seg) and (num_classes is None or seg.shape[0] == num_classes):
        return np.moveaxis(seg, 0, -1).astype(np.float32)
    n = num_classes or int(seg.max()) + 1
    return np.eye(n, dtype=np.float32)[seg.astype(np.int64)]


class SegmentationDataTransforms:
    """(kspace | image, segmentation) -> {image [(S,) H, W, C_in],
    segmentation [(S,) H, W, classes]}: the k-space's inverse FFT combined
    over the coils (SENSE with the maps, else RSS), its magnitude (1 channel)
    or real view (2), normalised by its maximum."""

    def __init__(self, complex_data: bool = True, magnitude_input: bool = True, input_channels: int = 1,
                 output_classes: Optional[int] = None, normalize_inputs: bool = True, fft_centered: bool = False,
                 fft_normalization: str = "backward", coil_combination_method: str = "RSS"):
        self.complex_data = complex_data
        self.magnitude_input = magnitude_input
        self.input_channels = input_channels
        self.output_classes = output_classes
        self.normalize_inputs = normalize_inputs
        self.fft_centered = fft_centered
        self.fft_normalization = fft_normalization
        self.coil_combination_method = coil_combination_method.upper()

    def __call__(self, kspace, sensitivity_map, mask, imspace, segmentation, attrs, fname, slice_idx):
        if self.complex_data and np.size(kspace):
            img = _np_ifft2(np.asarray(kspace), self.fft_centered, self.fft_normalization)
            coil_ax = 1 if img.ndim == 4 else 0  # [S, C, H, W] for consecutive slices
            if self.coil_combination_method == "SENSE" and np.size(sensitivity_map):
                image = (img * np.conj(sensitivity_map)).sum(coil_ax)
            else:
                image = np.sqrt((np.abs(img) ** 2).sum(coil_ax))
        else:
            image = np.asarray(imspace)
        if self.magnitude_input or self.input_channels == 1:
            x = np.abs(image).astype(np.float32)[..., None]
        else:
            x = np.stack([image.real, image.imag], -1).astype(np.float32)
        if self.normalize_inputs:
            x = x / max(np.abs(x).max(), 1e-12)
        seg = _to_onehot(segmentation, self.output_classes)
        return {"image": x, "segmentation": seg, "fname": fname, "slice_idx": slice_idx, "attrs": attrs}


class RSMRIDataTransforms(MRIDataTransforms):
    """The reconstruction transform's 10-tuple plus the one-hot labels
    [(S,) H, W, classes]."""

    def __init__(self, output_classes: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.output_classes = output_classes

    def __call__(self, kspace, sensitivity_map, mask, target, segmentation, attrs, fname, slice_idx):
        out = super().__call__(kspace, sensitivity_map, mask, None, target, attrs, fname, slice_idx)
        return out + (_to_onehot(segmentation, self.output_classes),)


class SegBatchLoader:
    """Batches :class:`SegmentationDataTransforms` samples: ``image`` and
    ``segmentation`` stacked (each sample's H and W zero-padded to the
    batch's largest), ``fname`` and ``slice_idx``; shuffled by a seeded
    numpy generator, samples built on ``num_workers`` threads in order."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.num_workers = int(num_workers)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.num_workers > 0:
            from mridc_tpu_torch.data.prefetch import OrderedWorkerMap

            samples = OrderedWorkerMap(lambda i: self.dataset[int(i)], order, self.num_workers)
        else:
            samples = (self.dataset[int(idx)] for idx in order)
        batch = []
        for sample in samples:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._collate(batch)

    @staticmethod
    def _collate(samples):
        if any(np.asarray(s["segmentation"]).size == 0 for s in samples):
            raise ValueError(_MISSING_LABELS)
        h = max(np.asarray(s["image"]).shape[-3] for s in samples)
        w = max(np.asarray(s["image"]).shape[-2] for s in samples)
        return {
            "image": np.stack([_pad_to(np.asarray(s["image"]), (h, w, 0)) for s in samples], 0),
            "segmentation": np.stack([_pad_to(np.asarray(s["segmentation"]), (h, w, 0)) for s in samples], 0),
            "fname": [s["fname"] for s in samples],
            "slice_idx": np.asarray([s["slice_idx"] for s in samples], np.int32),
        }


class RSBatchLoader(BatchLoader):
    """The reconstruction :class:`~mridc_tpu_torch.data.loaders.BatchLoader`
    over :class:`RSMRIDataTransforms` samples, with ``segmentation`` [B, (S,)
    H, W, classes] stacked, each padded to the batch target's H and W."""

    def _collate(self, samples, indices=None):
        segs = [np.asarray(s[-1]) for s in samples]
        if any(g.size == 0 for g in segs):
            raise ValueError(_MISSING_LABELS)
        base = super()._collate([s[:-1] for s in samples], indices)
        h, w = base["target"].shape[-3:-1]
        base["segmentation"] = np.stack([_pad_to(g, (h, w, 0)) for g in segs], 0)
        return base


class QBatchLoader:
    """Batches qMRIDataset samples into QuantitativeTrainer-format dicts:
    masks each echo's k-space, fits initial maps, stacks real views."""

    def __init__(self, dataset, tes, mask_func=None, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 fft_centered: bool = True, fft_normalization: str = "ortho", num_workers: int = 0,
                 compute_target: bool = False):
        from mridc_tpu_torch.data.qtransforms import fit_quantitative_maps

        self.num_workers = int(num_workers)
        # per-echo fully-sampled recon target: only consumed by models with a
        # folded reconstruction module (lossrecon) — a full [E, C] IFFT + coil
        # combine per sample otherwise wasted on the host hot path
        self.compute_target = bool(compute_target)

        self.dataset = dataset
        self.tes = np.asarray(tes, np.float32)
        self.mask_func = mask_func
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.fft_centered = fft_centered
        self.fft_normalization = fft_normalization
        self._fit = fit_quantitative_maps

    def __len__(self):
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _prep(self, sample):
        kspace, sens, qmaps, mask, mask_brain, mask_head, target, attrs, fname, sidx = sample
        if kspace.ndim == 5:  # consecutive slices [S, E, C, H, W]: fold S out
            out = []
            for i in range(kspace.shape[0]):
                sub_qmaps = {k: (v[i] if np.ndim(v) >= 3 else v) for k, v in qmaps.items()}
                # one sample per slice (the JAX package's ``extend`` adds the
                # sample dict's keys instead, and its collation then fails)
                out.append(
                    self._prep(
                        (
                            kspace[i],
                            sens[i] if np.ndim(sens) == 4 else sens,
                            sub_qmaps,
                            mask[i] if np.ndim(mask) >= 3 else mask,
                            mask_brain[i] if np.ndim(mask_brain) >= 3 else mask_brain,
                            mask_head[i] if np.ndim(mask_head) >= 3 else mask_head,
                            target,
                            attrs,
                            fname,
                            sidx + i,
                        )
                    )
                )
            return out
        e, c, h, w = kspace.shape
        if self.mask_func is not None:
            m, _ = self.mask_func(np.array([1, h, w, 2]), tuple(map(ord, fname)))
            m = np.asarray(m, np.float32)
            if m.ndim >= 3 and m.shape[-1] == 1:
                m = m[..., 0]
            while m.ndim < 3:
                m = m[None]
            m2d = np.broadcast_to(m, (1, h, w)).astype(np.float32)
        elif np.size(mask) > 1:
            # the AHEAD files ship a precomputed undersampling mask — use it
            # (previously ignored: training silently ran fully sampled)
            m = np.asarray(mask, np.float32)
            while m.ndim < 3:
                m = m[None]
            m2d = np.broadcast_to(m[:1], (1, h, w)).astype(np.float32)
        else:
            m2d = np.ones((1, h, w), np.float32)
        masked = kspace * m2d[None, None, 0]
        imgs = _np_ifft2(masked, self.fft_centered, self.fft_normalization)
        if np.size(sens) > 1:
            combined = (imgs * np.conj(sens)[None]).sum(1)
        else:
            # no sensitivity maps in the file: RSS-combine and synthesize
            # uniform maps for the trainer's rv inputs
            combined = np.sqrt((np.abs(imgs) ** 2).sum(1)).astype(np.complex64, copy=False)
            sens = (np.ones((c, h, w)) / np.sqrt(c)).astype(np.complex64, copy=False)
        fitted = self._fit(combined, self.tes)
        maps_init = np.stack(
            [fitted["R2star_map"], fitted["S0_map"], fitted["B0_map"], fitted["phi_map"]], -1
        )
        def tgt(name, fallback):
            v = np.asarray(qmaps.get(name, np.empty([])))
            return v if v.size > 1 else fallback

        maps_target = np.stack(
            [
                tgt("R2star_map_target", fitted["R2star_map"]),
                tgt("S0_map_target", fitted["S0_map"]),
                tgt("B0_map_target", fitted["B0_map"]),
                tgt("phi_map_target", fitted["phi_map"]),
            ],
            -1,
        ).astype(np.float32)
        rv = lambda x: np.stack([x.real, x.imag], -1).astype(np.float32)  # noqa: E731
        brain = np.asarray(mask_brain, np.float32) if np.size(mask_brain) > 1 else np.ones((h, w), np.float32)
        out = {
            "kspace": rv(masked),
            "sensitivity_maps": rv(sens),
            "mask": m2d,
            "maps_init": maps_init.astype(np.float32),
            "maps_target": maps_target,
            "mask_brain": brain,
            "TEs": self.tes,
            "fname": fname,
            "slice_idx": sidx,
        }
        if self.compute_target:
            # per-echo fully-sampled coil-combined target images [E, H, W] —
            # the recon target for models with a folded reconstruction module
            # (reference quantitative training_step 'target', models/base.py:436)
            imgs_full = _np_ifft2(kspace, self.fft_centered, self.fft_normalization)
            out["target"] = rv((imgs_full * np.conj(sens)[None]).sum(1))
        return out

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.num_workers > 0:
            from mridc_tpu_torch.data.prefetch import OrderedWorkerMap

            prepped_iter = OrderedWorkerMap(lambda i: self._prep(self.dataset[int(i)]), order, self.num_workers)
        else:
            prepped_iter = (self._prep(self.dataset[int(idx)]) for idx in order)
        batch = []
        for prepped in prepped_iter:
            for item in prepped if isinstance(prepped, list) else [prepped]:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self._collate(batch)
                    batch = []
        if batch:
            yield self._collate(batch)

    @staticmethod
    def _collate(samples):
        keys = ["kspace", "sensitivity_maps", "mask", "maps_init", "maps_target", "mask_brain"]
        if "target" in samples[0]:
            keys.append("target")
        out = {k: np.stack([s[k] for s in samples], 0) for k in keys}
        out["TEs"] = samples[0]["TEs"]
        out["fname"] = [s["fname"] for s in samples]
        out["slice_idx"] = np.asarray([s["slice_idx"] for s in samples], np.int32)
        return out
