"""Task host pipelines (counterpart of ``mridc_tpu/data/seg_pipeline.py``):
the quantitative batcher, :class:`QBatchLoader`, the same numpy code but for
the fold of consecutive slices, which here yields one sample a slice. The
segmentation and joint reconstruction-segmentation transforms and batchers
come with M11 and M12.
"""

from __future__ import annotations

import numpy as np

from mridc_tpu_torch.data.transforms import _np_ifft2

__all__ = ["QBatchLoader"]


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
