"""Task-specific HDF5 datasets (counterpart of ``mridc_tpu/data/task_loaders.py``):
the quantitative one, :class:`qMRIDataset` (AHEAD format: multi-echo
``kspace`` [S, E, C, H, W], ``sensitivity_map``, ``mask``, ``mask_brain`` /
``mask_head``, ``{B0,S0,R2star,phi}_map_target`` and ``_map_init_*``). The
segmentation and joint reconstruction-segmentation datasets come with M11
and M12. h5py is imported where a file is first opened.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mridc_tpu_torch.data.loaders import MRIDataset, _h5py

__all__ = ["qMRIDataset"]


class qMRIDataset(MRIDataset):
    """Returns (kspace, sensitivity_map, qmaps, mask, mask_brain, mask_head,
    target, attrs, fname, slice_idx), or the transform's output of them."""

    def __init__(self, *args, sequence: str = "MEGRE", **kwargs):
        self.sequence = sequence
        super().__init__(*args, **kwargs)

    @staticmethod
    def _first_matching(hf, prefix, dataslice, get):
        for k in sorted(hf.keys()):
            if k.startswith(prefix):
                return np.asarray(get(hf, k, dataslice))
        return np.empty([])

    def __getitem__(self, i: int):
        fname, dataslice, metadata = self.examples[i]
        with _h5py().File(fname, "r") as hf:
            kspace = self.get_consecutive_slices(hf, "kspace", dataslice).astype(np.complex64, copy=False)
            sensitivity_map = (
                self.get_consecutive_slices(hf, "sensitivity_map", dataslice).astype(np.complex64, copy=False)
                if "sensitivity_map" in hf
                else np.array([])
            )
            mask = np.asarray(self.get_consecutive_slices(hf, "mask", dataslice)) if "mask" in hf else None
            mask_brain = (
                np.asarray(self.get_consecutive_slices(hf, "mask_brain", dataslice))
                if "mask_brain" in hf
                else np.empty([])
            )
            mask_head = (
                np.asarray(self.get_consecutive_slices(hf, "mask_head", dataslice))
                if "mask_head" in hf
                else np.empty([])
            )
            get = self.get_consecutive_slices
            qmaps = {}
            for name in ("B0", "S0", "R2star", "phi"):
                tgt_key = f"{name}_map_target"
                qmaps[f"{name}_map_target"] = get(hf, tgt_key, dataslice) if tgt_key in hf else np.empty([])
                qmaps[f"{name}_map_init"] = self._first_matching(hf, f"{name}_map_init_", dataslice, get)
            target = None
            for k in ("reconstruction_rss", "reconstruction_sense", "reconstruction", "target"):
                if k in hf:
                    target = self.get_consecutive_slices(hf, k, dataslice)
                    break
            attrs = dict(hf.attrs)
            attrs.update(metadata)

        sample = (kspace, sensitivity_map, qmaps, mask, mask_brain, mask_head, target, attrs, str(Path(fname).name),
                  dataslice)
        if self.transform is not None:
            return self.transform(*sample)
        return sample
