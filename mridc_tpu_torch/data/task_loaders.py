"""Task-specific HDF5 datasets (counterpart of ``mridc_tpu/data/task_loaders.py``):
the segmentation one, :class:`SegmentationMRIDataset` (``kspace`` or
``ksp``, ``sensitivity_map``, ``mask``, or the ``reconstruction``/``target``
image without complex data, and the ``segmentation`` labels from the file or
from ``segmentations_root``), and the quantitative one, :class:`qMRIDataset`
(AHEAD format: multi-echo ``kspace`` [S, E, C, H, W], ``sensitivity_map``,
``mask``, ``mask_brain`` / ``mask_head``, ``{B0,S0,R2star,phi}_map_target``
and ``_map_init_*``), and the joint reconstruction-segmentation one,
:class:`RSMRIDataset` (``kspace`` or ``ksp``, ``sensitivity_map``, ``mask``,
the first of ``reconstruction_rss``, ``reconstruction_sense``,
``reconstruction`` and ``target`` as the target, and the ``segmentation``
labels from the file or from ``segmentations_root``). h5py is imported where
a file is first opened.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mridc_tpu_torch.data.loaders import MRIDataset, _h5py, is_none

__all__ = ["SegmentationMRIDataset", "RSMRIDataset", "qMRIDataset"]


def _load_segmentation(dataset, hf, fname, dataslice):
    """The ``segmentation`` labels of a slice (window): from the file of the
    same name under ``dataset.segmentations_root``, else from the volume
    ``hf``, else empty."""
    root = dataset.segmentations_root
    if root is not None and not is_none(root):
        with _h5py().File(Path(root) / Path(fname).name, "r") as sf:
            return np.asarray(dataset.get_consecutive_slices(sf, "segmentation", dataslice))
    if "segmentation" in hf:
        return np.asarray(dataset.get_consecutive_slices(hf, "segmentation", dataslice))
    return np.array([])


class SegmentationMRIDataset(MRIDataset):
    """Returns (kspace, sensitivity_map, mask, imspace, segmentation, attrs,
    fname, slice_idx), or the transform's output of them."""

    def __init__(self, *args, segmentations_root=None, complex_data: bool = True, **kwargs):
        self.segmentations_root = segmentations_root
        self.complex_data = complex_data
        super().__init__(*args, **kwargs)

    def __getitem__(self, i: int):
        fname, dataslice, metadata = self.examples[i]
        with _h5py().File(fname, "r") as hf:
            if self.complex_data:
                key = "kspace" if "kspace" in hf else "ksp"
                kspace = self.get_consecutive_slices(hf, key, dataslice).astype(np.complex64, copy=False)
                sensitivity_map = (
                    self.get_consecutive_slices(hf, "sensitivity_map", dataslice).astype(np.complex64, copy=False)
                    if "sensitivity_map" in hf
                    else np.array([])
                )
                mask = np.asarray(self.get_consecutive_slices(hf, "mask", dataslice)) if "mask" in hf else None
                imspace = np.array([])
            else:
                key = "reconstruction" if "reconstruction" in hf else "target"
                imspace = self.get_consecutive_slices(hf, key, dataslice)
                kspace = np.array([])
                sensitivity_map = np.array([])
                mask = None
            segmentation = _load_segmentation(self, hf, fname, dataslice)
            attrs = dict(hf.attrs)
            attrs.update(metadata)
        sample = (kspace, sensitivity_map, mask, imspace, segmentation, attrs, str(Path(fname).name), dataslice)
        if self.transform is not None:
            return self.transform(*sample)
        return sample


class RSMRIDataset(MRIDataset):
    """Returns (kspace, sensitivity_map, mask, target, segmentation, attrs,
    fname, slice_idx), or the transform's output of them."""

    def __init__(self, *args, segmentations_root=None, **kwargs):
        self.segmentations_root = segmentations_root
        super().__init__(*args, **kwargs)

    def __getitem__(self, i: int):
        fname, dataslice, metadata = self.examples[i]
        get = self.get_consecutive_slices
        with _h5py().File(fname, "r") as hf:
            kspace = get(hf, "kspace" if "kspace" in hf else "ksp", dataslice).astype(np.complex64, copy=False)
            sensitivity_map = (get(hf, "sensitivity_map", dataslice).astype(np.complex64, copy=False)
                               if "sensitivity_map" in hf else np.array([]))
            mask = np.asarray(get(hf, "mask", dataslice)) if "mask" in hf else None
            target = np.array([])
            for k in ("reconstruction_rss", "reconstruction_sense", "reconstruction", "target"):
                if k in hf:
                    target = get(hf, k, dataslice)
                    break
            segmentation = _load_segmentation(self, hf, fname, dataslice)
            attrs = dict(hf.attrs)
            attrs.update(metadata)
        sample = (kspace, sensitivity_map, mask, target, segmentation, attrs, str(Path(fname).name), dataslice)
        if self.transform is not None:
            return self.transform(*sample)
        return sample


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
