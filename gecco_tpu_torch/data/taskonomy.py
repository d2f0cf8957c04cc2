"""Taskonomy scenes (counterpart of ``gecco_tpu/data/taskonomy.py``, which
it copies: numpy items, the same bits for the same files and global numpy
seed).

On disk: ``<root>/point_clouds/<building>.h5`` with the datasets ``point``
and ``view`` (frame ids), ``pc`` (clouds) and ``k`` (intrinsics);
``<root>/rgb/<building>/<building>_<point>_<view>.jpg`` renders; and
``taskonomy_split.csv``, the train/val/test table. A frame whose render is
not on disk is skipped. Each reading thread keeps its own h5 handle;
``h5py`` is imported only where a building is opened. An item's subsample
is drawn from numpy's global generator (``np.random.permutation``), as the
JAX package draws it, so one ``np.random.seed`` gives both the same points.
"""

from __future__ import annotations

import csv
import os
import threading

import numpy as np

from gecco_tpu_torch.data.image_io import load_rgb_uint8
from gecco_tpu_torch.data.loader import ConcatDataset
from gecco_tpu_torch.types import Context3d, Example

__all__ = ["Building", "Taskonomy", "parse_split_file"]


class Building:
    """Every frame of one building whose render is on disk."""

    def __init__(self, name: str, h5_path: str, rgb_path: str, n_points: int = 2048):
        import h5py

        self.name = name
        self.h5_path = os.path.join(h5_path, f"{name}.h5")
        self.rgb_path = os.path.join(rgb_path, name)
        self.n_points = n_points
        self.return_image_path = False
        self._local = threading.local()  # a thread's h5 handle

        with h5py.File(self.h5_path, "r") as fh:
            frame_ids = np.stack([fh["point"][()], fh["view"][()]], axis=1)
        on_disk = frozenset(os.listdir(self.rgb_path))
        frames = [(row, f"{name}_{pid}_{vid}.jpg")
                  for row, (pid, vid) in enumerate(frame_ids.tolist())]
        self._frames = [fr for fr in frames if fr[1] in on_disk]

    def return_image_path_(self, value: bool) -> None:
        self.return_image_path = value

    def _h5(self):
        import h5py

        handle = getattr(self._local, "h5", None)
        if handle is None:
            handle = h5py.File(self.h5_path, "r")
            self._local.h5 = handle
        return handle

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, index: int) -> Example:
        row, fname = self._frames[index]
        fh = self._h5()
        cloud = np.asarray(fh["pc"][row], np.float32)
        intrinsics = np.asarray(fh["k"][row], np.float32)
        image_path = os.path.join(self.rgb_path, fname)
        image = load_rgb_uint8(image_path)
        keep = np.random.permutation(cloud.shape[0])[: self.n_points]
        return Example(points=cloud[keep], ctx=Context3d(image=image, K=intrinsics),
                       extras=(image_path,) if self.return_image_path else ())


def parse_split_file(split_file) -> dict:
    """A csv of (name, is_train, is_val, is_test) rows after a header ->
    {name: split}."""
    table = {}
    for row in list(csv.reader(split_file))[1:]:
        if not row:
            continue
        name, *flags = row
        for flag, split in zip(flags, ("train", "val", "test")):
            if int(flag):
                table[name] = split
    return table


class Taskonomy(ConcatDataset):
    """Every building of one split (``"all"``: every building with an h5
    file), concatenated."""

    def __init__(self, path: str, split: str = "all", n_points: int = 2048):
        self.h5_path = os.path.join(path, "point_clouds")
        self.rgb_path = os.path.join(path, "rgb")
        self.split = split
        with open(os.path.join(path, "taskonomy_split.csv")) as fh:
            table = parse_split_file(fh)
        names = [f[: -len(".h5")] for f in sorted(os.listdir(self.h5_path)) if f.endswith(".h5")]
        if split != "all":
            names = [n for n in names if table.get(n) == split]
        super().__init__([Building(n, self.h5_path, self.rgb_path, n_points=n_points)
                          for n in names])

    def __repr__(self):
        return (f"Taskonomy(split={self.split}, n_buildings={len(self.datasets)}, "
                f"len={len(self)})")

    def return_image_path_(self, value: bool) -> None:
        for dataset in self.datasets:
            dataset.return_image_path_(value)
