"""ShapeNet in the Occupancy-Networks layout (counterpart of
``gecco_tpu/data/shapenet_vol.py``, which it copies: numpy items, the same
bits for the same files and seed).

Each object directory holds ``pointcloud.npz`` (the normalised cloud with
its loc and scale), ``img_choy2016/cameras.npz`` (24 posed views:
``world_mat_i`` extrinsics and ``camera_mat_i`` intrinsics) and the
``img_choy2016/NNN.jpg`` renders, and may hold
``per_view_point_masks.npz``, per-view visibility fixes. Three modes:
unposed (one world-space cloud an object), posed (one item a view, the
cloud moved into that camera's frame) and image-conditional (posed, with
the view's render and intrinsics scaled by ``IM_SIZE + 1`` so that pixel
coordinates land in [0, 1]). Each item's subsample is drawn from
``np.random.default_rng((seed, view))``.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache, partial
from typing import Callable, List, NamedTuple, Optional, Union

import numpy as np

from gecco_tpu_torch.data.image_io import load_rgb_uint8
from gecco_tpu_torch.data.loader import ConcatDataset
from gecco_tpu_torch.types import Context3d, DataError, Example

__all__ = ["IM_SIZE", "ShapeNetVol", "ShapeNetVolClass", "ShapeNetVolModel", "TestData"]

IM_SIZE = 137  # 137 x 137 pixel renders


@lru_cache(maxsize=128)
def _load_raw_cloud(path: str) -> tuple:
    """(points, scale, loc) of a model's pointcloud.npz. Bounded: a posed
    model is read once a view (24 times an epoch); 128 clouds ~= 45 MB."""
    pc = np.load(path)
    return tuple(np.asarray(pc[k], np.float32) for k in ("points", "scale", "loc"))


_MAT_KEY = re.compile(r"(world|camera)_mat_(\d+)$")
_MASK_KEY = re.compile(r"mask_(\d+)$")


class TestData(NamedTuple):
    """The raw geometry an ``is_testing`` item carries, so that an
    evaluation can undo the loc/scale normalisation and the world
    transform."""

    points_raw: np.ndarray  # the whole normalised cloud
    scale: np.ndarray
    loc: np.ndarray
    wmat: np.ndarray  # [3, 4] world -> camera extrinsics of this view
    category: str
    object_id: str


class ShapeNetVolModel:
    """One object directory: one world-space cloud (unposed), or one item a
    camera view with the cloud in that camera's frame (``posed``), with the
    view's render and intrinsics (``image_conditional``)."""

    def __init__(self, root: str, posed: bool = False, image_conditional: bool = False,
                 n_points: int = 2048, skip_fixed: bool = False, is_testing: bool = False,
                 seed: int = 0):
        if image_conditional and not posed:
            raise ValueError("image conditioning needs per-view poses: pass posed=True")
        self.root, self.posed, self.seed = root, posed, seed
        self.image_conditional, self.n_points = image_conditional, n_points
        self.skip_fixed, self.is_testing = skip_fixed, is_testing
        self._camera_cache: Optional[tuple] = None
        self._mask_views: Optional[frozenset] = None

    @property
    def _mask_path(self) -> str:
        return os.path.join(self.root, "per_view_point_masks.npz")

    @property
    def is_fixed(self) -> bool:
        """Whether this object ships per-view visibility fix masks."""
        return os.path.exists(self._mask_path)

    def _cameras(self) -> tuple:
        """(world_mats [V, 3, 4], camera_mats [V, 3, 3]) of every view, the
        intrinsics scaled so that pixel coordinates land in [0, 1]."""
        if self._camera_cache is None:
            archive = np.load(os.path.join(self.root, "img_choy2016", "cameras.npz"))
            ids: dict = {"world": set(), "camera": set()}
            for key in archive.keys():
                if (m := _MAT_KEY.match(key)) is not None:
                    ids[m.group(1)].add(int(m.group(2)))
            views = sorted(ids["world"])
            if ids["world"] != ids["camera"] or views != list(range(len(views))):
                raise DataError(f"{self.root}: cameras.npz does not hold a dense, paired set of "
                                f"world/camera matrices")
            wmats = np.stack([archive[f"world_mat_{v}"] for v in views])
            kmats = np.stack([archive[f"camera_mat_{v}"] for v in views])
            kmats = kmats / np.array([IM_SIZE + 1, IM_SIZE + 1, 1.0]).reshape(3, 1)
            self._camera_cache = (wmats.astype(np.float32), kmats.astype(np.float32))
        return self._camera_cache

    def _view_mask(self, view: Optional[int]) -> Optional[np.ndarray]:
        """The visibility fix mask of one view, or None."""
        if view is None or not self.is_fixed:
            return None
        archive = np.load(self._mask_path)
        if self._mask_views is None:
            self._mask_views = frozenset(int(m.group(1)) for key in archive.keys()
                                         if (m := _MASK_KEY.match(key)) is not None)
        return archive[f"mask_{view}"] if view in self._mask_views else None

    def _raw_cloud(self) -> tuple:
        return _load_raw_cloud(os.path.join(self.root, "pointcloud.npz"))

    def _world_points(self, view: Optional[int]) -> np.ndarray:
        """The subsampled world-space cloud (the view's mask applied,
        denormalised)."""
        points, scale, loc = self._raw_cloud()
        mask = self._view_mask(view)
        if mask is not None:
            points = points[mask]
        if self.n_points is not None:
            rng = np.random.default_rng(None if self.seed is None else (self.seed, view or 0))
            keep = rng.choice(points.shape[0], self.n_points, replace=False)
            points = points[keep]
        return points * scale + loc[None, :]

    def __len__(self) -> int:
        if self.skip_fixed and self.is_fixed:
            return 0
        if self.is_testing or not self.posed:
            return 1
        return self._cameras()[0].shape[0] if self._camera_cache else 24

    def __getitem__(self, index: int) -> Example:
        if not self.posed:
            return Example(points=self._world_points(view=None))

        wmat, kmat = (m[index] for m in self._cameras())
        # world -> camera frame: R p + t with wmat = [R | t]
        points = self._world_points(view=index) @ wmat[:, :3].T + wmat[:, 3]

        extras: tuple = ()
        if self.is_testing:
            *_, category, object_id = self.root.rstrip("/").split("/")
            raw, scale, loc = self._raw_cloud()
            extras = TestData(raw, scale, loc, wmat, category, object_id)

        if not self.image_conditional:
            ctx = Context3d(image=(), K=kmat.copy())
        else:
            image = load_rgb_uint8(os.path.join(self.root, "img_choy2016", f"{index:03d}.jpg"))
            ctx = Context3d(image=image, K=kmat.copy(), wmat=wmat.copy())
        return Example(points=points, ctx=ctx, extras=extras)


class ShapeNetVolClass(ConcatDataset):
    """Every object of one synset named in ``<split>.lst``."""

    def __init__(self, root: str, split: str, **kw):
        with open(os.path.join(root, f"{split}.lst")) as fh:
            object_ids = [ln.strip() for ln in fh if ln.strip()]
        build = partial(ShapeNetVolModel, **kw)
        super().__init__([build(os.path.join(root, oid)) for oid in object_ids])
        self.root, self.split = root, split


class ShapeNetVol(ConcatDataset):
    """Every synset under ``root`` for a named split, or an explicit list of
    object paths; ``transform`` maps each item."""

    def __init__(self, root: str, split: Union[str, List[str]],
                 transform: Callable[[Example], Example] = lambda e: e, **kw):
        if isinstance(split, str):
            synsets = sorted(entry.path for entry in os.scandir(root) if entry.is_dir())
            super().__init__([ShapeNetVolClass(s, split, **kw) for s in synsets])
        else:
            if not all(isinstance(p, str) for p in split):
                raise TypeError("explicit split must be a list of object paths")
            super().__init__([ShapeNetVolModel(p, **kw) for p in split])
        self.transform = transform

    def __getitem__(self, index: int) -> Example:
        return self.transform(super().__getitem__(index))
