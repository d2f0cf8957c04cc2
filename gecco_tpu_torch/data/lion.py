"""ShapeNet 15k-points (PointFlow layout) with LION normalization modes
(counterpart of ``gecco_tpu/data/lion.py``, copied: numpy items).

Parity with gecco-jax/src/gecco_jax/data/lion.py:82-388 — the essential data
path without the torch/loguru scaffolding: per-category npy stacks,
deterministic shuffle (seed 38383), five normalization modes, train-subset
(first 10k points) sampling, Example-yielding wrapper.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence

import numpy as np

from gecco_tpu_torch.data.shapenet_pointflow import category_to_synset
from gecco_tpu_torch.types import Example

__all__ = ["ShapeNet15kPointClouds", "LIONDataWrapper"]


class ShapeNet15kPointClouds:
    def __init__(
        self,
        root_dir: str,
        categories: Sequence[str] = ("airplane",),
        tr_sample_size: int = 10000,
        te_sample_size: int = 10000,
        split: str = "train",
        normalize_per_shape: bool = False,
        normalize_shape_box: bool = False,
        random_subsample: bool = False,
        sample_with_replacement: bool = True,
        normalize_std_per_axis: bool = False,
        normalize_global: bool = False,
        recenter_per_shape: bool = False,
        all_points_mean: Optional[np.ndarray] = None,
        all_points_std: Optional[np.ndarray] = None,
        input_dim: int = 3,
    ):
        assert split in ("train", "test", "val")
        if isinstance(categories, str):
            categories = [categories]
        self.split = split
        self.random_subsample = random_subsample
        self.sample_with_replacement = sample_with_replacement
        self.input_dim = input_dim
        self.normalize_per_shape = normalize_per_shape
        self.normalize_shape_box = normalize_shape_box
        self.recenter_per_shape = recenter_per_shape

        if "all" in categories:
            synsets = sorted(
                d for d in os.listdir(root_dir)
                if os.path.isdir(os.path.join(root_dir, d))
            )
        else:
            synsets = [
                c if os.path.isdir(os.path.join(root_dir, c)) else category_to_synset(c)
                for c in categories
            ]

        all_points: List[np.ndarray] = []
        self.cate_idx_lst: List[int] = []
        self.all_cate_mids: List[tuple] = []
        for cate_idx, subd in enumerate(synsets):
            sub_path = os.path.join(root_dir, subd, split)
            if not os.path.isdir(sub_path):
                raise ValueError(f"Directory missing: {sub_path}")
            mids = sorted(
                os.path.join(split, x[: -len(".npy")])
                for x in os.listdir(sub_path)
                if x.endswith(".npy")
            )
            for mid in mids:
                cloud = np.load(os.path.join(root_dir, subd, mid + ".npy"))
                all_points.append(cloud[np.newaxis, ...])
                self.cate_idx_lst.append(cate_idx)
                self.all_cate_mids.append((subd, mid))

        # deterministic shuffle (lion.py:186-190)
        shuffle_idx = list(range(len(all_points)))
        random.Random(38383).shuffle(shuffle_idx)
        self.cate_idx_lst = [self.cate_idx_lst[i] for i in shuffle_idx]
        self.all_cate_mids = [self.all_cate_mids[i] for i in shuffle_idx]
        self.all_points = np.concatenate([all_points[i] for i in shuffle_idx])

        b, n = self.all_points.shape[:2]
        pts = self.all_points
        if normalize_shape_box or recenter_per_shape:
            # bounding-box center + half max extent (lion.py:196-212, 236-252)
            hi = pts.max(axis=1).reshape(b, 1, input_dim)
            lo = pts.min(axis=1).reshape(b, 1, input_dim)
            self.all_points_mean = (hi + lo) / 2
            self.all_points_std = ((hi - lo).max(axis=-1).reshape(b, 1, 1)) / 2
        elif normalize_per_shape:
            self.all_points_mean = pts.mean(axis=1).reshape(b, 1, input_dim)
            if normalize_std_per_axis:
                self.all_points_std = pts.std(axis=1).reshape(b, 1, input_dim)
            else:
                self.all_points_std = pts.reshape(b, -1).std(axis=1).reshape(b, 1, 1)
        elif all_points_mean is not None and all_points_std is not None:
            self.all_points_mean = all_points_mean
            self.all_points_std = all_points_std
        elif normalize_global:
            flat = pts.reshape(-1, input_dim)
            self.all_points_mean = flat.mean(axis=0).reshape(1, 1, input_dim)
            if normalize_std_per_axis:
                self.all_points_std = flat.std(axis=0).reshape(1, 1, input_dim)
            else:
                self.all_points_std = flat.reshape(-1).std().reshape(1, 1, 1)
        else:
            raise NotImplementedError("No Normalization")

        self.all_points = (pts - self.all_points_mean) / self.all_points_std
        self.train_points = self.all_points[:, : min(10000, n)]
        self.tr_sample_size = min(10000, tr_sample_size)
        self.te_sample_size = min(5000, te_sample_size)

    def renormalize(self, mean: np.ndarray, std: np.ndarray) -> None:
        """Swap the normalization statistics in place: undo the current
        (mean, std), apply the new pair, and rebuild ``train_points``
        (reference lion.py:314-320 — used to align a val/test split to the
        train split's statistics)."""
        raw = self.all_points * self.all_points_std + self.all_points_mean
        self.all_points_mean = mean
        self.all_points_std = std
        self.all_points = (raw - mean) / std
        self.train_points = self.all_points[:, : min(10000, self.all_points.shape[1])]

    def get_pc_stats(self, idx: int):
        if self.recenter_per_shape or self.normalize_per_shape or self.normalize_shape_box:
            return (
                self.all_points_mean[idx].reshape(1, self.input_dim),
                self.all_points_std[idx].reshape(1, -1),
            )
        return (
            self.all_points_mean.reshape(1, -1),
            self.all_points_std.reshape(1, -1),
        )

    def __len__(self):
        return len(self.train_points)

    def __getitem__(self, idx: int) -> dict:
        tr_out = self.train_points[idx]
        if self.random_subsample and self.sample_with_replacement:
            tr_idxs = np.random.choice(tr_out.shape[0], self.tr_sample_size)
        elif self.random_subsample:
            tr_idxs = np.random.permutation(tr_out.shape[0])[: self.tr_sample_size]
        else:
            tr_idxs = np.arange(self.tr_sample_size)
        tr_out = tr_out[tr_idxs].astype(np.float32)
        m, s = self.get_pc_stats(idx)
        sid, mid = self.all_cate_mids[idx]
        return {
            "idx": idx,
            "select_idx": tr_idxs,
            "tr_points": tr_out,
            "input_pts": tr_out,
            "mean": m,
            "std": s,
            "cate_idx": self.cate_idx_lst[idx],
            "sid": sid,
            "mid": mid,
        }


class LIONDataWrapper:
    """Example-yielding facade (lion.py:360-388)."""

    def __init__(
        self,
        root: str,
        category: str,
        split: str,
        n_points: int = 2048,
        normalize_11: bool = False,
    ):
        self.inner = ShapeNet15kPointClouds(
            root_dir=root,
            categories=[category],
            split=split,
            tr_sample_size=n_points,
            te_sample_size=n_points,
            random_subsample=True,
            normalize_shape_box=normalize_11,
            normalize_global=not normalize_11,
        )

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, index: int) -> Example:
        return Example(points=self.inner[index]["tr_points"], ctx=None)
