"""ShapeNet PointFlow-layout datasets (counterpart of
``gecco_tpu/data/shapenet_pointflow.py``, copied: numpy items, the same
items for the same seed).

Two layouts from the reference:
- per-cloud ``.npy`` files under ``root/category/split/*.npy``
  (gecco-jax/src/gecco_jax/data/torch_shapenet.py:8-22);
- the 15k-points LION-style dataset with normalization modes
  (gecco-jax/src/gecco_jax/data/lion.py:82-388) — see gecco_tpu_torch/data/lion.py.
"""

from __future__ import annotations

import os

import numpy as np

from gecco_tpu_torch.types import Example

__all__ = ["ShapeNetPointFlow", "synset_to_category", "category_to_synset"]

# category name <-> synset id map (gecco-torch/src/gecco_torch/data/shapenet_unc.py:9-63)
_CATEGORY_SYNSET = {
    "airplane": "02691156",
    "bag": "02773838",
    "basket": "02801938",
    "bathtub": "02808440",
    "bed": "02818832",
    "bench": "02828884",
    "bicycle": "02834778",
    "birdhouse": "02843684",
    "bookshelf": "02871439",
    "bottle": "02876657",
    "bowl": "02880940",
    "bus": "02924116",
    "cabinet": "02933112",
    "can": "02747177",
    "camera": "02942699",
    "cap": "02954340",
    "car": "02958343",
    "chair": "03001627",
    "clock": "03046257",
    "dishwasher": "03207941",
    "monitor": "03211117",
    "table": "04379243",
    "telephone": "04401088",
    "tin_can": "02946921",
    "tower": "04460130",
    "train": "04468005",
    "keyboard": "03085013",
    "earphone": "03261776",
    "faucet": "03325088",
    "file": "03337140",
    "guitar": "03467517",
    "helmet": "03513137",
    "jar": "03593526",
    "knife": "03624134",
    "lamp": "03636649",
    "laptop": "03642806",
    "speaker": "03691459",
    "mailbox": "03710193",
    "microphone": "03759954",
    "microwave": "03761084",
    "motorcycle": "03790512",
    "mug": "03797390",
    "piano": "03928116",
    "pillow": "03938244",
    "pistol": "03948459",
    "pot": "03991062",
    "printer": "04004475",
    "remote_control": "04074963",
    "rifle": "04090263",
    "rocket": "04099429",
    "skateboard": "04225987",
    "sofa": "04256520",
    "stove": "04330267",
    "vessel": "04530566",
    "washer": "04554684",
    "cellphone": "02992529",
}


def category_to_synset(category: str) -> str:
    return _CATEGORY_SYNSET[category]


def synset_to_category(synset: str) -> str:
    return {v: k for k, v in _CATEGORY_SYNSET.items()}[synset]


class ShapeNetPointFlow:
    """Map-style dataset over per-cloud ``.npy`` files
    (torch_shapenet.py:8-22). Each item subsamples ``n_points`` of the
    stored points with a per-item RNG."""

    def __init__(
        self, root: str, category: str, split: str, n_points: int = 2048, seed: int = 0
    ):
        if not os.path.isdir(os.path.join(root, category)) and category in _CATEGORY_SYNSET:
            category = _CATEGORY_SYNSET[category]
        self.path = os.path.join(root, category, split)
        self.npys = sorted(f for f in os.listdir(self.path) if f.endswith(".npy"))
        self.n_points = n_points
        self.seed = seed

    def __len__(self):
        return len(self.npys)

    def __getitem__(self, index: int) -> Example:
        points = np.load(os.path.join(self.path, self.npys[index]))
        rng = np.random.default_rng((self.seed, index))
        perm = rng.permutation(points.shape[0])[: self.n_points]
        return Example(points[perm].astype(np.float32), None)
