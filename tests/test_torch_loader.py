"""The port's data pipeline (``gecco_tpu_torch.data``: the samplers, the
threaded loader, the PointFlow and LION datasets) and ``types``'
``to_device``/``batch_index`` against the JAX package's, on files the tests
write: the same seeds give the same numpy batches, bit for bit."""

import threading

import numpy as np
import pytest
import torch

from gecco_tpu.data import loader as jloader
from gecco_tpu.data.lion import LIONDataWrapper as JLION
from gecco_tpu.data.lion import ShapeNet15kPointClouds as JShapeNet15k
from gecco_tpu.data.shapenet_pointflow import ShapeNetPointFlow as JShapeNetPointFlow
from gecco_tpu.types import Example as JExample
from gecco_tpu.types import batch_index as jbatch_index
from gecco_tpu_torch import types
from gecco_tpu_torch.data import ConcatDataset, ConcatenatedSampler, FixedSampler, dataloader
from gecco_tpu_torch.data.lion import LIONDataWrapper, ShapeNet15kPointClouds
from gecco_tpu_torch.data.shapenet_pointflow import ShapeNetPointFlow, category_to_synset
from gecco_tpu_torch.types import Example


class Toy:
    """Clouds i of shape [4, 3] filled with i, and an index extra."""

    def __init__(self, n=10, record=Example):
        self.n, self.record = n, record

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.record(np.full((4, 3), float(i), np.float32), None, np.int64(i))


def _write_pointflow(root, rng, splits=("train", "val"), n=5, n_points=300):
    d = root / category_to_synset("airplane")
    for split in splits:
        (d / split).mkdir(parents=True)
        for i in range(n):
            np.save(d / split / f"cloud{i}.npy", rng.normal(2.0, 3.0, (n_points, 3)))
    return str(root)


def _same(a, b):
    """Two batches (port, JAX) the same bits, leaf for leaf."""
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("fixed,sequential,steps", [(False, False, 7), (True, False, None),
                                                    (True, True, 3)])
def test_loader_batches_match_the_jax_loader(fixed, sequential, steps):
    port = list(dataloader(Toy(10), batch_size=3, num_steps=steps, fixed_sampler=fixed,
                           sequential_sampler=sequential, num_workers=2))
    ref = list(jloader.dataloader(Toy(10, JExample), batch_size=3, num_steps=steps,
                                  fixed_sampler=fixed, sequential_sampler=sequential,
                                  num_workers=2))
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        _same(a, b)


def test_samplers_and_concat_match_the_jax_ones():
    ds = Toy(7)
    assert list(ConcatenatedSampler(ds, 20, seed=3)) == list(jloader.ConcatenatedSampler(ds, 20,
                                                                                        seed=3))
    assert list(FixedSampler(ds, 5)) == list(jloader.FixedSampler(ds, 5))
    with pytest.raises(TypeError):
        len(ConcatenatedSampler(ds, None))
    with pytest.raises(ValueError):
        FixedSampler(ds, 8)
    cat, jcat = ConcatDataset([Toy(3), Toy(4)]), jloader.ConcatDataset([Toy(3), Toy(4)])
    assert len(cat) == len(jcat) == 7
    for i in (0, 2, 3, 6, -1):
        np.testing.assert_array_equal(cat[i].points, jcat[i].points)


def test_loader_error_reaches_the_consumer_and_the_thread_stops():
    class Bad(Toy):
        def __getitem__(self, i):
            if i >= 0:
                raise ValueError("boom")

    before = threading.active_count()
    with pytest.raises(ValueError, match="boom"):
        list(dataloader(Bad(4), batch_size=2, num_steps=1))
    # a loop left early stops its producer too
    it = iter(dataloader(Toy(50), batch_size=2, num_steps=25))
    next(it)
    it.close()
    assert threading.active_count() == before


def test_shard_by_process_waits_for_multi_device_training():
    """The JAX signature's ``shard_by_process`` raises until the loader
    shards with DDP (ROADMAP A10), instead of being ignored."""
    with pytest.raises(NotImplementedError, match="A10"):
        dataloader(Toy(4), batch_size=2, num_steps=1, shard_by_process=True)


def test_pointflow_dataset_matches_the_jax_one(tmp_path):
    root = _write_pointflow(tmp_path, np.random.default_rng(0))
    port = ShapeNetPointFlow(root, "airplane", "train", n_points=128, seed=3)
    ref = JShapeNetPointFlow(root, "airplane", "train", n_points=128, seed=3)
    assert len(port) == len(ref) == 5
    for i in range(5):
        np.testing.assert_array_equal(port[i].points, ref[i].points)
    batches = list(dataloader(port, batch_size=2, num_steps=4, num_workers=3))
    jbatches = list(jloader.dataloader(ref, batch_size=2, num_steps=4, num_workers=3))
    for a, b in zip(batches, jbatches):
        np.testing.assert_array_equal(a.points, b.points)


@pytest.mark.parametrize("normalize_11", [False, True])
def test_lion_datasets_match_the_jax_ones(tmp_path, normalize_11):
    root = _write_pointflow(tmp_path, np.random.default_rng(1), splits=("train",), n=4,
                            n_points=12000)
    kw = dict(categories=["airplane"], split="train", tr_sample_size=64,
              normalize_shape_box=normalize_11, normalize_global=not normalize_11)
    port, ref = ShapeNet15kPointClouds(root, **kw), JShapeNet15k(root, **kw)
    np.testing.assert_array_equal(port.all_points, ref.all_points)
    assert port.all_cate_mids == ref.all_cate_mids
    for key in ("tr_points", "mean", "std", "select_idx"):
        np.testing.assert_array_equal(port[1][key], ref[1][key])
    stats = (np.zeros((1, 1, 3)), np.ones((1, 1, 3)))
    port.renormalize(*stats)
    ref.renormalize(*stats)
    np.testing.assert_array_equal(port.train_points, ref.train_points)
    np.random.seed(5)
    a = LIONDataWrapper(root, "airplane", "train", n_points=32, normalize_11=normalize_11)[2]
    np.random.seed(5)
    b = JLION(root, "airplane", "train", n_points=32, normalize_11=normalize_11)[2]
    np.testing.assert_array_equal(a.points, b.points)


def test_to_device_and_batch_index():
    batch = next(iter(dataloader(Toy(6), batch_size=3, num_steps=1, num_workers=1)))
    moved = types.to_device(batch, "cpu")
    assert isinstance(moved, Example) and moved.ctx is None
    assert isinstance(moved.points, torch.Tensor) and moved.points.dtype == torch.float32
    np.testing.assert_array_equal(moved.points.numpy(), batch.points)
    picked = types.batch_index(batch, np.array([2, 0]))
    ref = jbatch_index(JExample(batch.points, None, batch.extras), np.array([2, 0]))
    np.testing.assert_array_equal(picked.points, np.asarray(ref.points))
    np.testing.assert_array_equal(picked.extras, np.asarray(ref.extras))
    t = types.batch_index(moved, 1)
    assert t.points.shape == (4, 3)
    assert issubclass(types.NaNError, RuntimeError) and issubclass(types.DataError,
                                                                   RuntimeError)
