"""The port's image-conditional datasets (``gecco_tpu_torch.data``'s
``shapenet_vol``, ``taskonomy`` and ``image_io``) and the hyperparameter
fits (``utils/hyperparams.py``) against the JAX package's, on trees the
tests write the way ``tests/test_datasets.py`` writes them: the same
files and seeds give the same numpy items and loader batches, bit for bit
(``Context3d.wmat`` and the test-time extras among them)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from gecco_tpu import GaussianReparam as JGaussianReparam
from gecco_tpu import UVLReparam as JUVLReparam
from gecco_tpu.data import dataloader as jdataloader
from gecco_tpu.data import image_io as jimage_io
from gecco_tpu.data.shapenet_vol import ShapeNetVol as JShapeNetVol
from gecco_tpu.data.shapenet_vol import ShapeNetVolModel as JShapeNetVolModel
from gecco_tpu.data.taskonomy import Taskonomy as JTaskonomy
from gecco_tpu.data.taskonomy import parse_split_file as jparse_split_file
from gecco_tpu.utils import hyperparams as jhyper
from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.data import image_io
from gecco_tpu_torch.data.shapenet_vol import IM_SIZE, ShapeNetVol, ShapeNetVolModel
from gecco_tpu_torch.data.taskonomy import Taskonomy, parse_split_file
from gecco_tpu_torch.reparam import GaussianReparam, UVLReparam
from gecco_tpu_torch.utils import hyperparams
from torch_parity import write_shapenet_vol_tree

# the layout's 24 views (``write_shapenet_vol_tree``'s): a posed object
# counts 24 items until its cameras are read, in both packages
N_VIEWS = 24


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _write_tree(tmp_path, seed=0):
    return write_shapenet_vol_tree(str(tmp_path), seed)


def _same(a, b, path="item"):
    """Two records (port, JAX) the same bits, leaf for leaf."""
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b), path
        if hasattr(b, "_fields"):
            assert type(a).__name__ == type(b).__name__ and a._fields == b._fields, path
        for q, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}.{getattr(b, '_fields', range(len(b)))[q]}")
    elif b is None or isinstance(b, str):
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("mode", [
    dict(),
    dict(posed=True),
    dict(posed=True, image_conditional=True),
    dict(posed=True, image_conditional=True, is_testing=True),
    dict(posed=True, skip_fixed=True, seed=3),
])
def test_shapenet_vol_items_match_the_jax_ones(tmp_path, mode):
    root = _write_tree(tmp_path)
    port = ShapeNetVol(root, "train", n_points=256, **mode)
    ref = JShapeNetVol(root, "train", n_points=256, **mode)
    assert len(port) == len(ref) > 0
    if mode.get("skip_fixed"):
        assert len(port) == 2 * N_VIEWS  # a2 ships masks, so it is left out
    for i in (*range(0, len(port), 7), len(port) - 1):
        _same(port[i], ref[i])


def test_shapenet_vol_masks_list_split_and_errors(tmp_path):
    root = _write_tree(tmp_path)
    masked = os.path.join(root, "02691156", "a2")
    kw = dict(posed=True, image_conditional=True, n_points=128)
    port, ref = ShapeNetVolModel(masked, **kw), JShapeNetVolModel(masked, **kw)
    assert port.is_fixed and len(port) == N_VIEWS
    for v in (0, 1, 2, 3, N_VIEWS - 1):  # views 1 and 2 subsample their masked cloud
        _same(port[v], ref[v])
    paths = [masked, os.path.join(root, "03001627", "c2")]
    port = ShapeNetVol(root, paths, n_points=64, transform=lambda e: e._replace(extras=(7,)))
    ref = JShapeNetVol(root, paths, n_points=64, transform=lambda e: e._replace(extras=(7,)))
    assert len(port) == len(ref) == 2
    for i in range(2):
        _same(port[i], ref[i])
    with pytest.raises(ValueError, match="posed=True"):
        ShapeNetVolModel(masked, image_conditional=True)
    with pytest.raises(TypeError):
        ShapeNetVol(root, [masked, 3])


def test_shapenet_vol_loader_batches_match_the_jax_ones(tmp_path):
    root = _write_tree(tmp_path)
    kw = dict(posed=True, image_conditional=True, n_points=128)
    for fixed in (False, True):
        lkw = dict(batch_size=3, num_steps=None if fixed else 4, fixed_sampler=fixed,
                   num_workers=3)
        port = list(dataloader(ShapeNetVol(root, "train", **kw), **lkw))
        ref = list(jdataloader(JShapeNetVol(root, "train", **kw), **lkw))
        assert len(port) == len(ref) > 0
        for a, b in zip(port, ref):
            _same(a, b, "batch")
        assert port[0].ctx.image.shape == (3, IM_SIZE, IM_SIZE, 3)
        assert port[0].ctx.image.dtype == np.uint8 and port[0].ctx.wmat.shape == (3, 3, 4)


def _write_taskonomy(tmp_path, seed=0):
    """Two buildings; one render missing in the first, and a third
    building with no split row."""
    import h5py

    rng = np.random.default_rng(seed)
    for b, (name, n_items) in enumerate((("bldA", 4), ("bldB", 3), ("bldC", 2))):
        h5_dir, rgb_dir = tmp_path / "point_clouds", tmp_path / "rgb" / name
        os.makedirs(h5_dir, exist_ok=True)
        os.makedirs(rgb_dir, exist_ok=True)
        with h5py.File(h5_dir / f"{name}.h5", "w") as f:
            f["point"] = np.arange(n_items)
            f["view"] = np.full(n_items, b, np.int64)
            f["pc"] = rng.normal(size=(n_items, 700, 3)).astype(np.float32)
            f["k"] = rng.normal(size=(n_items, 3, 3)).astype(np.float32)
        for i in range(n_items):
            if (name, i) == ("bldA", 2):
                continue
            img = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(rgb_dir / f"{name}_{i}_{b}.jpg")
    (tmp_path / "taskonomy_split.csv").write_text("name,train,val,test\nbldA,1,0,0\n"
                                                  "bldB,0,1,0\n\n")
    return str(tmp_path)


@pytest.mark.parametrize("split", ["train", "val", "all"])
def test_taskonomy_items_and_batches_match_the_jax_ones(tmp_path, split):
    root = _write_taskonomy(tmp_path)
    port, ref = Taskonomy(root, split=split, n_points=100), JTaskonomy(root, split=split,
                                                                      n_points=100)
    assert len(port) == len(ref) == {"train": 3, "val": 3, "all": 8}[split]
    assert repr(port) == repr(ref)
    port.return_image_path_(True)
    ref.return_image_path_(True)
    for i in range(len(port)):
        np.random.seed(i)
        a = port[i]
        np.random.seed(i)
        _same(a, ref[i])
    assert port[0].ctx.image.dtype == np.uint8
    port.return_image_path_(False)
    ref.return_image_path_(False)
    # one worker: the items draw from numpy's global generator in turn
    lkw = dict(batch_size=2, num_steps=3, num_workers=1)
    np.random.seed(11)
    batches = list(dataloader(port, **lkw))
    np.random.seed(11)
    jbatches = list(jdataloader(ref, **lkw))
    assert len(batches) == len(jbatches) == 3
    for a, b in zip(batches, jbatches):
        _same(a, b, "batch")


def test_split_file_and_image_decoding_match_the_jax_ones(tmp_path):
    rows = ["name,train,val,test", "x,1,0,0", "", "y,0,0,1", "z,0,1,0"]
    assert parse_split_file(rows) == jparse_split_file(rows) == {"x": "train", "y": "test",
                                                                 "z": "val"}
    rng = np.random.default_rng(5)
    for name, img in (("rgb.jpg", (rng.random((19, 23, 3)) * 255).astype(np.uint8)),
                      ("gray.png", (rng.random((9, 7)) * 255).astype(np.uint8)),
                      ("rgba.png", (rng.random((6, 5, 4)) * 255).astype(np.uint8))):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path)
        got, want = image_io.load_rgb_uint8(path), jimage_io.load_rgb_uint8(path)
        assert got.dtype == np.uint8 and got.shape == img.shape[:2] + (3,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IOError):
        image_io.load_rgb_uint8(str(tmp_path / "missing.jpg"))


def test_hyperparameter_fits_match_the_jax_ones(tmp_path):
    root = _write_tree(tmp_path)
    kw = dict(posed=True, image_conditional=True, n_points=128)
    lkw = dict(batch_size=3, fixed_sampler=True, num_workers=2)
    loader = dataloader(ShapeNetVol(root, "train", **kw), **lkw)
    jloader = jdataloader(JShapeNetVol(root, "train", **kw), **lkw)

    fit = hyperparams.fit_gaussian_reparam(loader, n_batches=2, device="cpu")
    jfit = jhyper.fit_gaussian_reparam(jloader, n_batches=2)
    assert isinstance(fit, GaussianReparam)
    np.testing.assert_array_equal(fit.mean.numpy(), np.asarray(jfit.mean))
    np.testing.assert_array_equal(fit.std.numpy(), np.asarray(jfit.std))

    got = hyperparams.fit_sigma_max(loader, n_batches=3)
    assert got == pytest.approx(jhyper.fit_sigma_max(jloader, n_batches=3), rel=1e-6)
    reparam = GaussianReparam([0.1, -0.2, 0.3], [0.5, 0.7, 0.9], device="cpu")
    jreparam = JGaussianReparam.init([0.1, -0.2, 0.3], [0.5, 0.7, 0.9])
    got = hyperparams.fit_sigma_max(loader, reparam, n_batches=3)
    assert got == pytest.approx(jhyper.fit_sigma_max(jloader, jreparam, n_batches=3), rel=1e-6)
    assert reparam.mean.device.type == "cpu"

    uvl = hyperparams.fit_uvl_stats(loader, UVLReparam(logit_scale=1.2, device="cpu"),
                                    n_batches=3, device="cpu")
    juvl = jhyper.fit_uvl_stats(jloader, JUVLReparam.init().replace(logit_scale=1.2),
                                n_batches=3)
    assert isinstance(uvl, UVLReparam) and uvl.logit_scale == 1.2
    np.testing.assert_allclose(uvl.uvl_mean.numpy(), np.asarray(juvl.uvl_mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(uvl.uvl_std.numpy(), np.asarray(juvl.uvl_std), rtol=1e-5)
    # the fitted map standardises the finite part of the same data
    x = np.concatenate([uvl.data_to_diffusion(
        torch.from_numpy(b.points), type(b.ctx)(image=None, K=torch.from_numpy(b.ctx.K))
    ).numpy().reshape(-1, 3) for _, b in zip(range(3), loader)])
    x = x[np.isfinite(x).all(axis=1)]
    np.testing.assert_allclose(x.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(x.std(0), 1.0, rtol=1e-4)
