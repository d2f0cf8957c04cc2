"""The unpool + MLP megakernel's Hopper design on the CPU: its plain pieces
against the JAX package, and the shape switch between its two bodies.

The Hopper body (``csrc/unpool_mlp.cu``) holds each 128-point block's x' in
shared memory, sums each block's x' and out over its two 64-point tiles,
adds the blocks' sums in rank order across the batch element's cluster and
collapses them into the MLP's pre-norm. Its plain pieces
(``_unpool_mlp_block_sums_ref``, ``_unpool_mlp_merge_ref``, composed with
the unpool's and the MLP's in ``_unpool_mlp_pieces`` on the operands
zero-padded to 128s) are held against the JAX megakernel in interpret mode
and the JAX package's ``_unpool_mlp_composed``, one ``jax.jit`` for both:
in fp32 within 1e-5 of max |ref| (the same function to rounding), in bf16
within the forward tests' 2e-2 (a few bf16 steps: the sums in other
orders move the collapse). The kernel itself runs only on the card, where
``chip_smoke.py`` holds it against its plain version.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu_torch.ops.kernels import folded_attention as tfa

REPO = Path(__file__).resolve().parents[1]
C, HEADS, I, B, W, GROUPS = 64, 4, 16, 2, 128, 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _maxrel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _args(seed, n):
    """The megakernel's operands in fp32: the unpool's (x, se1, be1, k, v,
    wq, wo), mlp_norm's raw embed affine (sc2, bi2), the group indicator and
    the MLP's (w1t, b1, w2t, b2)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (r(B, n, C), 1.0 + 0.1 * r(B, C), 0.1 * r(B, C), r(B, I, C), r(B, I, C),
            r(C, C) / C**0.5, r(C, C) / C**0.5, 1.0 + 0.2 * r(B, C), 0.2 * r(B, C),
            np.asarray(jfa.group_indicator(C, GROUPS)), r(C, W) / C**0.5, 0.1 * r(1, W),
            r(W, C) / W**0.5, 0.1 * r(1, C))


# the operands the kernels take in the activation dtype (the rest are fp32)
_ACT = (0, 3, 4, 5, 6, 10, 12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 200])
def test_unpool_mlp_pieces_match_jax(n, dtype):
    """The Hopper body's pieces (block sums over each block's two tiles, the
    padding rows masked, merged in rank order, then the collapse) against
    the JAX megakernel and the JAX composition, at N 256 (two blocks) and a
    ragged N 200 (padded to 256)."""
    args = _args(30 + n, n)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt if q in _ACT else jnp.float32) for q, a in enumerate(args)]
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt if q in _ACT else
                                                                  torch.float32)
             for q, a in enumerate(jargs)]
    jax_side = jax.jit(lambda *a: (jfa.fused_unpool_mlp(*a, HEADS, GROUPS, n),
                                   jfa._unpool_mlp_composed(*a[:9], *a[10:], HEADS, GROUPS, n)))
    refs = jax_side(*jargs)
    out, sums = tfa._unpool_mlp_pieces(*targs[:9], *targs[10:], HEADS, GROUPS, n)
    assert out.shape == (B, n, C) and out.dtype == tdt and sums.shape == (B, 2, C)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for ref_out, ref_sums in refs:
        assert _maxrel(out.float().numpy(), ref_out.astype(jnp.float32)) < tol
        assert _maxrel(sums.numpy(), ref_sums) < tol


@pytest.mark.parametrize("n", [256, 200, 130])
def test_unpool_mlp_block_sums_leave_the_padding_out(n):
    """Each 128-point block's sums are its first tile's plus its second's,
    over the points before n_valid only; the blocks merged in rank order
    are the sums over the N points (the padding rows hold garbage here)."""
    g = torch.Generator().manual_seed(n)
    o = torch.randn(B, tfa._n_pad(n), C, generator=g)
    o[:, n:] = 1e6
    blocks = tfa._unpool_mlp_block_sums_ref(o, n)
    assert blocks.shape == (B, tfa._n_pad(n) // 128, 2, C)
    first, second = o[:, :64], o[:, 64:128]
    torch.testing.assert_close(blocks[:, 0, 0], first.sum(1) + second.sum(1))
    want = torch.stack([o[:, :n].sum(1), o[:, :n].square().sum(1)], dim=1)
    torch.testing.assert_close(tfa._unpool_mlp_merge_ref(blocks), want, rtol=1e-5, atol=1e-3)


# (N, C, H, I, W) -> the body of fused_unpool_mlp (None: the separate kernels)
@pytest.mark.parametrize("shape,body", [
    ((2048, 384, 8, 64, 768), "hopper"),    # the flagship
    ((2000, 384, 8, 64, 768), "hopper"),    # the flagship at a ragged N (padded to 2048)
    ((1, 384, 8, 64, 768), "hopper"),       # one point: a cluster of one block
    ((2048, 128, 4, 64, 256), "wmma"),      # the upsample demo's C 128
    ((8192, 768, 16, 64, 1536), "wmma"),    # the 8k width
    ((4096, 384, 8, 64, 768), "wmma"),      # more points than one cluster holds
    ((2048, 384, 3, 64, 768), "wmma"),      # three heads (D 128)
    ((2048, 384, 8, 32, 768), "wmma"),      # 32 inducers
    ((2000, 128, 4, 64, 256), None),        # a ragged N beyond the Hopper body's width
    ((2048, 100, 4, 64, 200), None),        # C % 16 != 0
], ids=["flagship", "n2000", "n1", "demo", "8k", "n4096", "heads3", "i32", "demo-n2000",
        "c100"])
def test_unpool_mlp_switch_chooses_by_shape(shape, body):
    """The body is chosen from the shapes alone, before any launch: the
    Hopper body for the flagship family up to one cluster of 16 blocks, the
    WMMA body where a point tile divides N and both tile plans fit one SM,
    else the separate kernels (``unpool_mlp_fits_sm`` false: the layer's
    switch then runs ``folded_unpool`` and ``fused_mlp_residual``)."""
    n, c, h, i, w = shape
    assert tfa._unpool_mlp_body(n, c, h, i, w) == body
    assert tfa.unpool_mlp_fits_sm(n, c, i, w, h) == (body is not None)


def test_unpool_mlp_mirrors_match_the_sources():
    """The Python mirrors of the Hopper body's block, cluster and shared
    memory (``_MEGA_ROWS``, ``_MEGA_CLUSTER``, ``_unpool_mlp_hopper_smem``)
    repeat csrc/unpool_mlp.cu's constants, and its block fits one SM."""
    src = (REPO / "gecco_tpu_torch" / "csrc" / "unpool_mlp.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTile"] * const["kTiles"] == tfa._MEGA_ROWS == 128
    assert const["kMaxCluster"] == tfa._MEGA_CLUSTER == 16
    assert (const["kKRing"], const["kVRing"], 2 * const["kNW"]) == (3, 1, 384)
    # x' 96 KB, the rings 48 + 48 KB, the p buffers 16 KB, the sums 15 KB
    assert tfa._unpool_mlp_hopper_smem(384) == 229552 <= tfa._MAX_SMEM
