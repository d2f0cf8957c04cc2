"""The port's fused functions against the JAX package's, on the CPU.

On CPU tensors each wrapper of ``gecco_tpu_torch.ops.kernels`` runs its
plain version; it is held here against the JAX op (its Pallas kernel in
interpret mode) and against the JAX XLA twin, in fp32 at the JAX tests' own
tolerance (forward rtol 1e-4, atol 1e-5). The backward cases take the
port's gradients through its ``torch.autograd.Function``s and hold them
against ``jax.vjp`` of the JAX op (its Pallas backward kernel in interpret
mode), at the tolerances of the JAX package's own backward tests. The
Hopper kernels themselves run only on the card, where ``chip_smoke.py``
holds each against its plain version.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu.ops.pallas import hside as jhs
from gecco_tpu_torch.ops import kernels
from gecco_tpu_torch.ops.kernels import _build
from gecco_tpu_torch.ops.kernels import folded_attention as tfa
from gecco_tpu_torch.ops.kernels._grad import needs_grad
from gecco_tpu_torch.ops.kernels import hside as ths
from gecco_tpu_torch.ops.kernels import induced_attention as tia
from gecco_tpu_torch.ops.kernels.induced_attention import rect_attention_pallas
from gecco_tpu_torch.ops.kernels.projective_gather import (
    _gather_body,
    _gather_bwd_binned_ref,
    _gather_ref,
    projective_gather,
    projective_gather_bwd,
)
from torch_parity import GATHER_COORDS, gather_coords

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
C, HEADS, I, B, N = 64, 4, 16, 2, 256
GROUPS = 8
# per-head scales of the drift case: head 0's logits ~60x head 1's, so the
# heads' maxima sit far more than the exp clamp (80) apart
DRIFT = np.repeat(np.array([60.0, 1.0, 0.1, 0.01], np.float32), C // HEADS)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(port.detach().numpy(), np.float32), np.asarray(ref, np.float32),
        rtol=RTOL, atol=atol,
    )


def _pool_args(seed, drift):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    se = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    be = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    ind2 = rng.standard_normal((HEADS * I, C // HEADS)).astype(np.float32)
    kvw = (rng.standard_normal((2 * C, C)) / C**0.5).astype(np.float32)
    if drift:
        kvw[:C] *= DRIFT[:, None]  # k rows of head h scaled by DRIFT
    wo = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    return x, se, be, ind2, kvw, wo


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_ext_matches_jax(drift):
    args = _pool_args(0, drift)
    port = tfa.folded_pool_ext(*map(torch.from_numpy, args), HEADS)
    jargs = tuple(map(jnp.asarray, args))
    _close(port, jfa.folded_pool_ext(*jargs, HEADS))
    _close(port, jfa._pool_ext_ref(*jargs, HEADS))


def test_fold_qf_and_group_indicator_match_jax():
    _, _, _, ind2, kvw, _ = _pool_args(1, False)
    _close(tfa.fold_qf(torch.from_numpy(ind2), torch.from_numpy(kvw), HEADS),
           jfa._fold_qf(jnp.asarray(ind2), jnp.asarray(kvw), HEADS))
    np.testing.assert_array_equal(
        tfa.group_indicator(C, 8).numpy(), np.asarray(jfa.group_indicator(C, 8))
    )


def _unpool_args(seed, drift):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    se = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    be = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    k = rng.standard_normal((B, I, C)).astype(np.float32)
    if drift:
        k *= DRIFT[None, None, :]
    v = rng.standard_normal((B, I, C)).astype(np.float32)
    wq = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    wo = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    return x, se, be, k, v, wq, wo


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_unpool_matches_jax(drift):
    args = _unpool_args(2, drift)
    out, sums = tfa.folded_unpool(*map(torch.from_numpy, args), HEADS)
    jargs = tuple(map(jnp.asarray, args))
    for ref_out, ref_sums in (jfa.folded_unpool(*jargs, HEADS), jfa._unpool_ref(*jargs, HEADS)):
        # drifted logits reach the hundreds, where fp32 rounding of a logit
        # moves its probability by ~1e-5: the JAX package's own drift test
        # (test_unpool_softmax_per_head_scale_drift) holds atol 1e-4 there
        _close(out, ref_out, atol=1e-4 if drift else ATOL)
        # sums of N values of size ~x^2: relative tolerance as the JAX tests
        np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-3, atol=1e-3)


def _mlp_args(seed):
    rng = np.random.default_rng(seed)
    w = 2 * C
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    se = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    be = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    w1t = (rng.standard_normal((C, w)) / C**0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((1, w))).astype(np.float32)
    w2t = (rng.standard_normal((w, C)) / w**0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((1, C))).astype(np.float32)
    return x, se, be, w1t, b1, w2t, b2


def test_mlp_residual_matches_jax():
    args = _mlp_args(3)
    out, sums = tfa.fused_mlp_residual(*map(torch.from_numpy, args))
    jargs = tuple(map(jnp.asarray, args))
    for ref_out, ref_sums in (jfa.fused_mlp_residual(*jargs), jfa._mlp_ref(*jargs)):
        _close(out, ref_out)
        np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-3, atol=1e-3)


def _hside_args(seed, groups=8):
    rng = np.random.default_rng(seed)
    w = 2 * C
    h0 = rng.standard_normal((B, I, C)).astype(np.float32)
    aff = [(1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32) if q % 2 == 0
           else (0.2 * rng.standard_normal((B, C))).astype(np.float32) for q in range(4)]
    gind = np.array(jfa.group_indicator(C, groups))
    w1t = (rng.standard_normal((C, w)) / C**0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((1, w))).astype(np.float32)
    w2t = (rng.standard_normal((w, C)) / w**0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((1, C))).astype(np.float32)
    wk = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    wv = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    return (h0, *aff, gind, w1t, b1, w2t, b2, wk, wv)


def test_hside_matches_jax():
    args = _hside_args(4)
    port = ths.fused_h_side(*map(torch.from_numpy, args))
    jargs = tuple(map(jnp.asarray, args))
    for ref in (jhs.fused_h_side(*jargs), jhs._hside_ref(*jargs)):
        for a, r in zip(port, ref):
            _close(a, r)


def test_launch_counters_stay_zero_on_cpu_tensors():
    kernels.reset_launch_counts()
    ua = _unpool_mlp_args(5, False)
    q, k, v = (_leaves([a.reshape(B, -1, HEADS, C // HEADS).transpose(0, 2, 1, 3).copy()])[0]
               for a in (ua[0], ua[3], ua[4]))
    outs = [
        tfa.folded_pool_ext(*_leaves(_pool_args(5, False)), HEADS),
        *tfa.folded_unpool(*_leaves(_unpool_args(5, False)), HEADS),
        *tfa.fused_mlp_residual(*_leaves(_mlp_args(5))),
        *ths.fused_h_side(*_leaves(_hside_args(5))),
        projective_gather(*_gather_leaves(5)),
        rect_attention_pallas(q, k, v),
        *tfa.fused_unpool_mlp(*_leaves(ua), HEADS, GROUPS, N),
        *tfa.folded_pool_layer(*_leaves(_pool_args(5, False)), tfa.group_indicator(C, GROUPS),
                               HEADS),
        *tfa.folded_unpool(*_leaves(_unpool_args(5, False)), HEADS, False, False),
    ]
    # through every forward and every backward
    torch.autograd.backward([o.float().square().sum() for o in outs])
    assert kernels.launch_counts() == {
        "folded_pool_ext": 0, "fused_h_side": 0, "folded_unpool": 0, "fused_mlp_residual": 0,
        "fused_mlp_residual_narrow": 0, "projective_gather": 0, "rect_attention_fwd": 0, "fused_unpool_mlp": 0,
        "folded_pool_layer": 0, "folded_pool_ext_bwd": 0, "folded_unpool_bwd": 0,
        "fused_mlp_residual_bwd": 0, "projective_gather_bwd": 0, "rect_attention_bwd": 0,
        "folded_pool_layer_bwd": 0, "folded_pool_ext_wmma": 0, "fused_h_side_wmma": 0,
        "folded_pool_layer_wmma": 0,
        "folded_unpool_wmma": 0, "fused_mlp_residual_wmma": 0, "folded_pool_ext_bwd_wmma": 0,
        "folded_unpool_bwd_wmma": 0, "fused_mlp_residual_bwd_wmma": 0,
        "folded_pool_layer_bwd_wmma": 0, "rect_attention_fwd_wmma": 0,
        "rect_attention_bwd_wmma": 0, "fused_unpool_mlp_wmma": 0,
        "folded_pool_ext_bwd_v1": 0, "folded_pool_ext_bwd_v2": 0, "folded_pool_ext_bwd_v2j": 0,
        "folded_pool_ext_bwd_v1_wmma": 0, "folded_pool_ext_bwd_v2_wmma": 0,
        "folded_pool_ext_bwd_v2j_wmma": 0, "projective_gather_simt": 0,
        "projective_gather_bwd_simt": 0,
        **{f"{fn.__name__}_f32": 0 for fn in kernels.F32_BODIES},
    }


def _unpool_mlp_args(seed, drift):
    """The megakernel's operands: the unpool's, mlp_norm's raw embed affine
    sc2/bi2 [B, C], the group indicator and the MLP's."""
    rng = np.random.default_rng(seed)
    sc2 = (1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32)
    bi2 = (0.2 * rng.standard_normal((B, C))).astype(np.float32)
    gind = np.array(jfa.group_indicator(C, GROUPS))
    return (*_unpool_args(seed, drift), sc2, bi2, gind, *_mlp_args(seed + 1)[3:])


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_unpool_mlp_matches_jax(drift):
    """``fused_unpool_mlp`` (the plain composition on the CPU) against the
    JAX megakernel in interpret mode and against the JAX package's
    ``_unpool_mlp_composed``: out at the forward tests' tolerance (atol
    1e-4 with drifted logits, as the unpool's), the sums as theirs."""
    args = _unpool_mlp_args(20, drift)
    out, sums = tfa.fused_unpool_mlp(*map(torch.from_numpy, args), HEADS, GROUPS, N)
    jargs = tuple(map(jnp.asarray, args))
    composed = jfa._unpool_mlp_composed(*jargs[:9], *jargs[10:], HEADS, GROUPS, N)
    for ref_out, ref_sums in (jfa.fused_unpool_mlp(*jargs, HEADS, GROUPS, N), composed):
        _close(out, ref_out, atol=1e-4 if drift else ATOL)
        np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_unpool_mlp_backward_matches_jax(drift):
    """The megakernel's gradients through both outputs (the sums cotangent
    nonzero) against ``jax.vjp`` of the JAX megakernel, whose backward
    recomputes through the unpool and MLP backward kernels (interpret
    mode); the group indicator takes none. Tolerance of the unpool's
    backward test."""
    args = _unpool_mlp_args(21, drift)
    rng = np.random.default_rng(22)
    g = [_cotangent(rng, B, N, C), _cotangent(rng, B, 2, C, scale=1e-2)]
    port = _port_grads(lambda *a: tfa.fused_unpool_mlp(*a, HEADS, GROUPS, N), args, g)
    ref = _jax_grads(lambda *a: jfa.fused_unpool_mlp(*a, HEADS, GROUPS, N), args, g)
    assert port[9] is None
    _close_grads(port[:9] + port[10:], ref[:9] + ref[10:], rtol=3e-4, atol=3e-5, drift=drift)


def test_register_chunk_and_row_tile_fit_the_register_tiles():
    # the CUDA kernels keep at most 8 warps x 12 accumulator tiles of 16x16
    assert ths._register_chunk(64, 384) == 384
    assert ths._register_chunk(64, 768) == 384
    assert tfa._row_tile(2048, 384) == 64
    assert tfa._row_tile(8192, 768) == 32
    for n, c in ((100, 384), (2048, 1024)):
        with pytest.raises(ValueError):
            tfa._row_tile(n, c)


# ------------------------------------------------------------- backward --


def _leaves(args):
    """torch leaves of the numpy arguments; the float ones require grad."""
    return [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in args]


def _port_grads(fn, args, cotangents):
    """Gradients of the port's fused function through its autograd.Function."""
    leaves = _leaves(args)
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return [x.grad for x in leaves]


def _jax_grads(fn, args, cotangents):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    cot = tuple(map(jnp.asarray, cotangents))
    return vjp(cot if len(cot) > 1 else cot[0])


def _close_grads(port, ref, rtol, atol, drift=False):
    """With drifted logits (one head's ~60x another's, in the hundreds) fp32
    rounding of a logit moves a gradient by ~1e-5 of its largest value, as
    in the forward drift tests: the absolute tolerance then scales with
    max |ref| (2e-5 of it), the relative one stays the JAX tests'."""
    for q, (a, r) in enumerate(zip(port, ref)):
        r = np.asarray(r)
        tol = max(atol, 2e-5 * float(np.abs(r).max())) if drift else atol
        np.testing.assert_allclose(a.numpy(), r, rtol=rtol, atol=tol,
                                   err_msg=f"gradient of argument {q}")


def _cotangent(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_ext_backward_matches_jax(drift):
    """The port's pool backward (autograd of the plain version on the CPU)
    against ``jax.vjp`` of the JAX op, whose backward is the v3 Pallas
    kernel in interpret mode; tolerance of test_pallas_ops.py's pool
    backward test."""
    args = _pool_args(6, drift)
    g = [_cotangent(np.random.default_rng(7), B, I, C)]
    port = _port_grads(lambda *a: tfa.folded_pool_ext(*a, HEADS), args, g)
    ref = _jax_grads(lambda *a: jfa.folded_pool_ext(*a, HEADS), args, g)
    _close_grads(port, ref, rtol=5e-4, atol=5e-5, drift=drift)


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_unpool_backward_matches_jax(drift):
    """Unpool gradients through both outputs, the sums cotangent nonzero,
    against ``jax.vjp`` of the JAX op (its backward kernel in interpret
    mode); tolerance of test_pallas_ops.py's unpool backward test."""
    args = _unpool_args(8, drift)
    rng = np.random.default_rng(9)
    g = [_cotangent(rng, B, N, C), _cotangent(rng, B, 2, C, scale=1e-2)]
    port = _port_grads(lambda *a: tfa.folded_unpool(*a, HEADS), args, g)
    ref = _jax_grads(lambda *a: jfa.folded_unpool(*a, HEADS), args, g)
    _close_grads(port, ref, rtol=3e-4, atol=3e-5, drift=drift)


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_mlp_backward_matches_jax(drift):
    """MLP gradients through both outputs, the sums cotangent nonzero,
    against ``jax.vjp`` of the JAX op (its backward kernel in interpret
    mode); tolerance of test_pallas_ops.py's MLP backward test. The drift
    case scales the stream per channel as chip_smoke.py does."""
    args = list(_mlp_args(10))
    if drift:
        args[0] = args[0] * DRIFT[None, None, :] / 10
    rng = np.random.default_rng(11)
    g = [_cotangent(rng, B, N, C), _cotangent(rng, B, 2, C, scale=1e-2)]
    port = _port_grads(tfa.fused_mlp_residual, args, g)
    ref = _jax_grads(jfa.fused_mlp_residual, args, g)
    _close_grads(port, ref, rtol=2e-4, atol=2e-4, drift=drift)


def test_hside_backward_matches_jax():
    """fused_h_side's backward recomputes the plain version under autograd,
    as the JAX package's custom_vjp does; every input but the group
    indicator gets a gradient."""
    args = _hside_args(12)
    rng = np.random.default_rng(13)
    g = [_cotangent(rng, B, I, C) for _ in range(3)]
    port = _port_grads(ths.fused_h_side, args, g)
    ref = _jax_grads(jhs.fused_h_side, args, g)
    assert port[5] is None  # the group indicator
    _close_grads(port[:5] + port[6:], ref[:5] + ref[6:], rtol=RTOL, atol=1e-4)


def test_backward_wrappers_match_autograd_of_the_plain_versions():
    """The ``*_bwd`` wrappers (what the CUDA backward kernels replace) on CPU
    tensors are exactly autograd through the plain forward."""
    rng = np.random.default_rng(14)
    args = _pool_args(15, False)
    g = _cotangent(rng, B, I, C)
    got = tfa.folded_pool_ext_bwd(*map(torch.from_numpy, args), None, None, None,
                                  torch.from_numpy(g), HEADS)
    want = _port_grads(lambda *a: tfa._pool_ext_ref(*a, HEADS), args, [g])
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    args = _mlp_args(16)
    g = [_cotangent(rng, B, N, C), _cotangent(rng, B, 2, C)]
    got = tfa.fused_mlp_residual_bwd(*map(torch.from_numpy, args + tuple(g)))
    want = _port_grads(tfa._mlp_ref, args, g)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_pool_forward_keeps_no_graph_and_no_statistics_without_grad():
    """Without a gradient (the sampler) the fused functions record no graph."""
    leaves = _leaves(_pool_args(17, False))
    with torch.no_grad():
        h0 = tfa.folded_pool_ext(*leaves, HEADS)
        out, sums = tfa.folded_unpool(*_leaves(_unpool_args(17, False)), HEADS)
    assert h0.grad_fn is None and out.grad_fn is None and sums.grad_fn is None
    assert needs_grad(*leaves) and not needs_grad(*(x.detach() for x in leaves))


# ------------------------------------------------------ projective gather --

# the pyramid of the dataset's 137x137 renders (34^2, 17^2, 8^2) at narrow
# widths; the JAX package's gather is held in tests/test_torch_conditional.py


def _gather_args(seed, sizes=((34, 34, 8), (17, 17, 16), (8, 8, 32))):
    """Levels [B, H, W, C] and hw01 [B, N, 2] in [-0.1, 1.1], so that
    corners fall outside the image on every side."""
    rng = np.random.default_rng(seed)
    levels = [rng.standard_normal((B, h, w, c)).astype(np.float32) for h, w, c in sizes]
    hw01 = rng.uniform(-0.1, 1.1, (B, 96, 2)).astype(np.float32)
    return levels, hw01


def _gather_leaves(seed):
    levels, hw01 = _gather_args(seed)
    return [torch.from_numpy(lv).requires_grad_(True) for lv in levels], \
        torch.from_numpy(hw01).requires_grad_(True)


def test_projective_gather_bwd_wrapper_matches_autograd_of_the_plain_version():
    """``projective_gather_bwd`` (what the CUDA backward kernel replaces) on
    CPU tensors is exactly autograd through the plain forward; without a
    coordinate gradient it returns None for it."""
    levels, hw01 = _gather_args(23)
    rng = np.random.default_rng(24)
    g = _cotangent(rng, B, 96, sum(lv.shape[-1] for lv in levels))
    lv_t = [torch.from_numpy(lv) for lv in levels]
    dhw, dlevels = projective_gather_bwd(lv_t, torch.from_numpy(hw01), torch.from_numpy(g))
    want = _port_grads(lambda hw, *lv: _gather_ref(hw, *lv), [hw01, *levels], [g])
    for a, r in zip([dhw, *dlevels], want):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    none, again = projective_gather_bwd(lv_t, torch.from_numpy(hw01), torch.from_numpy(g),
                                            coords_grad=False)
    assert none is None and all(torch.equal(a, b) for a, b in zip(again, dlevels))


@pytest.mark.parametrize("coords", GATHER_COORDS)
def test_gather_bwd_binned_ref_matches_autograd_of_the_plain_version(coords):
    """The Hopper backward's algebra in plain PyTorch (a stable bin by floor
    cell, each pixel the sum over its four neighbouring cells' points, the
    coordinate gradient per point) against autograd of the plain forward, in
    fp32, on each coordinate set. Points with NaN or +-1e9 coordinates
    contribute nothing: their coordinate gradient is 0 (autograd's is held
    at the finite points only: its weight products carry a NaN coordinate's
    NaN into its own gradient)."""
    levels, _ = _gather_args(31)
    rng = np.random.default_rng(32)
    hw01 = gather_coords(coords, rng, B, 96, levels[0].shape[1:3])
    g = _cotangent(rng, B, 96, sum(lv.shape[-1] for lv in levels))
    dhw, dlevels = _gather_bwd_binned_ref([torch.from_numpy(lv) for lv in levels],
                                          torch.from_numpy(hw01), torch.from_numpy(g))
    want = _port_grads(lambda hw, *lv: _gather_ref(hw, *lv), [hw01, *levels], [g])
    for q, (a, r) in enumerate(zip(dlevels, want[1:])):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"dF of level {q}")
    finite = np.isfinite(hw01).all(-1) & (np.abs(hw01) < 1e3).all(-1)
    np.testing.assert_allclose(dhw.numpy()[finite], want[0].numpy()[finite], rtol=1e-4,
                               atol=1e-4)
    assert (dhw.numpy()[~finite] == 0).all()
    assert (coords == "outside") == (not finite.all())


def _switch_case(case):
    """Levels (on the CPU: the switch reads shapes, dtypes and addresses
    only), hw01 and g of one case of ``test_gather_body_switch``."""
    widths, n, shift, g_shift = {
        "C % 8": ((8, 16, 32), 64, 0, 0),
        "C 2048": ((2048,), 64, 0, 0),
        "C 96, 192, 384, N 4096": ((96, 192, 384), 4096, 0, 0),
        "C % 8 != 0": ((6, 16), 64, 0, 0),
        "C 2056": ((2056,), 64, 0, 0),
        "8-byte aligned": ((8, 16), 64, 4, 0),
        "N 4097": ((8, 16), 4097, 0, 0),
        "g 8-byte aligned": ((8, 16), 64, 0, 4),
        "odd C": ((7, 16), 64, 0, 0),
        "2-byte aligned": ((8, 16), 64, 1, 0),
        "five levels": ((8,) * 5, 64, 0, 0),
        "fp32": ((96, 192, 384), 64, 0, 0),
        "mixed dtypes": ((8, 16), 64, 0, 0),
        "no level": ((), 64, 0, 0),
    }[case]
    dtypes = {"fp32": (torch.float32,) * 3,
              "mixed dtypes": (torch.bfloat16, torch.float32)}.get(case, (torch.bfloat16,) * 5)

    def shifted(shape, by, dt=torch.bfloat16):
        # ``by`` elements past an aligned allocation
        return torch.empty(int(np.prod(shape)) + by, dtype=dt)[by:].view(shape)

    levels = [shifted((1, 4, 4, c), shift, dt) for c, dt in zip(widths, dtypes)]
    g = shifted((1, n, sum(widths)), g_shift, dtypes[0])
    return levels, torch.zeros(1, n, 2), g


@pytest.mark.parametrize("case, forward, backward", [
    ("C % 8", "hopper", "hopper"),
    ("C 2048", "hopper", "hopper"),
    ("C 96, 192, 384, N 4096", "hopper", "hopper"),
    ("C % 8 != 0", "simt", "simt"),
    ("C 2056", "simt", "simt"),
    ("8-byte aligned", "simt", "simt"),
    ("N 4097", "hopper", "simt"),
    ("g 8-byte aligned", "hopper", "simt"),
    ("odd C", "simt", "simt"),
    ("2-byte aligned", "simt", "simt"),
    ("five levels", "simt", "simt"),
    ("fp32", "simt", "simt"),
    ("mixed dtypes", "dtypes differ", None),
    ("no level", "no level", None),
])
def test_gather_body_switch(case, forward, backward):
    """Which body of the gather takes which operands on the card: the
    Hopper bodies bf16 levels, 1 to 4 of them, every C % 8 == 0 up to 2048,
    16-byte aligned (the backward also N <= 4096 and g 16-byte aligned),
    the SIMT bodies everything else (fp32, odd C, 2-byte alignment, more
    than four levels). The switch raises only where there is no level or
    the levels' dtypes differ, and says which."""
    levels, hw01, g = _switch_case(case)
    if backward is None:
        for extra in ((), (g,)):
            with pytest.raises(ValueError, match=forward):
                _gather_body(levels, hw01, *extra)
        return
    assert _gather_body(levels, hw01) == forward
    assert _gather_body(levels, hw01, g) == backward


@jax.jit
def _jax_lookup_and_grads(hw01, g, *levels):
    """The JAX gather, one ``bilinear_lookup_pallas`` per level (its
    kernels in interpret mode), and ``jax.grad`` of <out, g> in the
    coordinates and every level, in one jit."""
    from gecco_tpu.ops.pallas.projective_gather import lookup_pyramid_pallas

    def loss(hw, *lvs):
        out = lookup_pyramid_pallas(lvs, hw)
        return (out.astype(jnp.float32) * g).sum(), out

    grads, out = jax.grad(loss, argnums=tuple(range(1 + len(levels))), has_aux=True)(
        hw01, *levels)
    return out, grads


@pytest.mark.parametrize("case, widths, sizes, dtype, tol", [
    # fp32: the same function summed in other orders (the JAX kernel's
    # one-hot products), a few fp32 steps
    ("fp32, odd C", (3, 35, 131), (16, 8, 4), "float32", 1e-5),
    ("fp32, five levels", (8, 6, 5, 4, 3), (16, 12, 8, 5, 3), "float32", 1e-5),
    # bf16: the plain version rounds each corner's product to bf16, the JAX
    # kernel its one-hot weights, so a few bf16 steps (2^-8) of the largest
    # value; the gradients are fp32 sums of bf16 products
    ("bf16, five levels of odd C", (3, 5, 7, 9, 11), (16, 12, 8, 5, 3), "bfloat16", 2e-2),
])
def test_gather_plain_matches_jax_where_only_the_simt_body_takes(case, widths, sizes, dtype,
                                                                 tol):
    """The operands that only the SIMT bodies take on the card (fp32
    levels, odd C, more than four levels: two launches of each), through
    the port's plain version on the CPU, against the JAX package's gather
    (``lookup_pyramid_pallas``: one Pallas call per level, any dtype and
    C), forward and backward with the coordinate gradient, on uniform
    coordinates with corners outside the image: max |err| / max |ref| per
    output within ``tol``."""
    rng = np.random.default_rng(31)
    levels = [rng.standard_normal((B, h, h, c)).astype(np.float32) for c, h in zip(widths, sizes)]
    hw01 = gather_coords("uniform", rng, B, 96, (sizes[0], sizes[0]))
    g = rng.standard_normal((B, 96, sum(widths))).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out_j, grads_j = _jax_lookup_and_grads(jnp.asarray(hw01), jnp.asarray(g),
                                           *(jnp.asarray(lv, jdt) for lv in levels))
    lv_t = [torch.from_numpy(lv).to(tdt) for lv in levels]
    hw_t = torch.from_numpy(hw01)
    out = projective_gather(lv_t, hw_t)
    assert out.dtype == tdt and out.shape == (B, 96, sum(widths))
    dhw, dlevels = projective_gather_bwd(lv_t, hw_t, torch.from_numpy(g).to(tdt))
    for what, a, r in [("out", out, out_j), ("d hw01", dhw, grads_j[0]),
                       *((f"dF level {q}", d, r) for q, (d, r) in
                         enumerate(zip(dlevels, grads_j[1:])))]:
        a, r = a.float().numpy(), np.asarray(r, np.float32)
        err = np.abs(a - r).max() / max(np.abs(r).max(), 1e-30)
        assert err < tol, f"{case} {what}: {err:.3e}"


def test_pool_bwd_witness_matches_the_jax_kernel_in_bf16():
    """``chip_smoke.py``'s ``pool_bwd_v3_affine``, the witness that the
    card's drifted dbe is held against, is the JAX kernel's own algebra: on
    bf16 operands with drifted logits its dse/dbe agree with ``jax.vjp`` of
    the JAX op (the default v3 body, ``_pool_ext_bwd_kernel_v3``, in
    interpret mode) within 1e-3 of max |ref|, while autograd of the plain
    version departs by more than that limit there."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    bf = torch.bfloat16
    args = _pool_args(3, True)
    assert jfa._pool_bwd_mode(N, C, HEADS * I, C // HEADS) == "v3"
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(args)]
    g_h0 = torch.from_numpy(
        np.random.default_rng(9).standard_normal((B, I, C)).astype(np.float32)).to(bf)
    witness = chip_smoke.pool_bwd_v3_affine(*ops, g_h0, HEADS)
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, g: jax.vjp(lambda *p: jfa.folded_pool_ext(*p, HEADS), *a)[1](g))(
        jops, jnp.asarray(g_h0.float().numpy(), jnp.bfloat16))
    leaves = [a.clone().requires_grad_(True) for a in ops]
    tfa._pool_ext_ref(*leaves, HEADS).backward(g_h0)
    for name, w, r, plain in (("dse", witness[0], ref[1], leaves[1].grad),
                              ("dbe", witness[1], ref[2], leaves[2].grad)):
        r = np.asarray(r, np.float32)
        scale = float(np.abs(r).max())
        assert np.abs(w.numpy() - r).max() < 1e-3 * scale, name
        assert np.abs(plain.float().numpy() - r).max() > 1e-3 * scale, name


def _maxrel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_pieces_compose_to_the_plain_version(drift, dtype):
    """The plain versions of the pool's four launches (the query fold, the
    per-chunk partials, the merge with the output
    projection) compose to ``_pool_ext_ref``: in fp32 to rounding, in bf16
    within a few bf16 steps (they round e before P / l, the plain version
    p after normalising). Their column max and sum equal the JAX kernel's
    softmax statistics (fp32)."""
    dt = getattr(torch, dtype)
    args = _pool_args(11, drift)
    x, se, be, ind2, kvw, wo = (torch.from_numpy(a).to(dt if q in (0, 3, 4, 5) else torch.float32)
                                for q, a in enumerate(args))
    ref = tfa._pool_ext_ref(x, se, be, ind2, kvw, wo, HEADS)
    _, jm, jl = jfa._pool_ext_p(*map(jnp.asarray, args), HEADS)
    m, l, p = tfa._pool_partials_ref(x, se, be, tfa._fold_qft_ref(ind2, kvw, HEADS), kvw, HEADS)
    assert p.shape == (B, N // tfa._POOL_CHUNK, HEADS * I, C // HEADS)
    h0, mm, ll = tfa._pool_merge_ref(m, l, p, wo, HEADS)
    assert _maxrel(h0.float().numpy(), ref.float().numpy()) < (1e-5 if dtype == "float32"
                                                                 else 2e-2)
    if dtype == "float32":
        np.testing.assert_allclose(mm.numpy(), np.asarray(jm)[:, 0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ll.numpy(), np.asarray(jl)[:, 0], rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual,prenorm", [(True, True), (False, False), (True, False),
                                              (False, True)])
def test_unpool_pieces_compose_to_the_plain_version(residual, prenorm, dtype):
    """The plain versions of the unpool's launches (bq and the fold, then
    the point tiles) compose to ``_unpool_ref`` in each flag variant: in
    fp32 with drifted logits to rounding (the pre-norm folded into kft and
    brow is the same function; logits in the hundreds), in bf16 with
    ordinary ones within a few bf16 steps (se folded into wq before its
    rounding, as the TPU kernel does)."""
    dt = getattr(torch, dtype)
    drift = dtype == "float32"
    x, se, be, k, v, wq, wo = (torch.from_numpy(a).to(dt if q not in (1, 2) else torch.float32)
                               for q, a in enumerate(_unpool_args(12, drift)))
    kft, vft, brow = tfa._unpool_fold_ref(se, be, k, v, wq, wo, HEADS, prenorm)
    assert vft.shape == (B, C, HEADS * I) and brow.dtype == torch.float32
    out, sums = tfa._unpool_tiles_ref(x, kft, vft, brow, HEADS, residual)
    ref_out, ref_sums = tfa._unpool_ref(x, se, be, k, v, wq, wo, HEADS, residual, prenorm)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert _maxrel(out.float().numpy(), ref_out.float().numpy()) < tol
    assert _maxrel(sums.numpy(), ref_sums.numpy()) < tol


# (B, N, C, H, I) -> the bodies of the pool, unpool and MLP forwards, and
# of the pool, unpool and MLP backwards (the MLP at W = 2C; it sees no
# heads, so three heads at C 384 are the flagship's width to it; None where
# that function raises for the shape)
@pytest.mark.parametrize("shape,bodies,bwd", [
    ((48, 2048, 384, 8, 64), ("hopper", "hopper", "hopper"),
     ("hopper", "hopper", "hopper")),  # the flagship
    ((2, 8192, 768, 16, 64), ("hopper", "hopper", "hopper"),
     ("hopper", "hopper", "hopper")),  # the 8k width
    ((48, 2048, 128, 4, 64), ("hopper", "hopper", "narrow"),
     ("hopper", "hopper", "hopper")),  # the demo's 3 x 128: the MLP's narrow forward and
    # its backward's 128-column passes
    ((48, 2048, 384, 3, 64), ("wmma", "wmma", "hopper"),
     ("hopper", "hopper", "hopper")),  # num_heads=3
    ((48, 2000, 384, 8, 64), ("hopper", "hopper", "hopper"),
     ("hopper", "hopper", "hopper")),  # the flagship at a ragged N (padded to 2048)
    ((48, 2048, 256, 4, 64), ("hopper", "hopper", "hopper"),
     ("wmma", "hopper", "hopper")),  # C 256: the MLP's 128-column passes both ways
    ((48, 2048, 64, 4, 64), ("hopper", "hopper", "wmma"),
     (None, None, None)),  # C 64: only the MLP forward's WMMA body takes it
    ((48, 2000, 100, 4, 64), (None, None, None), (None, None, None)),  # C % 16 != 0
], ids=["flagship", "8k", "demo", "heads3", "ragged", "C256", "C64", "none"])
def test_body_switches_choose_by_shape(shape, bodies, bwd):
    """The pool, unpool and MLP forwards and backwards pick one of their
    CUDA bodies by shape alone, any point count taking the bodies of its
    padded count, and a shape that none takes raises ValueError naming
    the bodies' conditions."""
    b, n, c = shape[:3]
    mlp = (b, n, c, 2 * c)
    switches = ((tfa._pool_ext_body, shape), (tfa._unpool_body, shape), (tfa._mlp_body, mlp),
                (tfa._pool_ext_bwd_body, shape), (tfa._unpool_bwd_body, shape),
                (tfa._mlp_bwd_body, mlp))
    for (switch, args), want in zip(switches, bodies + bwd):
        if want is None:
            with pytest.raises(ValueError, match="Hopper body .* WMMA body"):
                switch(*args)
        else:
            assert switch(*args) == want


# (B, N, C, H, I) -> the bodies of the pool and unpool forwards: the
# Hopper pool takes I 64 at D 16, 32, 48 or 64 and H % 4 == 0 (G 8 heads a
# block where H % 8 == 0, else 4); the Hopper unpool I 64, H even, D % 16 up
# to 64 and C % 64 up to 384 (one column block) or C % 192 above
@pytest.mark.parametrize("shape,bodies", [
    ((48, 2048, 64, 4, 64), ("hopper", "hopper")),  # D 16, four heads
    ((48, 2048, 256, 4, 64), ("hopper", "hopper")),  # D 64, four heads; the unpool at C 256
    ((48, 2048, 128, 8, 64), ("hopper", "hopper")),  # D 16, eight heads
    ((48, 2048, 512, 8, 64), ("hopper", "wmma")),  # C 512: neither <= 384 nor % 192
    ((48, 2048, 384, 6, 64), ("wmma", "hopper")),  # D 64, H % 4 != 0
    ((48, 2048, 320, 10, 64), ("wmma", "hopper")),  # the unpool's 320-column block
    ((48, 2048, 384, 3, 64), ("wmma", "wmma")),  # three heads (D 128)
    ((48, 2048, 128, 4, 48), ("wmma", "wmma")),  # I 48 at the demo's width
    ((48, 2048, 128, 4, 16), ("wmma", "wmma")),  # I 16 at the demo's width
    ((48, 2048, 192, 2, 64), ("wmma", "wmma")),  # D 96: wider than either instance
], ids=["D16-H4", "D64-H4-C256", "D16-H8", "C512", "H6", "C320", "heads3", "I48", "I16", "D96"])
def test_forward_switches_take_the_new_widths(shape, bodies):
    """The pool and unpool forwards' Hopper bodies take the widths their
    templated instances cover (the upsample demo's among them) and no
    other: three heads and an inducer count other than 64 stay on the WMMA
    bodies. The mirrors agree with the shared-memory plans: every Hopper
    pick fits the SM."""
    b, n, c, h, i = shape
    assert (tfa._pool_ext_body(*shape), tfa._unpool_body(*shape)) == bodies
    if bodies[0] == "hopper":
        assert tfa._pool_ext_smem(c, c // h, tfa._pool_ext_group(h)) <= tfa._MAX_SMEM
    if bodies[1] == "hopper":
        assert tfa._unpool_tile_smem(c) <= tfa._MAX_SMEM


# (B, N, C, H, I) -> the bodies of the pool and unpool backwards: the
# Hopper pool backward takes I 64 at C 128, 384 or 768 (any D % 16 whose
# fold fits); the Hopper unpool backward I 64 at C % 128 up to 384 or C %
# 384 above, any H (J % 128 == 64 through the weight gradients' tails)
@pytest.mark.parametrize("shape,bodies", [
    ((48, 2048, 128, 4, 64), ("hopper", "hopper")),  # the demo's four heads of 32
    ((48, 2048, 384, 3, 64), ("hopper", "hopper")),  # three heads (D 128, J 192)
    ((48, 2048, 128, 1, 64), ("hopper", "hopper")),  # one head of 128 (J 64)
    ((48, 2048, 384, 6, 64), ("hopper", "hopper")),  # D 64
    ((48, 2048, 384, 2, 64), ("hopper", "hopper")),  # D 192
    ((48, 2048, 128, 4, 48), ("wmma", "wmma")),  # I 48 at the demo's width
    ((48, 2048, 128, 4, 16), ("wmma", "wmma")),  # I 16 at the demo's width
    ((48, 2048, 640, 5, 64), ("wmma", "wmma")),  # C 640
    ((48, 2048, 256, 4, 64), ("wmma", "hopper")),  # C 256: the pool's column blocks
    ((48, 2048, 384, 4, 64), ("hopper", "hopper")),  # D 96 at C 384: any D % 16
    ((48, 2048, 192, 2, 64), (None, None)),  # D 96 at C 192: C % 128 != 0
], ids=["demo", "heads3", "H1-C128", "D64", "D192", "I48", "I16", "C640", "C256", "D96-C384",
        "D96"])
def test_backward_switches_take_the_new_widths(shape, bodies):
    """The pool and unpool backwards' Hopper bodies take the upsample
    demo's width and three heads, and the shapes their launch checks
    allow; another inducer count and C 640 stay on the WMMA bodies. Every
    Hopper pool backward's blocks fit the SM: its fold
    (``_pool_bwd_fold_smem``) and its two passes (``_pool_ext_bwd_smem``)."""
    b, n, c, h, i = shape
    for switch, want in zip((tfa._pool_ext_bwd_body, tfa._unpool_bwd_body), bodies):
        if want is None:
            with pytest.raises(ValueError, match="Hopper body .* WMMA body"):
                switch(*shape)
        else:
            assert switch(*shape) == want
    if bodies[0] == "hopper":
        assert tfa._pool_bwd_fold_smem(c, i, c // h) <= tfa._MAX_SMEM
        assert max(tfa._pool_ext_bwd_smem(c)) <= tfa._MAX_SMEM


@pytest.mark.parametrize("case,takes", [
    (("hside", 64, 384, 768, 32), True),  # the flagship's inducers
    (("hside", 32, 384, 768, 32), True),  # 32 inducers
    (("hside", 128, 384, 768, 32), False),  # one instance per I in (16, 32, 48, 64)
    (("rect", 48), True),  # the per-head flagship
    (("rect", 128), True),  # num_heads=3 at C 384
    (("rect", 40), True),  # D % 16 != 0: zero-padded to the D 48 instance
    (("rect", 144), True),  # D > 128: zero-padded to the D 192 instance
    (("rect", 200), True),  # D > 192: zero-padded to the D 256 instance
    (("rect", 272), False),  # D > 256: no instance
], ids=["hside-I64", "hside-I32", "hside-I128", "rect-D48", "rect-D128", "rect-D40",
        "rect-D144", "rect-D200", "rect-D272"])
def test_hside_and_rect_attention_route_by_shape(case, takes):
    """The h-side's WMMA body and the per-head attention (forward and
    backward share ``_check_shapes``) take their kernel by shape alone: the
    WMMA h-side at I 16 to 64, the attention at any D up to 256 (a width
    between its instances zero-padded to the next, ``_d_pad``). On the card
    a shape the kernel does not take raises; malformed operands raise
    too."""
    if case[0] == "hside":
        assert ths._hside_takes(*case[1:]) is takes
        return
    d = case[1]
    q, kv = torch.zeros(2, 3, 64, d), torch.zeros(2, 3, 100, d)
    if takes:
        tia._check_shapes("rect", q, kv, kv)
    else:
        with pytest.raises(ValueError, match="1 <= D <= 256"):
            tia._check_shapes("rect", q, kv, kv)
    with pytest.raises(ValueError, match="do not form"):
        tia._check_shapes("rect", q, kv, kv[..., :16])


# the pool backward's bodies at the flagship, 8k, demo and three-head
# shapes (as in test_body_switches_choose_by_shape) under each value of
# GECCO_POOL_BWD
POOL_BWD_SHAPES = ((48, 2048, 384, 8, 64), (2, 8192, 768, 16, 64), (48, 2048, 128, 4, 64),
                   (48, 2048, 384, 3, 64))


@pytest.mark.parametrize("mode,want", [
    (None, ("hopper", "hopper", "hopper", "hopper")),
    ("v1", ("v1", "v1", "v1_wmma", "v1")),
    ("v2", ("v2", "v2", "v2_wmma", "v2")),
    ("v2j", ("v2j", "v2j", "v2j_wmma", "v2j")),
    ("v3", ("hopper", "hopper", "hopper", "hopper")),
], ids=["unset", "v1", "v2", "v2j", "v3"])
def test_pool_bwd_switch_takes_the_forced_body(monkeypatch, mode, want):
    """GECCO_POOL_BWD as the JAX package reads it: unset or "v3", the v3
    algebra's Hopper body at all four shapes; forced to v1, v2 or v2j,
    that algebra's Hopper body at the flagship's and the 8k width (D 48,
    64 inducers) and at three heads (D 128, J 192: the S product's
    64-column tiles and the weight gradients' 64-column tail), and its WMMA
    body at the demo's width (C 128); on the card a forced body that does not
    take the shape raises (B I % 64 != 0); N 2000 takes the chosen body at
    its padded count."""
    monkeypatch.setattr(tfa, "_POOL_BWD_ENV", mode)
    for shape, body in zip(POOL_BWD_SHAPES, want):
        assert tfa._pool_ext_bwd_body(*shape) == body
    assert tfa._pool_ext_bwd_body(48, 2000, 384, 8, 64) == (
        "hopper" if mode in (None, "v3") else mode)
    if mode in ("v1", "v2", "v2j"):
        with pytest.raises(ValueError, match=f"GECCO_POOL_BWD={mode} forces"):
            tfa._pool_ext_bwd_body(1, 2048, 384, 3, 16)


def test_pool_bwd_env_parses_as_the_jax_package(capsys):
    """The accepted values of GECCO_POOL_BWD are the JAX package's, and an
    invalid value falls back to the shape-gated default (None) with the
    JAX package's message under the port's name."""
    for m in ("v1", "v2", "v2j", "v3"):
        assert tfa._parse_pool_bwd_env(m) == m == jfa._parse_pool_bwd_env(m)
    assert tfa._parse_pool_bwd_env("") is None and tfa._parse_pool_bwd_env(None) is None
    capsys.readouterr()
    assert tfa._parse_pool_bwd_env("v4") is None
    ours = capsys.readouterr().err
    assert jfa._parse_pool_bwd_env("v4") is None
    assert ours.replace("[gecco_tpu_torch]", "[gecco_tpu]") == capsys.readouterr().err != ""


def test_shared_memory_mirrors_use_the_headers_constants():
    """The shape switches' Python mirrors of the WMMA bodies' shared-memory
    plans read kMaxSmem, kPad, kPadF and kPoolTile at the values that
    csrc/common.cuh and csrc/pool.cuh give them."""
    text = (_build.CSRC / "common.cuh").read_text() + (_build.CSRC / "pool.cuh").read_text()
    header = tuple(int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))
                   for name in ("kMaxSmem", "kPad", "kPadF", "kPoolTile"))
    assert (tfa._MAX_SMEM, tfa._PAD, tfa._PADF, tfa._POOL_TILE) == header


def _pool_bwd_by_pieces(x, se, be, ind2, kvw, wo, g_h0, heads):
    """The Hopper pool backward's plain pieces in the kernels' order, on the
    forward's folded query and softmax statistics (its plain pieces)."""
    qft = tfa._fold_qft_ref(ind2, kvw, heads)
    _, macc, sacc = tfa._pool_merge_ref(*tfa._pool_partials_ref(x, se, be, qft, kvw, heads), wo,
                                        heads)
    ety = tfa._pool_bwd_ety_ref(x, se, be, qft, macc)
    tacc, w3, dwv, dwo = tfa._pool_bwd_fold_ref(ety, g_h0, kvw, wo, sacc, heads)
    dx, dse, dbe, ds = tfa._pool_bwd_dy_ref(x, se, be, qft, w3, macc, tacc)
    dqf = tfa._pool_bwd_dqf_ref(x, se, be, ds)
    return (dx, dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, heads), dwo.to(wo.dtype))


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_bwd_pieces_compose_to_the_plain_backward_in_fp32(drift):
    """In fp32 (every rounding of the v3 algebra a no-op) the pieces
    compose to autograd of the plain version within 1e-5 of each
    gradient's max |ref|."""
    ops = [torch.from_numpy(a) for a in _pool_args(13, drift)]
    g_h0 = torch.from_numpy(_cotangent(np.random.default_rng(14), B, I, C))
    got = _pool_bwd_by_pieces(*ops, g_h0, HEADS)
    want = tfa._pool_ext_bwd_ref(*ops, g_h0, HEADS)
    for name, a, r in zip(("dx", "dse", "dbe", "dind2", "dkvw", "dwo"), got, want):
        assert _maxrel(a.numpy(), r.numpy()) < 1e-5, name


def test_pool_bwd_pieces_match_the_jax_kernel_in_bf16():
    """On bf16 operands with drifted logits the pieces are the JAX v3
    kernel's algebra: against ``jax.vjp`` of the JAX op (the v3 Pallas
    backward in interpret mode) every gradient agrees within 1e-3 of max
    |ref|, the witness test's tolerance for dse and dbe (the others are
    rounded to bf16 at the end in both)."""
    bf = torch.bfloat16
    args = _pool_args(3, True)
    assert jfa._pool_bwd_mode(N, C, HEADS * I, C // HEADS) == "v3"
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(args)]
    g_h0 = torch.from_numpy(
        np.random.default_rng(9).standard_normal((B, I, C)).astype(np.float32)).to(bf)
    got = _pool_bwd_by_pieces(*ops, g_h0, HEADS)
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, g: jax.vjp(lambda *p: jfa.folded_pool_ext(*p, HEADS), *a)[1](g))(
        jops, jnp.asarray(g_h0.float().numpy(), jnp.bfloat16))
    for name, a, r in zip(("dx", "dse", "dbe", "dind2", "dkvw", "dwo"), got, ref):
        assert _maxrel(a.float().numpy(), r) < 1e-3, name


@pytest.mark.parametrize("mode", ["v1", "v2", "v2j"])
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_bwd_twopass_refs_match_the_jax_bodies(monkeypatch, mode, drift):
    """The plain versions of the v1, v2 and v2j kernels (``_pool_bwd_v1_ref``;
    ``_pool_bwd_v2_ref`` for both v2 and v2j) are the JAX package's bodies:
    on bf16 operands, from the forward's folded query and statistics (the
    port's plain pieces), against ``jax.vjp`` of the JAX op with
    ``GECCO_POOL_BWD`` forced to that body (its Pallas kernel in interpret
    mode, one ``jax.jit``; the forced body's tile fits, so no XLA twin
    ran): dse and dbe within 1e-3 of max |ref| (readings up to 5.2e-5),
    the bf16 gradients within 4e-3 of it, one bf16 step (readings up to
    1.7e-3, dkvw: rounded once at the end in both). With drifted logits
    autograd of the plain version departs from the body by more than 1e-3
    in dse and dbe (readings 5.8e-3 to 2.4e-2): the body's bf16 roundings
    of e or p, ds and dv, which its plain version keeps."""
    monkeypatch.setattr(jfa, "_POOL_BWD_ENV", mode)
    j, d = HEADS * I, C // HEADS
    v1 = mode == "v1"
    assert jfa._pool_bwd_mode(N, C, j, d) == mode
    assert jfa._tile_fits(N, jfa._pool_ext_bwd_row_bytes(C, j, v1),
                          jfa._pool_ext_bwd_fixed_bytes(C, j, d, v1, mode == "v2j"), cap=512)
    bf = torch.bfloat16
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(_pool_args(3, drift))]
    x, se, be, ind2, kvw, wo = ops
    g_h0 = torch.from_numpy(
        np.random.default_rng(9).standard_normal((B, I, C)).astype(np.float32)).to(bf)
    qft = tfa._fold_qft_ref(ind2, kvw, HEADS)
    _, macc, sacc = tfa._pool_merge_ref(*tfa._pool_partials_ref(x, se, be, qft, kvw, HEADS), wo,
                                        HEADS)
    dx, dse, dbe, dqf, dwv, dwo = tfa._TWOPASS_REFS[mode](x, se, be, qft, kvw, wo, g_h0, macc,
                                                          sacc, HEADS)
    got = (dx, dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, HEADS), dwo.to(wo.dtype))
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, g: jax.vjp(lambda *p: jfa.folded_pool_ext(*p, HEADS), *a)[1](g))(
        jops, jnp.asarray(g_h0.float().numpy(), jnp.bfloat16))
    leaves = [a.clone().requires_grad_(True) for a in ops]
    tfa._pool_ext_ref(*leaves, HEADS).backward(g_h0)
    for name, a, r, plain in zip(("dx", "dse", "dbe", "dind2", "dkvw", "dwo"), got, ref,
                                 [leaf.grad for leaf in leaves]):
        assert _maxrel(a.float().numpy(), r) < (1e-3 if name in ("dse", "dbe") else 4e-3), name
        if drift and name in ("dse", "dbe"):
            assert _maxrel(plain.float().numpy(), r) > 1e-3, name


@pytest.mark.parametrize("v1", [True, False], ids=["v1", "v2"])
@pytest.mark.parametrize("n,n_valid", [(1152, None), (1152, 1100)], ids=["N1152", "ragged"])
def test_twopass_hopper_pieces_compose_to_the_plain_bodies(v1, n, n_valid):
    """The Hopper two-pass body's plain pieces (``_twopass_fold_ref``, the
    S and V products ``_twopass_sv_ref``, pass 0's range partials
    ``_twopass_ranges_ref`` over three ranges of 512 points, their
    fixed-order ``_twopass_merge_ref``, pass 1 per tile
    ``_twopass_tiles_ref``, then dy and the weight gradients) compose to
    ``_pool_bwd_v1_ref`` / ``_pool_bwd_v2_ref`` in fp32 within 1e-5 of max
    |ref| (the same operations, the sums over points split by range), at a
    ragged tail too (``n_valid``)."""
    rng = np.random.default_rng(12)
    c, heads, i = 96, 2, 64
    x = torch.from_numpy(rng.standard_normal((B, n, c)).astype(np.float32))
    se = torch.from_numpy((1.0 + 0.1 * rng.standard_normal((B, c))).astype(np.float32))
    be = torch.from_numpy((0.1 * rng.standard_normal((B, c))).astype(np.float32))
    ind2 = torch.from_numpy((rng.standard_normal((heads * i, c // heads)) / 2).astype(np.float32))
    kvw = torch.from_numpy((rng.standard_normal((2 * c, c)) / c**0.5).astype(np.float32))
    wo = torch.from_numpy((rng.standard_normal((c, c)) / c**0.5).astype(np.float32))
    g_h0 = torch.from_numpy(rng.standard_normal((B, i, c)).astype(np.float32))
    qft = tfa._fold_qft_ref(ind2, kvw, heads)
    _, macc, sacc = tfa._pool_merge_ref(
        *tfa._pool_partials_ref(x, se, be, qft, kvw, heads, n_valid), wo, heads)
    raw = (x, se, be, qft, kvw, wo, g_h0, macc, sacc, heads)
    got = tfa._twopass_pieces(*raw, v1, n_valid)
    want = (tfa._pool_bwd_v1_ref if v1 else tfa._pool_bwd_v2_ref)(*raw, n_valid)
    assert -(-n // tfa._TWOPASS_RANGE) == 3
    for name, a, r in zip(("dx", "dse", "dbe", "dqf", "dwv", "dwo"), got, want):
        assert _maxrel(a, r) < 1e-5, name


@pytest.mark.parametrize("mode", ["v1", "v2", "v2j"])
@pytest.mark.parametrize("shape", [(64, 4, 16, N), (48, 3, 64, 128), (64, 4, 16, 200)],
                         ids=["C64", "J192", "ragged"])
def test_twopass_hopper_pieces_match_the_jax_bodies(monkeypatch, mode, shape):
    """The Hopper two-pass body's plain pieces composed (``_twopass_pieces``)
    are the JAX package's v1, v2 and v2j bodies: on bf16 operands against
    ``jax.vjp`` of the JAX op with ``GECCO_POOL_BWD`` forced to that body
    (its Pallas kernel in interpret mode, one ``jax.jit``; the tile fits,
    no XLA twin), at C 64, at three heads of 64 inducers (J 192) and at a
    ragged N 200 (the pieces on the stream zero-padded to 256 with
    ``n_valid``): dse and dbe within 1e-3 of max |ref|, the bf16 gradients
    within 4e-3 (``test_pool_bwd_twopass_refs_match_the_jax_bodies``'
    tolerances)."""
    monkeypatch.setattr(jfa, "_POOL_BWD_ENV", mode)
    c, heads, i, n = shape
    j, d = heads * i, c // heads
    v1 = mode == "v1"
    assert jfa._pool_bwd_mode(n, c, j, d) == mode
    assert jfa._tile_fits(n, jfa._pool_ext_bwd_row_bytes(c, j, v1),
                          jfa._pool_ext_bwd_fixed_bytes(c, j, d, v1, mode == "v2j"), cap=512)
    bf = torch.bfloat16
    rng = np.random.default_rng(13)
    args = [rng.standard_normal((B, n, c)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal((B, c))).astype(np.float32),
            (0.1 * rng.standard_normal((B, c))).astype(np.float32),
            (rng.standard_normal((j, d)) / 2).astype(np.float32),
            (rng.standard_normal((2 * c, c)) / 8).astype(np.float32),
            (rng.standard_normal((c, c)) / 8).astype(np.float32)]
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(args)]
    x, se, be, ind2, kvw, wo = ops
    g_h0 = torch.from_numpy(rng.standard_normal((B, i, c)).astype(np.float32)).to(bf)
    qft = tfa._fold_qft_ref(ind2, kvw, heads)
    xp = tfa._pad_points(x, tfa._n_pad(n))
    n_valid = n if n != xp.shape[1] else None
    _, macc, sacc = tfa._pool_merge_ref(
        *tfa._pool_partials_ref(xp, se, be, qft, kvw, heads, n_valid), wo, heads)
    dx, dse, dbe, dqf, dwv, dwo = tfa._twopass_pieces(xp, se, be, qft, kvw, wo, g_h0, macc, sacc,
                                                      heads, v1, n_valid)
    got = (dx[:, :n], dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, heads), dwo.to(wo.dtype))
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, g: jax.vjp(lambda *p: jfa.folded_pool_ext(*p, heads), *a)[1](g))(
        jops, jnp.asarray(g_h0.float().numpy(), jnp.bfloat16))
    for name, a, r in zip(("dx", "dse", "dbe", "dind2", "dkvw", "dwo"), got, ref):
        assert _maxrel(a.float().numpy(), r) < (1e-3 if name in ("dse", "dbe") else 4e-3), name


def _unpool_bwd_by_pieces(x, se, be, k, v, wq, wo, g, g_sums, heads, residual=True,
                          prenorm=True):
    """The Hopper unpool backward's plain pieces in the kernels' order: the
    fold, the point-wise passes, the weight-gradient products and the
    chain to the weights."""
    kft, vf = tfa._unpool_bwd_fold_ref(k, v, wq, wo, heads)
    p, ds, d_attn, dx, dse, dbe = tfa._unpool_bwd_tiles_ref(x, se, be, kft, vf, g, g_sums, heads,
                                                            residual, prenorm)
    dkf, dvf = tfa._unpool_bwd_wgrad_ref(x, se, be, p, ds, d_attn, prenorm)
    return (dx, dse, dbe, *tfa._chain_unpool(dkf, dvf, k, v, wq, wo, heads))


UNPOOL_GRADS = ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo")
POOL_GRADS = ("dx", "dse", "dbe", "dind2", "dkvw", "dwo")


@pytest.mark.parametrize("residual,prenorm", [(True, True), (False, False), (True, False),
                                              (False, True)])
def test_unpool_bwd_pieces_compose_to_the_plain_backward_in_fp32(residual, prenorm):
    """In fp32 (every bf16 rounding of the kernels' algebra a no-op) the
    pieces compose to autograd of the plain version, drifted logits and
    a nonzero sums cotangent, within 1e-5 of each gradient's max |ref|, in
    each flag variant (dse and dbe are 0 without the pre-norm)."""
    ops = [torch.from_numpy(a) for a in _unpool_args(18, True)]
    rng = np.random.default_rng(19)
    g = torch.from_numpy(_cotangent(rng, B, N, C))
    g_sums = torch.from_numpy(_cotangent(rng, B, 2, C, scale=1e-2))
    got = _unpool_bwd_by_pieces(*ops, g, g_sums, HEADS, residual, prenorm)
    want = tfa._unpool_bwd_ref(*ops, g, g_sums, HEADS, residual, prenorm)
    for name, a, r in zip(UNPOOL_GRADS, got, want):
        if prenorm or name not in ("dse", "dbe"):
            assert _maxrel(a.numpy(), r.numpy()) < 1e-5, name
        else:
            assert not a.any() and not r.any(), name


def test_unpool_bwd_pieces_match_the_jax_kernel_in_bf16():
    """On bf16 operands with drifted logits the pieces are the JAX
    kernel's algebra (kft, vf, p, d_attn and ds rounded to bf16): against
    ``jax.vjp`` of the JAX op (its Pallas backward in interpret mode, run
    as one ``jax.jit``) every gradient agrees within 1e-3 of max |ref|."""
    bf = torch.bfloat16
    args = _unpool_args(20, True)
    rng = np.random.default_rng(21)
    g = _cotangent(rng, B, N, C)
    g_sums = _cotangent(rng, B, 2, C, scale=1e-2)
    ops = [torch.from_numpy(a).to(torch.float32 if q in (1, 2) else bf)
           for q, a in enumerate(args)]
    got = _unpool_bwd_by_pieces(*ops, torch.from_numpy(g).to(bf), torch.from_numpy(g_sums),
                                HEADS)
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, c: jax.vjp(lambda *q: jfa.folded_unpool(*q, HEADS), *a)[1](c))(
        jops, (jnp.asarray(g, jnp.bfloat16), jnp.asarray(g_sums)))
    for name, a, r in zip(UNPOOL_GRADS, got, ref):
        assert _maxrel(a.float().numpy(), np.asarray(r, np.float32)) < 1e-3, name


# the head layouts that the Hopper pool and unpool backwards take on the
# card beyond the base one above (C 64, four heads of 16): the upsample
# demo's four heads of 32, and three heads of 32 and of 128 channels (J 192
# at 64 inducers: the weight gradients' 64-column and 64-row tails on the
# card); (C, H, I, B, N), at a small B and N
BWD_LAYOUTS = {"demo": (128, 4, 64, 2, 128), "heads3-D32": (96, 3, 64, 2, 128),
               "heads3-D128": (384, 3, 64, 1, 128)}


def _layout_args(seed, which, layout, drift):
    """Pool or unpool operands at a ``BWD_LAYOUTS`` layout; drifted as
    ``DRIFT`` per head (60, 1, 0.1, 0.01 in turn)."""
    c, heads, i, b, n = BWD_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    scale = np.resize(np.array([60.0, 1.0, 0.1, 0.01], np.float32), heads).repeat(c // heads)
    x, se, be = r(b, n, c), 1.0 + 0.1 * r(b, c), 0.1 * r(b, c)
    if which == "pool":
        kvw = r(2 * c, c) / c**0.5
        if drift:
            kvw[:c] *= scale[:, None]
        return x, se, be, r(heads * i, c // heads), kvw, r(c, c) / c**0.5
    k = r(b, i, c)
    if drift:
        k *= scale
    return x, se, be, k, r(b, i, c), r(c, c) / c**0.5, r(c, c) / c**0.5


def _layout_cotangents(seed, which, layout):
    c, _, i, b, n = BWD_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    if which == "pool":
        return (_cotangent(rng, b, i, c),)
    return _cotangent(rng, b, n, c), _cotangent(rng, b, 2, c, scale=1e-2)


def _layout_pieces(which, ops, cots, heads):
    if which == "pool":
        return _pool_bwd_by_pieces(*ops, *cots, heads)
    return _unpool_bwd_by_pieces(*ops, *cots, heads)


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
@pytest.mark.parametrize("layout", list(BWD_LAYOUTS))
@pytest.mark.parametrize("which", ["pool", "unpool"])
def test_bwd_pieces_compose_to_the_plain_backward_at_the_hopper_layouts(which, layout, drift):
    """At the demo's four heads of 32 and at three heads (of 32 and of 128
    channels), the layouts the Hopper pool and unpool backwards open on the
    card: in fp32 the pieces compose to autograd of the plain version
    within 1e-5 of each gradient's max |ref|, as at the base layout
    (``test_pool_bwd_pieces_compose_to_the_plain_backward_in_fp32``,
    ``test_unpool_bwd_pieces_compose_to_the_plain_backward_in_fp32``); with
    drifted logits (in the hundreds at these widths) within 2e-5, the fp32
    rounding of a logit's share that ``_close_grads`` allows a drifted
    gradient."""
    heads = BWD_LAYOUTS[layout][1]
    ops = [torch.from_numpy(a) for a in _layout_args(41, which, layout, drift)]
    cots = [torch.from_numpy(a) for a in _layout_cotangents(42, which, layout)]
    got = _layout_pieces(which, ops, cots, heads)
    if which == "pool":
        want, names = tfa._pool_ext_bwd_ref(*ops, *cots, heads), POOL_GRADS
    else:
        want, names = tfa._unpool_bwd_ref(*ops, *cots, heads), UNPOOL_GRADS
    for name, a, r in zip(names, got, want):
        assert _maxrel(a.numpy(), r.numpy()) < (2e-5 if drift else 1e-5), name


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
@pytest.mark.parametrize("layout", list(BWD_LAYOUTS))
@pytest.mark.parametrize("which", ["pool", "unpool"])
def test_bwd_pieces_match_the_jax_kernels_at_the_hopper_layouts(which, layout, drift):
    """At the same layouts, on bf16 operands, the pieces are the JAX
    kernels' algebra (the pool's v3, whose mode the JAX package picks
    there): against ``jax.vjp`` of the JAX op (its Pallas backward in
    interpret mode, one ``jax.jit``) the fp32 gradients (dse, dbe) within
    1e-3 of max |ref|, the bf16 ones element by element within one bf16
    step and 1e-3 of max |ref| (``_within_a_bf16_step``, as at the demo's
    width in ``test_demo_width_gradients_match_the_jax_ops``). With drifted
    logits (in the hundreds at D 128) both limits are 2e-3: there the two
    sides' fp32 sums, in other orders, flip the bf16 roundings of e and ds
    on a few points, and the pool's dx, dse and dind2 read up to 1.9e-3 at
    three heads of 128 (autograd of the plain version departs 2-8%)."""
    bf = torch.bfloat16
    c, heads, i, b, n = BWD_LAYOUTS[layout]
    args = _layout_args(43, which, layout, drift)
    cots = _layout_cotangents(44, which, layout)
    if which == "pool":
        assert jfa._pool_bwd_mode(n, c, heads * i, c // heads) == "v3"
        low, fn, names = (0, 3, 4, 5), jfa.folded_pool_ext, POOL_GRADS
        tcots = [torch.from_numpy(cots[0]).to(bf)]
        jcot = jnp.asarray(cots[0], jnp.bfloat16)
    else:
        low, fn, names = (0, 3, 4, 5, 6), jfa.folded_unpool, UNPOOL_GRADS
        tcots = [torch.from_numpy(cots[0]).to(bf), torch.from_numpy(cots[1])]
        jcot = (jnp.asarray(cots[0], jnp.bfloat16), jnp.asarray(cots[1]))
    ops = [torch.from_numpy(a).to(bf if q in low else torch.float32) for q, a in enumerate(args)]
    got = _layout_pieces(which, ops, tcots, heads)
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, g: jax.vjp(lambda *q: fn(*q, heads), *a)[1](g))(jops, jcot)
    tol = 2e-3 if drift else 1e-3
    for name, a, r in zip(names, got, ref):
        if a.dtype == torch.float32:
            assert _maxrel(a.numpy(), np.asarray(r, np.float32)) < tol, name
        else:
            assert _within_a_bf16_step(a.float().numpy(), r, tol), name


def _mlp_fwd_by_pieces(x, se, be, w1t, b1, w2t, b2):
    """The Hopper MLP forward's plain pieces in the kernels' order: the
    pre-norm, the first pass (g), the output pass and its sums."""
    g = tfa._mlp_act_ref(tfa._prenormed(x, se, be).to(x.dtype), w1t, b1)
    return tfa._mlp_out_ref(x, g, w2t, b2)


def _mlp_bwd_by_pieces(x, se, be, w1t, b1, w2t, b2, g, g_sums):
    """The Hopper MLP backward's plain pieces in the kernels' order: the
    pre-norm; walk 1 (a, then o and g' with db2); walk 2 (dh with db1,
    then dy: dx, dse, dbe); the two weight-gradient products."""
    y = tfa._prenormed(x, se, be).to(x.dtype)
    a = tfa._mlp_act_ref(y, w1t, b1)
    gp, gb, db2 = tfa._mlp_bwd_grad_ref(x, a, w2t, b2, g, g_sums)
    dh, db1 = tfa._mlp_bwd_dh_ref(y, w1t, b1, w2t, gb)
    dx, dse, dbe = tfa._mlp_bwd_dx_ref(x, se, w1t, dh, gp)
    dw1t, dw2t = tfa._mlp_bwd_wgrad_ref(y, a, dh, gb)
    return dx, dse, dbe, dw1t, db1, dw2t, db2


MLP_GRADS = ("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2")


def _mlp_drift_args(seed):
    """The MLP's operands with the stream scaled per channel (60, 1, 0.1,
    0.01 in turn, divided by 10) as the drift case of the backward test."""
    args = list(_mlp_args(seed))
    args[0] = args[0] * DRIFT[None, None, :] / 10
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_pieces_compose_to_the_plain_version(dtype):
    """The Hopper MLP forward's pieces compose to ``_mlp_ref``: in fp32
    within 1e-5 of max |ref|; in bf16 (the same roundings: y, g, the
    output) within 1e-3 of max |ref| for out, 1e-5 for the fp32 sums."""
    dt = getattr(torch, dtype)
    ops = [torch.from_numpy(a).to(dt if q in (0, 3, 5) else torch.float32)
           for q, a in enumerate(_mlp_drift_args(24))]
    (out, sums), (r_out, r_sums) = _mlp_fwd_by_pieces(*ops), tfa._mlp_ref(*ops)
    assert _maxrel(out.float().numpy(), r_out.float().numpy()) < (1e-5 if dtype == "float32"
                                                                   else 1e-3)
    assert _maxrel(sums.numpy(), r_sums.numpy()) < 1e-5


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_mlp_bwd_pieces_compose_to_the_plain_backward_in_fp32(drift):
    """In fp32 (every bf16 rounding of the kernels' algebra a no-op) the
    Hopper MLP backward's pieces compose to autograd of the plain version,
    a nonzero sums cotangent, within 1e-5 of each gradient's max |ref|."""
    ops = [torch.from_numpy(a) for a in (_mlp_drift_args(25) if drift else _mlp_args(25))]
    rng = np.random.default_rng(26)
    g = torch.from_numpy(_cotangent(rng, B, N, C))
    g_sums = torch.from_numpy(_cotangent(rng, B, 2, C, scale=1e-2))
    got = _mlp_bwd_by_pieces(*ops, g, g_sums)
    want = tfa._mlp_bwd_ref(*ops, g, g_sums)
    for name, a, r in zip(MLP_GRADS, got, want):
        assert _maxrel(a.numpy(), r.numpy()) < 1e-5, name


def test_mlp_bwd_pieces_match_the_jax_kernel_in_bf16():
    """On bf16 operands with a drifted stream and a nonzero sums cotangent
    the pieces are the JAX kernel's algebra (y, bf16(a), bf16(g') and
    bf16(dh) rounded as ``_mlp_bwd_kernel`` rounds them): against
    ``jax.vjp`` of the JAX op (its Pallas backward in interpret mode, run
    as one ``jax.jit``) the bf16 gradients (dx, dw1t and dw2t, the last two
    rounded to bf16 as the wrapper rounds them) element by element within
    one bf16 step (both round the same fp32 algebra, summed in other
    orders), the fp32 ones (dse, dbe, db1, db2) within 1e-3 of max |ref|."""
    bf = torch.bfloat16
    args = _mlp_drift_args(27)
    rng = np.random.default_rng(28)
    g = _cotangent(rng, B, N, C)
    g_sums = _cotangent(rng, B, 2, C, scale=1e-2)
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 5) else torch.float32)
           for q, a in enumerate(args)]
    got = _mlp_bwd_by_pieces(*ops, torch.from_numpy(g).to(bf), torch.from_numpy(g_sums))
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    ref = jax.jit(lambda a, c: jax.vjp(jfa.fused_mlp_residual, *a)[1](c))(
        jops, (jnp.asarray(g, jnp.bfloat16), jnp.asarray(g_sums)))
    for name, a, r in zip(MLP_GRADS, got, ref):
        if r.dtype == jnp.bfloat16:
            # dx, dw1t, dw2t: bf16 in both (the wrapper casts dw1t and dw2t
            # to the weights' dtype, as jax.vjp returns them)
            assert _within_a_bf16_step(a.to(bf).float().numpy(), r), name
        else:
            assert _maxrel(a.numpy(), np.asarray(r)) < 1e-3, name


# the upsample demo's widths (scripts/demo_upsample_100k.py: C 128, 4 heads
# of 32 channels), at a small point count and 16 inducers
DEMO_C, DEMO_HEADS, DEMO_I, DEMO_N = 128, 4, 16, 128


def _demo_args(seed, which):
    rng = np.random.default_rng(seed)
    c, i = DEMO_C, DEMO_I
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, se, be = r(B, DEMO_N, c), 1.0 + 0.1 * r(B, c), 0.1 * r(B, c)
    if which == "pool":
        return (x, se, be, r(DEMO_HEADS * i, c // DEMO_HEADS), r(2 * c, c) / c**0.5,
                r(c, c) / c**0.5)
    if which == "unpool":
        return x, se, be, r(B, i, c), r(B, i, c), r(c, c) / c**0.5, r(c, c) / c**0.5
    w = 2 * c
    return x, se, be, r(c, w) / c**0.5, 0.1 * r(1, w), r(w, c) / w**0.5, 0.1 * r(1, c)


def _within_a_bf16_step(a, ref, slack=1e-3) -> bool:
    """Every element of ``a`` within one bf16 step (2^-7 of its binade's
    base, the spacing at ``ref``'s magnitude) of ``ref``, plus ``slack`` of
    max |ref|: two bf16 results of one algebra summed in other fp32 orders
    may round apart by a step, now and then."""
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    mag = np.abs(ref)
    step = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7.0)
    return bool(np.all(np.abs(a - ref) <= step + slack * mag.max()))


@pytest.mark.parametrize("which", ["pool", "unpool", "mlp"])
def test_demo_width_gradients_match_the_jax_ops(which):
    """At the upsample demo's widths (C 128, 4 heads, D 32), the widths
    the backwards' WMMA bodies and the MLP backward's C 128 instance open
    on the card: the pool's v3 pieces (the algebra both its bodies keep)
    and the unpool's pieces on bf16 operands against ``jax.vjp`` of the
    JAX op (its Pallas backward in interpret mode, one ``jax.jit``): the
    fp32 gradients (dse, dbe) within 1e-3 of max |ref|, the bf16 ones
    element by element within one bf16 step (both round the same fp32
    algebra, summed in other orders; at this width a step apart in a few
    elements of a few thousand). The MLP's gradients (autograd of its plain
    version on the CPU) in fp32 at the MLP backward test's tolerance."""
    bf = torch.bfloat16
    args = _demo_args(22, which)
    rng = np.random.default_rng(23)
    if which == "mlp":
        g = [_cotangent(rng, B, DEMO_N, DEMO_C), _cotangent(rng, B, 2, DEMO_C, scale=1e-2)]
        port = _port_grads(tfa.fused_mlp_residual, args, g)
        ref = jax.jit(lambda a, c: _jax_grads(jfa.fused_mlp_residual, a, c))(args, g)
        _close_grads(port, ref, rtol=2e-4, atol=2e-4)
        return
    low = (0, 3, 4, 5) if which == "pool" else (0, 3, 4, 5, 6)
    ops = [torch.from_numpy(a).to(bf if q in low else torch.float32) for q, a in enumerate(args)]
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    if which == "pool":
        assert jfa._pool_bwd_mode(DEMO_N, DEMO_C, DEMO_HEADS * DEMO_I,
                                  DEMO_C // DEMO_HEADS) == "v3"
        g = _cotangent(rng, B, DEMO_I, DEMO_C)
        got = _pool_bwd_by_pieces(*ops, torch.from_numpy(g).to(bf), DEMO_HEADS)
        cot = jnp.asarray(g, jnp.bfloat16)
        fn, names = jfa.folded_pool_ext, ("dx", "dse", "dbe", "dind2", "dkvw", "dwo")
    else:
        g = _cotangent(rng, B, DEMO_N, DEMO_C)
        g_sums = _cotangent(rng, B, 2, DEMO_C, scale=1e-2)
        got = _unpool_bwd_by_pieces(*ops, torch.from_numpy(g).to(bf), torch.from_numpy(g_sums),
                                    DEMO_HEADS)
        cot = (jnp.asarray(g, jnp.bfloat16), jnp.asarray(g_sums))
        fn, names = jfa.folded_unpool, UNPOOL_GRADS
    ref = jax.jit(lambda a, c: jax.vjp(lambda *q: fn(*q, DEMO_HEADS), *a)[1](c))(jops, cot)
    for name, a, r in zip(names, got, ref):
        if a.dtype == torch.float32:
            assert _maxrel(a.numpy(), np.asarray(r, np.float32)) < 1e-3, name
        else:
            assert _within_a_bf16_step(a.float().numpy(), r), name


def _demo_forward_args(seed, which, i, drift):
    """Operands of the pool or unpool forward at the upsample demo's widths
    (C 128, 4 heads of 32 channels) with ``i`` inducers and N 256; drifted
    per head as ``DRIFT`` (head 0's logits ~60x head 1's)."""
    c, heads = DEMO_C, DEMO_HEADS
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, se, be = r(B, 2 * DEMO_N, c), 1.0 + 0.1 * r(B, c), 0.1 * r(B, c)
    drift_c = np.repeat(np.array([60.0, 1.0, 0.1, 0.01], np.float32), c // heads)
    if which == "pool":
        kvw = r(2 * c, c) / c**0.5
        if drift:
            kvw[:c] *= drift_c[:, None]
        return x, se, be, r(heads * i, c // heads), kvw, r(c, c) / c**0.5
    k = r(B, i, c)
    if drift:
        k *= drift_c[None, None, :]
    return x, se, be, k, r(B, i, c), r(c, c) / c**0.5, r(c, c) / c**0.5


def _demo_forward_pieces(which, ops):
    """The plain pieces of the Hopper pool (the fold, the chunk partials at
    ``_POOL_CHUNK`` points, the merge) or unpool (the fold, the point
    tiles), composed -> h0, or (out, sums)."""
    if which == "pool":
        x, se, be, ind2, kvw, wo = ops
        qft = tfa._fold_qft_ref(ind2, kvw, DEMO_HEADS)
        m, l, p = tfa._pool_partials_ref(x, se, be, qft, kvw, DEMO_HEADS)
        assert p.shape == (B, x.shape[1] // tfa._POOL_CHUNK, ind2.shape[0], DEMO_C // DEMO_HEADS)
        return (tfa._pool_merge_ref(m, l, p, wo, DEMO_HEADS)[0],)
    x, se, be, k, v, wq, wo = ops
    kft, vft, brow = tfa._unpool_fold_ref(se, be, k, v, wq, wo, DEMO_HEADS)
    return tfa._unpool_tiles_ref(x, kft, vft, brow, DEMO_HEADS)


@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
@pytest.mark.parametrize("i", [64, 16], ids=["I64", "I16"])
@pytest.mark.parametrize("which", ["pool", "unpool"])
def test_demo_width_forward_pieces_match_the_plain_and_jax_kernels(which, i, drift):
    """At the upsample demo's widths (C 128, 4 heads of 32 channels), which
    the Hopper pool and unpool forwards take on the card: their plain
    pieces compose to the plain version and match the JAX kernel
    (``folded_pool_ext`` / ``folded_unpool``, its Pallas kernel in
    interpret mode, one ``jax.jit``) on ordinary and drifted operands, at
    the tolerances of ``test_pool_pieces_compose_to_the_plain_version`` and
    ``test_unpool_pieces_compose_to_the_plain_version``: in fp32 to
    rounding, in bf16 within a few bf16 steps. The unpool's drifted bf16
    case is held to the JAX kernel alone: its pieces fold se into wq before
    the rounding, as the TPU kernel does, and the plain version after it
    (a departure of ~8e-2 there, by design, as in that test)."""
    args = _demo_forward_args(31, which, i, drift)
    low = (0, 3, 4, 5) if which == "pool" else (0, 3, 4, 5, 6)
    ref_fn = tfa._pool_ext_ref if which == "pool" else tfa._unpool_ref
    jax_fn = jfa.folded_pool_ext if which == "pool" else jfa.folded_unpool
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        ops = [torch.from_numpy(a).to(dt if q in low else torch.float32)
               for q, a in enumerate(args)]
        got = _demo_forward_pieces(which, ops)
        plain = ref_fn(*ops, DEMO_HEADS)
        plain = plain if isinstance(plain, tuple) else (plain,)
        jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == torch.bfloat16
                            else jnp.float32) for a in ops]
        ref = jax.jit(lambda *a: jax_fn(*a, DEMO_HEADS))(*jops)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if dtype == "bfloat16":
            tol = 2e-2
        else:
            tol = 1e-5 if which == "pool" else 1e-4
        by_design = which == "unpool" and drift and dtype == "bfloat16"
        for q, (a, p_, r) in enumerate(zip(got, plain, ref)):
            a = a.float().numpy()
            if not by_design:
                assert _maxrel(a, p_.float().numpy()) < tol, (dtype, q, "plain")
            assert _maxrel(a, np.asarray(r, np.float32)) < tol, (dtype, q, "jax")
