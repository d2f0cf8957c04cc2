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
from gecco_tpu_torch.ops.kernels.induced_attention import rect_attention_pallas
from gecco_tpu_torch.ops.kernels.projective_gather import (
    _gather_ref,
    projective_gather,
    projective_gather_bwd,
)

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
        "projective_gather": 0, "rect_attention_fwd": 0, "fused_unpool_mlp": 0,
        "folded_pool_layer": 0, "folded_pool_ext_bwd": 0, "folded_unpool_bwd": 0,
        "fused_mlp_residual_bwd": 0, "projective_gather_bwd": 0, "rect_attention_bwd": 0,
        "folded_pool_layer_bwd": 0, "folded_pool_ext_wmma": 0, "folded_unpool_wmma": 0,
        "folded_pool_ext_bwd_wmma": 0, "folded_unpool_bwd_wmma": 0,
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


# (B, N, C, H, I) -> the bodies of the pool forward and the unpool forward,
# and of the pool, unpool and MLP backwards (the MLP at W = 2C; None where
# that function raises for the shape)
@pytest.mark.parametrize("shape,bodies,bwd", [
    ((48, 2048, 384, 8, 64), ("hopper", "hopper"), ("hopper", "hopper", "wmma")),  # the flagship
    ((2, 8192, 768, 16, 64), ("hopper", "hopper"), ("hopper", "hopper", "wmma")),  # the 8k width
    ((48, 2048, 128, 4, 64), ("wmma", "wmma"), ("wmma", "hopper", "wmma")),  # the demo's 3 x 128
    ((48, 2048, 384, 3, 64), ("wmma", "wmma"), ("wmma", "wmma", "wmma")),  # num_heads=3
    ((48, 2000, 384, 8, 64), (None, None), (None, None, None)),  # N not a multiple of 64
], ids=["flagship", "8k", "demo", "heads3", "none"])
def test_body_switches_choose_by_shape(shape, bodies, bwd):
    """The pool and unpool forwards and backwards pick one of their two
    CUDA bodies by shape alone, and a shape that neither takes raises
    ValueError naming both bodies' conditions; the MLP backward's one body
    takes the demo's and the three-head flagship's widths, and a shape it
    does not take raises ValueError naming its conditions."""
    b, n, c = shape[:3]
    switches = ((tfa._pool_ext_body, shape), (tfa._unpool_body, shape),
                (tfa._pool_ext_bwd_body, shape), (tfa._unpool_bwd_body, shape),
                (tfa._mlp_bwd_body, (b, n, c, 2 * c)))
    for (switch, args), want in zip(switches, bodies + bwd):
        if want is None:
            match = "WMMA body needs" if switch is tfa._mlp_bwd_body else "Hopper body .* WMMA body"
            with pytest.raises(ValueError, match=match):
                switch(*args)
        else:
            assert switch(*args) == want


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
