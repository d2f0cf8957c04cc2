"""The fp32 route of the set transformer's kernels (``ops/kernels/f32.py``,
``csrc/f32_simt.cu``) on the CPU.

Every fused function of the port has, beside its bf16 Hopper and WMMA
bodies, an fp32 route: a chain of five SIMT kernels in the order of the
function's plain pieces. On CPU tensors each kernel's wrapper runs its
plain piece, so calling a route here composes the plain pieces. The cases
hold that chain against the wrapper's plain version at fp32 (rtol 1e-5) and
against the JAX package's Pallas kernel run at fp32 in interpret mode
(forward and ``jax.vjp`` in one ``jax.jit``) at the JAX tests' tolerance,
rtol 1e-4 and atol 1e-5, the absolute one 2e-5 of max |ref| on drifted
operands. The switches pick ``"f32"`` for fp32 operands, the old bodies for
bf16 ones, and raise for mixed dtypes. The kernels themselves run on the
card, where ``chip_smoke.py`` (phase 25) holds each route against its plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu.ops.pallas import hside as jhs
from gecco_tpu.ops.pallas.induced_attention import rect_attention_pallas as jrect
from gecco_tpu_torch.ops.kernels import f32
from gecco_tpu_torch.ops.kernels import folded_attention as tfa
from gecco_tpu_torch.ops.kernels import hside as ths
from gecco_tpu_torch.ops.kernels import induced_attention as tia

RTOL, ATOL = 1e-4, 1e-5
B, N, C, HEADS, I, GROUPS = 2, 128, 64, 4, 16, 8
W = 2 * C
D = C // HEADS
# per-head logit scales of the drifted operands (test_torch_kernels.py's)
DRIFT = np.repeat(np.array([60.0, 1.0, 0.1, 0.01], np.float32), C // HEADS)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _args(case: str, drift: bool, seed: int = 0) -> tuple:
    """numpy operands of one function at fp32."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, N, C)
    se, be = _rand(rng, B, C, scale=0.1, shift=1.0), _rand(rng, B, C, scale=0.1)
    wo = _rand(rng, C, C, scale=C**-0.5)
    if case in ("pool_ext", "pool_layer", "pool_layer_raw"):
        kvw = _rand(rng, 2 * C, C, scale=C**-0.5)
        if drift:
            kvw[:C] *= DRIFT[:, None]
        ind2 = _rand(rng, HEADS * I, D)
        if case == "pool_ext":
            return x, se, be, ind2, kvw, wo
        return x, se, be, ind2, kvw, wo, np.array(jfa.group_indicator(C, GROUPS))
    mlp = (_rand(rng, C, W, scale=C**-0.5), _rand(rng, 1, W, scale=0.1),
           _rand(rng, W, C, scale=W**-0.5), _rand(rng, 1, C, scale=0.1))
    if case == "mlp":
        return (x, se, be, *mlp)
    if case == "hside":
        aff = [_rand(rng, B, C, scale=0.2, shift=1.0 - q % 2) for q in range(4)]
        return (_rand(rng, B, I, C), *aff, np.array(jfa.group_indicator(C, GROUPS)), *mlp,
                _rand(rng, C, C, scale=C**-0.5), _rand(rng, C, C, scale=C**-0.5))
    k = _rand(rng, B, I, C)
    if drift:
        k *= DRIFT[None, None, :]
    unpool = (x, se, be, k, _rand(rng, B, I, C), _rand(rng, C, C, scale=C**-0.5), wo)
    if case == "unpool":
        return unpool
    sc2, bi2 = _rand(rng, B, C, scale=0.2, shift=1.0), _rand(rng, B, C, scale=0.2)
    return (*unpool, sc2, bi2, np.array(jfa.group_indicator(C, GROUPS)), *mlp)


def _rect_args(direction: str, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    m, n = (I, N) if direction == "pool" else (N, I)
    return _rand(rng, B, HEADS, m, D), _rand(rng, B, HEADS, n, D), _rand(rng, B, HEADS, n, D)


def _cotangents(case: str, seed: int = 1) -> tuple:
    rng = np.random.default_rng(seed)
    if case in ("pool_ext",):
        return (_rand(rng, B, I, C),)
    if case in ("pool_layer", "pool_layer_raw"):
        return _rand(rng, B, I, C), _rand(rng, B, C), _rand(rng, B, C)
    return _rand(rng, B, N, C), _rand(rng, B, 2, C, scale=1e-2)


def _jax_fwd_vjp(fn, args, cot):
    """fn's outputs and its vjp against ``cot``, one ``jax.jit``."""
    def run(args, cot):
        out, back = jax.vjp(fn, *args)
        return out, back(cot if isinstance(out, tuple) else cot[0])
    out, grads = jax.jit(run)(tuple(map(jnp.asarray, args)), tuple(map(jnp.asarray, cot)))
    return (out if isinstance(out, tuple) else (out,)), grads


def _check(got, ref, drift: bool, what: str, rtol=RTOL, atol=ATOL, drift_share=2e-5):
    for q, (a, r) in enumerate(zip(got, ref)):
        r = np.asarray(r, np.float32)
        tol = max(atol, drift_share * float(np.abs(r).max())) if drift else atol
        np.testing.assert_allclose(np.asarray(a, np.float32), r, rtol=rtol, atol=tol,
                                   err_msg=f"{what}: output {q}")


def _route(case: str, args, cot) -> tuple:
    """(outputs, gradients) of the fp32 route's chained plain pieces, the
    gradients in the wrappers' argument order (the folded operands chained
    to the weights as the wrappers chain them)."""
    t = [torch.from_numpy(a) for a in args]
    g = [torch.from_numpy(a) for a in cot]
    if case == "pool_ext":
        x, se, be, ind2, kvw, wo = t
        h0, qft, m, l = f32.pool_ext_fwd(x, se, be, ind2, kvw, wo, HEADS)
        dx, dse, dbe, dqf, dwv, dwo = f32.pool_ext_bwd(x, se, be, qft, kvw, wo, m, l, g[0],
                                                       HEADS)
        return (h0,), (dx, dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, HEADS), dwo)
    if case in ("pool_layer", "pool_layer_raw"):
        x, sc, bi, ind2, kvw, wo, _ = t
        pre = case == "pool_layer"
        h0, mean, inv, saved = f32.pool_layer_fwd(x, sc, bi, ind2, kvw, wo, GROUPS, HEADS, pre)
        dx, dsc, dbi, dqf, dwv, dwo = f32.pool_layer_bwd(
            x, sc, ind2, kvw, wo, GROUPS, mean, inv, *saved, *g, HEADS, pre)
        outs = (h0, mean, inv) if pre else (h0,)
        return outs, (dx, dsc, dbi, *tfa._chain_dqf(dqf, dwv, ind2, kvw, HEADS), dwo)
    if case == "unpool":
        x, se, be, k, v, wq, wo = t
        outs = f32.unpool_fwd(x, se, be, k, v, wq, wo, HEADS, True, True)
        dx, dse, dbe, dkf, dvf = f32.unpool_bwd(x, se, be, k, v, wq, wo, *g, HEADS, True, True)
        return outs, (dx, dse, dbe, *tfa._chain_unpool(dkf, dvf, k, v, wq, wo, HEADS))
    if case == "mlp":
        return f32.mlp_fwd(*t), f32.mlp_bwd(*t, *g)
    raise ValueError(case)


def _jax_fn(case: str):
    if case == "pool_ext":
        return lambda *a: jfa.folded_pool_ext(*a, HEADS)
    if case == "pool_layer":
        return lambda *a: jfa.folded_pool_layer(*a, HEADS, True)
    if case == "pool_layer_raw":
        return lambda *a: jfa.folded_pool_layer(*a, HEADS, False)[0]
    if case == "unpool":
        return lambda *a: jfa.folded_unpool(*a, HEADS)
    return jfa.fused_mlp_residual


def _plain(case: str, args, cot) -> tuple:
    """The wrappers' plain versions: outputs and autograd gradients."""
    t = [torch.from_numpy(a) for a in args]
    g = [torch.from_numpy(a) for a in cot]
    if case == "pool_ext":
        return (tfa._pool_ext_ref(*t, HEADS),), tfa._pool_ext_bwd_ref(*t, *g, HEADS)
    if case in ("pool_layer", "pool_layer_raw"):
        pre = case == "pool_layer"
        outs = tfa._pool_ref(*t[:6], GROUPS, HEADS, pre)
        return (outs if pre else outs[:1]), tfa._pool_layer_bwd_ref(*t, *g, HEADS, pre)
    if case == "unpool":
        return tfa._unpool_ref(*t, HEADS), tfa._unpool_bwd_ref(*t, *g, HEADS)
    return tfa._mlp_ref(*t), tfa._mlp_bwd_ref(*t, *g)


# the JAX package's own backward tests' tolerances (test_pallas_ops.py, as
# test_torch_kernels.py holds the plain versions to them)
BWD_TOL = {"pool_ext": (5e-4, 5e-5), "pool_layer": (5e-4, 5e-5), "unpool": (3e-4, 3e-5),
           "mlp": (2e-4, 2e-4)}
CASES = [("pool_ext", False), ("pool_ext", True), ("pool_layer", False),
         ("pool_layer_raw", False), ("unpool", False), ("unpool", True), ("mlp", False)]


@pytest.mark.parametrize("case,drift", CASES, ids=[f"{c}-{'drift' if d else 'plain'}"
                                                  for c, d in CASES])
def test_route_matches_the_plain_version_and_the_jax_kernel(case, drift):
    """The route's chain against the plain version (rtol 1e-5) and against
    the JAX kernel at fp32 in interpret mode, forward and backward."""
    args = _args(case, drift, seed=len(case))
    if case == "mlp" and drift:
        args = (args[0] * DRIFT / 10, *args[1:])
    cot = _cotangents(case)
    outs, grads = _route(case, args, cot)
    p_outs, p_grads = _plain(case, args, cot)
    _check(outs, [o.numpy() for o in p_outs], drift, "route vs plain", rtol=1e-5)
    _check(grads, [q.numpy() for q in p_grads], drift, "route grads vs plain", rtol=1e-5)
    if case == "pool_layer_raw":  # JAX's gind takes a zero gradient; the port's none
        args = args[:6] + (args[6],)
    j_outs, j_grads = _jax_fwd_vjp(_jax_fn(case), args, cot[:1] if case == "pool_layer_raw"
                                   else cot)
    # sums of N squared values of ~1: the JAX tests' rtol/atol 1e-3
    loose = {1} if case in ("unpool", "mlp") else set()
    _check([o for q, o in enumerate(outs) if q not in loose],
           [o for q, o in enumerate(j_outs) if q not in loose], drift, "route vs JAX",
           atol=1e-4 if drift else ATOL)
    for q in loose:
        np.testing.assert_allclose(outs[q].numpy(), np.asarray(j_outs[q]), rtol=1e-3,
                                   atol=1e-3)
    n_grads = 6 if case.startswith("pool") else len(grads)
    rtol, atol = BWD_TOL[case.split("_raw")[0]]
    # on drifted operands the plain version's own dind2 lies 4.0e-5 of max
    # |ref| from the JAX kernel's here (fp32 rounding of logits in the
    # hundreds), the route's no farther
    _check(grads[:n_grads], j_grads[:n_grads], drift, "route grads vs JAX", rtol, atol,
           drift_share=5e-5)


@pytest.mark.parametrize("direction", ["pool", "unpool"])
def test_rect_route_matches_the_plain_version_and_the_jax_kernel(direction):
    """``f32.rect_fwd`` and ``f32.rect_bwd`` (delta from the fp32 o)
    against the plain version and autograd through it (rtol 1e-5), and
    against the JAX kernel at fp32 in interpret mode, forward and vjp."""
    args = _rect_args(direction)
    g = _rand(np.random.default_rng(5), *args[0].shape)
    q, k, v = map(torch.from_numpy, args)
    o, lse = f32.rect_fwd(q, k, v)
    grads = f32.rect_bwd(q, k, v, o, lse, torch.from_numpy(g))
    ref_o, ref_lse = tia._rect_attention_ref(q, k, v)
    _check((o, lse), (ref_o.numpy(), ref_lse.numpy()), False, "rect vs plain", 1e-5)
    _check(grads, [t.numpy() for t in tia._rect_attention_bwd_ref(q, k, v, torch.from_numpy(g))],
           False, "rect grads vs plain", 1e-5)
    j_out, j_grads = _jax_fwd_vjp(jrect, args, (g,))
    _check((o,), j_out, False, "rect vs JAX")
    _check(grads, j_grads, False, "rect grads vs JAX")


def test_rect_route_reads_a_broadcast_batch_in_place():
    """The pool direction's inducers come as a stride-0 batch view: the
    route reads it in place and returns dq per batch element."""
    q, k, v = map(torch.from_numpy, _rect_args("pool", seed=3))
    qb = q[:1].expand(B, -1, -1, -1)
    o, lse = f32.rect_fwd(qb, k, v)
    ref_o, _ = tia._rect_attention_ref(qb, k, v)
    torch.testing.assert_close(o, ref_o, rtol=1e-5, atol=ATOL)
    g = torch.from_numpy(_rand(np.random.default_rng(4), *qb.shape))
    dq, dk, dv = f32.rect_bwd(qb, k, v, o, lse, g)
    assert dq.shape == qb.shape
    for a, r in zip((dq, dk, dv), tia._rect_attention_bwd_ref(qb, k, v, g)):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=ATOL)


def test_hside_and_megakernel_routes_match_the_plain_versions_and_jax():
    """``f32.hside_fwd`` and the megakernel's route (the unpool's and the
    MLP's in turn) against the plain versions (rtol 1e-5) and the JAX
    kernels at fp32 in interpret mode."""
    hargs = _args("hside", False, seed=7)
    t = [torch.from_numpy(a) for a in hargs]
    got = f32.hside_fwd(*t[:5], GROUPS, *t[6:])
    _check(got, [r.numpy() for r in ths._hside_ref(*t)], False, "hside vs plain", 1e-5)
    margs = _args("unpool_mlp", False, seed=8)
    m = [torch.from_numpy(a) for a in margs]
    xr, sums = f32.unpool_fwd(*m[:7], HEADS, True, True)
    se2, be2 = tfa._affine_from_sums(sums, N, m[7], m[8], GROUPS)
    mega = f32.mlp_fwd(xr, se2, be2, *m[10:])
    ref = tfa._unpool_mlp_ref(*m[:9], *m[10:], HEADS, GROUPS, N)
    _check(mega[:1], [ref[0].numpy()], False, "megakernel vs plain", 1e-5)
    np.testing.assert_allclose(mega[1].numpy(), ref[1].numpy(), rtol=1e-5, atol=1e-4)

    @jax.jit
    def both(h, m):
        return jhs.fused_h_side(*h), jfa.fused_unpool_mlp(*m, HEADS, GROUPS, N)

    j_h, j_m = both(tuple(map(jnp.asarray, hargs)), tuple(map(jnp.asarray, margs)))
    _check(got, j_h, False, "hside vs JAX")
    _check(mega[:1], j_m[:1], False, "megakernel vs JAX")
    np.testing.assert_allclose(mega[1].numpy(), np.asarray(j_m[1]), rtol=1e-3, atol=1e-3)


def _bodies(dtype):
    """Each switch's pick for operands of ``dtype`` at the flagship's
    shapes (B 2, N 2048, C 384, 8 heads, 64 inducers, W 1536)."""
    b, n, c, h, i, w = 2, 2048, 384, 8, 64, 1536
    return {
        "pool_ext": tfa._pool_ext_body(b, n, c, h, i, dtype),
        "pool_ext_bwd": tfa._pool_ext_bwd_body(b, n, c, h, i, dtype),
        "pool_layer": tfa._pool_layer_body(b, n, c, h, i, dtype),
        "pool_layer_bwd": tfa._pool_layer_bwd_body(b, n, c, h, i, dtype),
        "unpool": tfa._unpool_body(b, n, c, h, i, dtype),
        "unpool_bwd": tfa._unpool_bwd_body(b, n, c, h, i, dtype),
        "mlp": tfa._mlp_body(b, n, c, w, dtype),
        "mlp_bwd": tfa._mlp_bwd_body(b, n, c, w, dtype),
        "unpool_mlp": tfa._unpool_mlp_body(n, c, h, i, w, dtype),
        "hside": ths._hside_body(i, c, w, 32, dtype),
    }


def test_switches_pick_f32_for_fp32_and_the_old_bodies_for_bf16():
    assert set(_bodies(torch.float32).values()) == {"f32"}
    assert set(_bodies(torch.bfloat16).values()) == {"hopper"}
    # shapes no bf16 body takes (C 40, 5 heads, I 7) still take the route
    assert tfa._pool_ext_body(1, 3, 40, 5, 7, torch.float32) == "f32"
    assert tfa._unpool_bwd_body(1, 3, 40, 5, 7, torch.float32) == "f32"
    assert tfa.unpool_mlp_fits_sm(5000, 40, 7, 24, 5, torch.float32)
    assert not tfa.unpool_mlp_fits_sm(5000, 40, 7, 24, 5)
    with pytest.raises(ValueError):
        tfa._pool_ext_body(1, 3, 40, 5, 7)
    q, k, v = map(torch.from_numpy, _rect_args("pool"))
    assert tia._rect_fwd_body(q, k, v) == "f32"
    assert tia._rect_bwd_body(q, k, v, q, q.double()) == "f32"
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    assert tia._rect_fwd_body(q16, k16, v16) in ("hopper", "wmma")


def test_switches_raise_for_mixed_dtypes_naming_the_operand():
    """A route takes one dtype for its activations and weights: an operand
    that differs raises ValueError with its name, before any launch."""
    bf = torch.bfloat16
    x, se, be, ind2, kvw, wo = map(torch.from_numpy, _args("pool_ext", False))
    with pytest.raises(ValueError, match="kvw"):
        tfa._pool_ext_launch(x, se, be, ind2, kvw.to(bf), wo, HEADS, False)
    with pytest.raises(ValueError, match="wo"):
        tfa._pool_layer_launch(x, se, be, ind2, kvw, wo.to(bf), tfa.group_indicator(C, GROUPS),
                               HEADS, True, False)
    xu, seu, beu, k, v, wq, wou = map(torch.from_numpy, _args("unpool", False))
    with pytest.raises(ValueError, match="wq"):
        tfa._unpool_launch(xu, seu, beu, k, v, wq.to(bf), wou, HEADS, True, True)
    xm, sem, bem, w1t, b1, w2t, b2 = map(torch.from_numpy, _args("mlp", False))
    with pytest.raises(ValueError, match="w2t"):
        tfa._mlp_launch(xm, sem, bem, w1t, b1, w2t.to(bf), b2)
    h = [torch.from_numpy(a) for a in _args("hside", False)]
    h[-1] = h[-1].to(bf)
    with pytest.raises(ValueError, match="wv"):
        ths._hside_launch(*h)
    q, k, v = map(torch.from_numpy, _rect_args("unpool"))
    with pytest.raises(ValueError, match="v is"):
        tia._rect_fwd_body(q, k, v.to(bf))
    with pytest.raises(ValueError, match="o is"):
        tia._rect_bwd_body(q, k, v, q.to(bf), q)


def test_f32_primitives_plain_pieces():
    """The primitives' plain pieces: a split-free product with every
    epilogue, the softmax with given statistics, its backward with a given
    t, and the reduction modes."""
    rng = np.random.default_rng(9)
    a, b = torch.from_numpy(_rand(rng, 3, 5, 7)), torch.from_numpy(_rand(rng, 7, 4))
    bias, res = torch.from_numpy(_rand(rng, 4)), torch.from_numpy(_rand(rng, 3, 5, 4))
    h = 0.5 * (a @ b) + bias
    torch.testing.assert_close(f32.gemm(a, b, alpha=0.5, bias=bias, res=res), h + res)
    torch.testing.assert_close(f32.gemm(a, b, alpha=0.5, bias=bias, act=1),
                               torch.exp(-0.5 * h * h))
    torch.testing.assert_close(f32.gemm(a, b, alpha=0.5, bias=bias, act=2, res=res),
                               res * torch.exp(-0.5 * h * h) * (-h))
    out = res.clone()
    f32.gemm(a, b, out=out, accumulate=True)
    torch.testing.assert_close(out, res + a @ b)
    p, m, l = f32.softmax(a, 1)
    torch.testing.assert_close(p, torch.softmax(a, 1))
    torch.testing.assert_close(f32.softmax_given(a, 1, m, l), p)
    _, lse, _ = f32.softmax(a, -1, lse=True)
    torch.testing.assert_close(lse, torch.logsumexp(a, -1))
    dp = torch.from_numpy(_rand(rng, 3, 5, 7))
    t = (p * dp).sum(1)
    torch.testing.assert_close(f32.softmax_bwd(p, dp, 1), p * (dp - t[:, None]))
    torch.testing.assert_close(f32.softmax_bwd(p, dp, 1, t), p * (dp - t[:, None]))
    mu = torch.from_numpy(_rand(rng, 3, 7))
    torch.testing.assert_close(f32.reduce(a, 1, dp, mu=mu), (a * (dp - mu[:, None])).sum(1))
    torch.testing.assert_close(f32.reduce(a, 1, square=True), (a * a).sum(1))
    xs, bs = torch.from_numpy(_rand(rng, 3, 7)), torch.from_numpy(_rand(rng, 3, 7))
    torch.testing.assert_close(f32.affine(a, mu=mu, xs=xs, y=dp, bs=bs),
                               (a - mu[:, None]) * xs[:, None] + dp + bs[:, None])
