"""The shapes the port once refused on the card (ROADMAP C1), on the CPU.

For each: the JAX package computes there (its Pallas kernels in interpret
mode, each case one ``jax.jit``), the port's plain version agrees with it,
and the padded or blocked algebra that the card's bodies run there (a
ragged inducer count zero-padded to 16s and masked, a head width
zero-padded to the next rect-attention instance, a ragged point tail of
the pool backward's v1, v2 and v2j bodies, the pool backward's fold in
blocks of 64 inducer rows, dqf through a 64-column tail) composes in
plain PyTorch to the plain version.
The switches choose a body for each shape. fp32 tolerances are the JAX
package's own tests' (forward rtol 1e-4, atol 1e-5; backward rtol 5e-4,
atol 5e-5), scaled by max |ref| for drifted logits as in
``test_torch_kernels.py``; the pieces' compositions hold to 1e-5 of max
|ref| (the same fp32 operations, the padding adding exact zeros).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu.ops.pallas import hside as jhs
from gecco_tpu.ops.pallas.induced_attention import rect_attention_pallas
from gecco_tpu_torch.ops.kernels import _build
from gecco_tpu_torch.ops.kernels import folded_attention as tfa
from gecco_tpu_torch.ops.kernels import hside as ths
from gecco_tpu_torch.ops.kernels import induced_attention as tia

B, N, C, HEADS = 2, 128, 64, 4
D = C // HEADS
GROUPS = 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _maxrel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _close(port, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(port.detach().float().numpy()),
                               np.asarray(ref, np.float32), rtol=rtol, atol=atol, err_msg=what)


def _jax_vjp(fn, args, cot):
    """``fn``'s outputs and its vjp of ``cot`` in one jitted call."""

    def go(a, ct):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(ct)

    return jax.jit(go)(tuple(map(jnp.asarray, args)), tuple(map(jnp.asarray, cot)))


def _grads(fn, args, cot):
    """Outputs of ``fn`` on fresh leaves of ``args`` and the gradients of
    their dot with ``cot``."""
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_(True) for a in args]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, [torch.from_numpy(np.asarray(c)) for c in cot])
    return out, [x.grad for x in leaves]


# ------------------------------------------------ the pools, any inducers --


def _pool_args(seed, i):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, C)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32),
            (0.1 * rng.standard_normal((B, C))).astype(np.float32),
            (rng.standard_normal((HEADS * i, D)) / 2).astype(np.float32),
            (rng.standard_normal((2 * C, C)) / 8).astype(np.float32),
            (rng.standard_normal((C, C)) / 8).astype(np.float32))


@pytest.mark.parametrize("i", [24, 256])
def test_pool_takes_a_ragged_and_a_large_inducer_count(i):
    """``folded_pool_ext`` at 24 and 256 inducers: the JAX op (its forward
    and v3 backward kernels in interpret mode) against the port's plain
    version, h0 and every gradient; and the card's padded algebra (each
    head's inducers zero-padded to 16s, the padding's h0 rows sliced off
    and given a zero cotangent) gives the unpadded h0 and gradients."""
    args = _pool_args(40 + i, i)
    cot = (np.random.default_rng(41).standard_normal((B, i, C)).astype(np.float32),)
    (ref,), jgrads = _jax_vjp(lambda *a: (jfa.folded_pool_ext(*a, HEADS),), args, cot)
    (port,), grads = _grads(lambda *a: tfa.folded_pool_ext(*a, HEADS), args, cot)
    _close(port, ref, 1e-4, 1e-5, "h0")
    for q, (a, r) in enumerate(zip(grads, jgrads)):
        _close(a, r, 5e-4, 5e-5, f"gradient of argument {q}")
    ip = tfa._i_pad(i)

    def padded(x, se, be, ind2, kvw, wo):
        h0 = tfa._pool_ext_ref(x, se, be, tfa._pad_heads(ind2, HEADS, ip), kvw, wo, HEADS)
        return h0[:, :i]

    (pad_out,), pad_grads = _grads(padded, args, cot)
    assert _maxrel(pad_out.detach(), port.detach()) < 1e-5
    for a, r in zip(pad_grads, grads):
        assert _maxrel(a, r) < 1e-5


def test_resident_pool_takes_a_ragged_inducer_count():
    """``folded_pool_layer`` at 24 inducers: the JAX op (``_pool_kernel`` in
    interpret mode) against the plain version (rtol 1e-4, atol 1e-5), and
    the Hopper body's plain pieces on the heads' inducers zero-padded to
    32 give h0 sliced to 24 rows within 1e-5 of max |ref|."""
    i = 24
    args = _pool_args(42, i)
    gind = np.array(jfa.group_indicator(C, GROUPS))
    ref = jax.jit(lambda a: jfa.folded_pool_layer(*a, jnp.asarray(gind), HEADS, True))(
        tuple(map(jnp.asarray, args)))
    ops = [torch.from_numpy(a) for a in args]
    h0, mean, inv = tfa._pool_ref(*ops, GROUPS, HEADS, True)
    for name, a, r in zip(("h0", "mean_c", "inv_c"), (h0, mean, inv), ref):
        _close(a, r, 1e-4, 1e-5, name)
    x, scale, bias, ind2, kvw, wo = ops
    y = ((x - mean[:, None]) * (inv * scale)[:, None] + bias[:, None])
    qft = tfa.fold_qf(tfa._pad_heads(ind2, HEADS, 32), kvw, HEADS).t()
    macc, sacc = tfa._pool_layer_merge_ref(*tfa._pool_layer_chunks_ref(y, qft))
    pacc = tfa._pool_layer_sum_ref(
        tfa._pool_layer_partials_ref(y, qft, kvw, macc, sacc, HEADS), HEADS)
    assert _maxrel(pacc[:, :i] @ wo.t(), h0) < 1e-5


# --------------------------------------------------------- the unpool --


def _unpool_args(seed, i):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, C)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32),
            (0.1 * rng.standard_normal((B, C))).astype(np.float32),
            (rng.standard_normal((B, i, C)) / 3).astype(np.float32),
            (rng.standard_normal((B, i, C)) / 3).astype(np.float32),
            (rng.standard_normal((C, C)) / 8).astype(np.float32),
            (rng.standard_normal((C, C)) / 8).astype(np.float32))


def _unpool_padded(x, se, be, k, v, wq, wo, i_pad):
    """The WMMA unpool bodies' algebra at a ragged I in plain PyTorch: k and
    v zero-padded to ``i_pad`` rows, the padding's bias row -inf (the
    forward's fold), through the Hopper body's pieces."""
    i = k.shape[1]
    kp, vp = (tfa._pad_points(t, i_pad) for t in (k, v))
    kft, vft, brow = tfa._unpool_fold_ref(se, be, kp, vp, wq, wo, HEADS)
    pad = (torch.arange(HEADS * i_pad) % i_pad) >= i
    brow = brow.masked_fill(pad, -torch.inf)
    return tfa._unpool_tiles_ref(x, kft, vft, brow, HEADS, True)


@pytest.mark.parametrize("i", [24, 256])
def test_unpool_takes_a_ragged_and_a_large_inducer_count(i):
    """``folded_unpool`` at 24 and 256 inducers: the JAX op (its forward and
    backward kernels in interpret mode) against the port's plain version,
    the output, its sums and every gradient; and at the ragged count the
    WMMA bodies' padded algebra (zero rows of k and v, their logits at
    -inf) gives the unpadded output, sums and gradients."""
    args = _unpool_args(50 + i, i)
    rng = np.random.default_rng(51)
    cot = (rng.standard_normal((B, N, C)).astype(np.float32),
           (1e-3 * rng.standard_normal((B, 2, C))).astype(np.float32))
    ref, jgrads = _jax_vjp(lambda *a: jfa.folded_unpool(*a, HEADS), args, cot)
    port, grads = _grads(lambda *a: tfa.folded_unpool(*a, HEADS), args, cot)
    for name, a, r in zip(("out", "sums"), port, ref):
        _close(a, r, 1e-4, 1e-5 * max(1.0, float(np.abs(np.asarray(r)).max())), name)
    for q, (a, r) in enumerate(zip(grads, jgrads)):
        _close(a, r, 5e-4, 5e-5, f"gradient of argument {q}")
    ip = tfa._i_pad(i)
    if ip == i:
        return
    pad_out, pad_grads = _grads(lambda *a: _unpool_padded(*a, ip), args, cot)
    for a, r in zip(pad_out, port):
        assert _maxrel(a.detach(), r.detach()) < 1e-5
    for a, r in zip(pad_grads, grads):
        assert _maxrel(a, r) < 1e-5


# ----------------------------------------------------------- the h-side --


@pytest.mark.parametrize("i", [20, 24])
def test_hside_takes_a_ragged_inducer_count(i):
    """``fused_h_side`` at 20 and 24 inducers: the JAX op (``_hside_kernel``
    in interpret mode) against the port's plain version (rtol 1e-4, atol
    1e-5), and the Hopper body's passes on the tokens zero-padded to 32
    rows, both norms' statistics over the first I rows only (``i_valid``),
    give h, k and v sliced to I rows within 1e-5 of max |ref|."""
    rng = np.random.default_rng(60 + i)
    w = 2 * C
    args = [rng.standard_normal((B, i, C)).astype(np.float32)]
    args += [(1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32) if q % 2 == 0
             else (0.2 * rng.standard_normal((B, C))).astype(np.float32) for q in range(4)]
    args.append(np.array(jfa.group_indicator(C, GROUPS)))
    args += [(rng.standard_normal((C, w)) / C**0.5).astype(np.float32),
             (0.1 * rng.standard_normal((1, w))).astype(np.float32),
             (rng.standard_normal((w, C)) / w**0.5).astype(np.float32),
             (0.1 * rng.standard_normal((1, C))).astype(np.float32),
             (rng.standard_normal((C, C)) / C**0.5).astype(np.float32),
             (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)]
    ref = jax.jit(lambda a: jhs.fused_h_side(*a))(tuple(map(jnp.asarray, args)))
    ops = [torch.from_numpy(a) for a in args]
    port = ths._hside_ref(*ops)
    for name, a, r in zip("hkv", port, ref):
        _close(a, r, 1e-4, 1e-5, name)
    h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv = ops
    h0p = tfa._pad_points(h0, tfa._i_pad(i))
    y1 = ths._hside_norm_ref(h0p, s1, b1n, GROUPS, h0.dtype, i_valid=i)
    hh, _ = ths._hside_out_ref(tfa._mlp_act_ref(y1, w1t, b1), w2t, b2)
    h = ths._hside_norm_ref(hh, s2, b2n, GROUPS, h0.dtype, i_valid=i)
    for name, a, r in zip("hkv", (h, *ths._hside_kv_ref(h, wk, wv)), port):
        assert _maxrel(a[:, :i], r) < 1e-5, name


# ------------------------------------------------- the rect attention --


@pytest.mark.parametrize("d", [40, 192, 256])
@pytest.mark.parametrize("direction", ["pool", "unpool"])
def test_rect_attention_takes_any_head_width(direction, d):
    """The per-head attention at D 40, 192 and 256 (three heads at C 768;
    the backward's instance there keeps dq, dk and dv in two 128-column
    slices, each forming the logits at full D): the JAX op
    (``rect_attention_pallas``, forward and backward kernels in interpret
    mode) against the port's plain version, o and dq, dk, dv (rtol 1e-4,
    atol 1e-5); and the kernels' padded algebra (q, k, v zero-padded to
    the next instance's width, ``_d_pad``, the softmax scale 1/sqrt of the
    real D) gives the unpadded o within 1e-5 of max |ref|."""
    rng = np.random.default_rng(70 + d)
    m, n = (16, N) if direction == "pool" else (N, 16)
    q, k, v, g = (rng.standard_normal((B, 2, rows, d)).astype(np.float32)
                  for rows in (m, n, n, m))
    ref, jgrads = _jax_vjp(lambda *a: (rect_attention_pallas(*a),), (q, k, v), (g,))
    (port,), grads = _grads(lambda *a: tia.rect_attention_pallas(*a), (q, k, v), (g,))
    _close(port, ref[0], 1e-4, 1e-5, "o")
    for name, a, r in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(a, r, 1e-4, 1e-5, name)
    dp = tia._d_pad(d)
    assert dp in tia._WIDTHS and dp >= d
    qp, kp, vp = (tia._pad_width(torch.from_numpy(a), dp) for a in (q, k, v))
    s = torch.einsum("bhmd,bhnd->bhmn", qp, kp) / d**0.5
    o = torch.einsum("bhmn,bhnd->bhmd", torch.softmax(s, -1), vp)
    assert not o[..., d:].any()
    assert _maxrel(o[..., :d], port.detach()) < 1e-5


# ------------------------------- the pool backward's v1, v2 and v2j bodies --


@pytest.mark.parametrize("mode", ["v1", "v2", "v2j"])
def test_twopass_bodies_take_a_ragged_tail(monkeypatch, mode):
    """The pool backward's v1, v2 and v2j bodies at N 100: the JAX op with
    ``GECCO_POOL_BWD`` forced to that body (its Pallas kernel in interpret
    mode: the tile fits, so no XLA twin ran) against the body's plain
    version on the stream zero-padded to 128 points with ``n_valid`` = 100,
    on bf16 operands: dse and dbe within 1e-3 of max |ref|, the bf16
    gradients within 4e-3 (``test_pool_bwd_twopass_refs_match_the_jax_bodies``'
    tolerances); and the padded plain version equals the unpadded one."""
    monkeypatch.setattr(jfa, "_POOL_BWD_ENV", mode)
    n, i = 100, 16
    j = HEADS * i
    v1 = mode == "v1"
    assert jfa._pool_bwd_mode(n, C, j, D) == mode
    assert jfa._tile_fits(n, jfa._pool_ext_bwd_row_bytes(C, j, v1),
                          jfa._pool_ext_bwd_fixed_bytes(C, j, D, v1, mode == "v2j"), cap=512)
    bf = torch.bfloat16
    rng = np.random.default_rng(80)
    args = [a[:, :n] if q == 0 else a for q, a in enumerate(_pool_args(81, i))]
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(args)]
    x, se, be, ind2, kvw, wo = ops
    g_h0 = torch.from_numpy(rng.standard_normal((B, i, C)).astype(np.float32)).to(bf)
    qft = tfa._fold_qft_ref(ind2, kvw, HEADS)
    xp = tfa._pad_points(x, tfa._n_pad(n))
    _, macc, sacc = tfa._pool_merge_ref(
        *tfa._pool_partials_ref(xp, se, be, qft, kvw, HEADS, n), wo, HEADS)
    ref_fn = tfa._TWOPASS_REFS[mode]
    padded = ref_fn(xp, se, be, qft, kvw, wo, g_h0, macc, sacc, HEADS, n)
    plain = ref_fn(x, se, be, qft, kvw, wo, g_h0, macc, sacc, HEADS)
    assert not padded[0][:, n:].float().any()
    for a, r in zip((padded[0][:, :n], *padded[1:]), plain):
        assert _maxrel(a.float(), r.float()) < 1e-5
    dx, dse, dbe, dqf, dwv, dwo = padded
    got = (dx[:, :n], dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, HEADS), dwo.to(wo.dtype))
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    _, ref = _jax_vjp(lambda *a: (jfa.folded_pool_ext(*a, HEADS),), jops,
                      (jnp.asarray(g_h0.float().numpy(), jnp.bfloat16),))
    for name, a, r in zip(("dx", "dse", "dbe", "dind2", "dkvw", "dwo"), got, ref):
        assert _maxrel(a.float().numpy(), r) < (1e-3 if name in ("dse", "dbe") else 4e-3), name


# ------------------- the pool backward's fold and the resident backward --


def _wide_pool_args(seed, c, heads, i, n=N, b=1):
    rng = np.random.default_rng(seed)
    d = c // heads
    return (rng.standard_normal((b, n, c)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal((b, c))).astype(np.float32),
            (0.1 * rng.standard_normal((b, c))).astype(np.float32),
            (rng.standard_normal((heads * i, d)) / 2).astype(np.float32),
            (rng.standard_normal((2 * c, c)) / c**0.5).astype(np.float32),
            (rng.standard_normal((c, c)) / c**0.5).astype(np.float32))


def test_pool_backward_fold_takes_256_inducers_at_three_heads():
    """The pool backward at three heads of C 384 (D 128) and 256 inducers,
    where the fold once held a head's [I, D] blocks whole (up to ~200
    inducers): the JAX op (its v3 backward kernel in interpret mode: the
    tile fits, no XLA twin) against the port's plain version (rtol 5e-4,
    atol 5e-5 of the gradients, 1e-4 / 1e-5 of h0); and the fold in
    blocks of 64 of each head's rows (``pool_bwd_fold_kernel``'s third grid
    dimension: each block's DMs, pacc, tacc, merged and W3 rows, its share
    of dWo and dWv added) composes to the whole fold within 1e-5 of max
    |ref|."""
    c, heads, i = 384, 3, 256
    j, d = heads * i, c // heads
    assert tfa._pool_ext_bwd_body(8, 2048, c, heads, i) == "wmma"
    assert tfa._pool_bwd_fold_smem(c, i, d) == tfa._pool_bwd_fold_smem(c, 64, d)
    fixed = jfa._pool_ext_bwd_fixed_bytes(c, j, d, False, True) + 4 * j * c
    assert jfa._pool_bwd_mode(N, c, j, d) == "v3"
    assert jfa._tile_fits(N, jfa._pool_ext_bwd_row_bytes(c, j), fixed,
                          cap=jfa._POOL_BWD_V3_TILE_CAP)
    args = _wide_pool_args(90, c, heads, i)
    cot = (np.random.default_rng(91).standard_normal((1, i, c)).astype(np.float32),)
    (ref,), jgrads = _jax_vjp(lambda *a: (jfa.folded_pool_ext(*a, heads),), args, cot)
    (port,), grads = _grads(lambda *a: tfa.folded_pool_ext(*a, heads), args, cot)
    _close(port, ref, 1e-4, 1e-5, "h0")
    for q, (a, r) in enumerate(zip(grads, jgrads)):
        _close(a, r, 5e-4, 5e-5, f"gradient of argument {q}")
    x, se, be, ind2, kvw, wo = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(cot[0])
    qft = tfa._fold_qft_ref(ind2, kvw, heads)
    _, macc, sacc = tfa._pool_merge_ref(*tfa._pool_partials_ref(x, se, be, qft, kvw, heads), wo,
                                        heads)
    ety = tfa._pool_bwd_ety_ref(x, se, be, qft, macc)
    whole = tfa._pool_bwd_fold_ref(ety, g, kvw, wo, sacc, heads)
    tacc, w3 = torch.zeros_like(whole[0]), torch.zeros_like(whole[1])
    dwv, dwo = torch.zeros_like(whole[2]), torch.zeros_like(whole[3])
    rows = tfa._FOLD_ROWS
    for r0 in range(0, i, rows):
        cols = torch.cat([torch.arange(h * i + r0, h * i + r0 + rows) for h in range(heads)])
        t_b, w3_b, dwv_b, dwo_b = tfa._pool_bwd_fold_ref(ety[:, cols], g[:, r0:r0 + rows], kvw,
                                                          wo, sacc[:, cols], heads)
        tacc[:, cols], w3[:, cols] = t_b, w3_b
        dwv += dwv_b
        dwo += dwo_b
    for name, a, r in zip(("tacc", "w3", "dwv", "dwo"), (tacc, w3, dwv, dwo), whole):
        assert _maxrel(a, r) < 1e-5, name


def test_resident_pool_backward_takes_256_inducers():
    """The resident pool's backward at C 384, 8 heads (D 48) and 256
    inducers, where its main kernel's 64-point block no longer fits: the
    JAX op (``_pool_bwd_kernel`` in interpret mode: its VMEM gate holds at
    these shapes) against the port's plain version, h0, mean and inv and
    every gradient (rtol 1e-4 / atol 1e-5 forward, 5e-4 / 5e-5 backward);
    and the main kernel's tile (``_pool_layer_bwd_tile``) falls to 32
    points, within shared memory, at C 384 and C 768."""
    c, heads, i = 384, 8, 256
    assert jfa.pool_bwd_vmem_ok(N, c, heads * i)
    for cc, hh in ((384, 8), (768, 16)):
        assert tfa._pool_layer_bwd_tile(cc, i, cc // hh) == 32
        assert tfa._pool_layer_bwd_smem(cc, i, cc // hh) <= tfa._MAX_SMEM
    args = _wide_pool_args(92, c, heads, i)
    gind = np.array(jfa.group_indicator(c, GROUPS))
    rng = np.random.default_rng(93)
    cot = (rng.standard_normal((1, i, c)).astype(np.float32),
           (0.1 * rng.standard_normal((1, c))).astype(np.float32),
           (0.1 * rng.standard_normal((1, c))).astype(np.float32))
    ref, jgrads = _jax_vjp(
        lambda *a: jfa.folded_pool_layer(*a, jnp.asarray(gind), heads, True), args, cot)
    port, grads = _grads(
        lambda *a: tfa.folded_pool_layer(*a, torch.from_numpy(gind), heads, True), args, cot)
    for name, a, r in zip(("h0", "mean_c", "inv_c"), port, ref):
        _close(a, r, 1e-4, 1e-5, name)
    for q, (a, r) in enumerate(zip(grads, jgrads)):
        _close(a, r, 5e-4, 5e-5, f"gradient of argument {q}")


@pytest.mark.parametrize("mode", ["v1", "v2", "v2j"])
def test_twopass_bodies_take_three_heads(monkeypatch, mode):
    """The pool backward's v1, v2 and v2j bodies at three heads of 64
    inducers (J 192: no multiple of 128) and C 384 (D 128): the JAX op with
    ``GECCO_POOL_BWD`` forced to that body (its Pallas kernel in interpret
    mode, as at the flagship's N 2048) against the body's plain version in
    fp32 (rtol 5e-4, atol 5e-5: the JAX package's backward tolerances); the
    switch takes that body's Hopper instance at the three-head flagship
    (csrc/pool_ext_bwd_twopass.cu at D 128). The S product's 64-column
    tiles and the weight gradients' 64-column tail (``wgrad.cuh``) that J
    192 takes on the card are held there (``chip_smoke.py``'s phase 21)."""
    monkeypatch.setattr(jfa, "_POOL_BWD_ENV", mode)
    monkeypatch.setattr(tfa, "_POOL_BWD_ENV", mode)
    c, heads, i = 384, 3, 64
    j, d = heads * i, c // heads
    v1 = mode == "v1"
    for n in (N, 2048):
        assert jfa._pool_bwd_mode(n, c, j, d) == mode
        assert jfa._tile_fits(n, jfa._pool_ext_bwd_row_bytes(c, j, v1),
                              jfa._pool_ext_bwd_fixed_bytes(c, j, d, v1, mode == "v2j"), cap=512)
    assert tfa._pool_ext_bwd_body(8, 2048, c, heads, i) == mode
    args = _wide_pool_args(94, c, heads, i, b=2)
    x, se, be, ind2, kvw, wo = (torch.from_numpy(a) for a in args)
    g_h0 = np.random.default_rng(95).standard_normal((2, i, c)).astype(np.float32)
    g = torch.from_numpy(g_h0)
    qft = tfa._fold_qft_ref(ind2, kvw, heads)
    _, macc, sacc = tfa._pool_merge_ref(*tfa._pool_partials_ref(x, se, be, qft, kvw, heads), wo,
                                        heads)
    dx, dse, dbe, dqf, dwv, dwo = tfa._TWOPASS_REFS[mode](x, se, be, qft, kvw, wo, g, macc,
                                                          sacc, heads)
    got = (dx, dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, heads), dwo)
    _, ref = _jax_vjp(lambda *a: (jfa.folded_pool_ext(*a, heads),), args, (g_h0,))
    for name, a, r in zip(("dx", "dse", "dbe", "dind2", "dkvw", "dwo"), got, ref):
        _close(a, r, 5e-4, 5e-5, name)


@pytest.mark.parametrize("mode", ["v1", "v2", "v2j"])
@pytest.mark.parametrize("shape,hopper", [
    ((48, 2048, 384, 8, 64), True), ((2, 8192, 768, 16, 64), True),
    ((48, 2048, 384, 3, 64), True), ((48, 2000, 384, 3, 64), True),
    ((48, 2048, 768, 6, 64), True), ((48, 2048, 128, 4, 64), False),
    ((48, 2048, 384, 4, 64), False), ((48, 2048, 384, 3, 128), False)],
    ids=["flagship", "8k", "three-heads", "three-heads-ragged", "six-heads-C768", "demo",
         "D96", "three-heads-I128"])
def test_twopass_hopper_body_takes_three_heads_not_the_demo(monkeypatch, shape, hopper, mode):
    """``_pool_twopass_hopper_takes`` (csrc/pool_ext_bwd_twopass.cu
    ``body_takes``): the Hopper two-pass body's instances at D 48 (the
    flagship's and the 8k width) and D 128 (three heads at C 384, six at C
    768), 64 inducers a head, any N; the demo's C 128 (D 32), D 96 and 128
    inducers take the WMMA body, which the forced switch names
    ``<mode>_wmma``."""
    monkeypatch.setattr(tfa, "_POOL_BWD_ENV", mode)
    assert tfa._pool_twopass_hopper_takes(*shape) == hopper
    assert tfa._pool_ext_bwd_body(*shape) == (mode if hopper else f"{mode}_wmma")


# ------------------------------------------------------------ switches --


@pytest.mark.parametrize("shape,want", [
    ((8, 2048, 384, 8, 24), ("wmma", "wmma", "wmma", "hopper")),
    ((8, 2048, 384, 8, 128), ("wmma", "wmma", "wmma", "hopper")),
    ((8, 2048, 384, 8, 192), ("wmma", "wmma", "wmma", "hopper")),
    ((8, 2048, 384, 8, 256), ("wmma", "wmma", "wmma", "hopper")),
    ((8, 2048, 768, 16, 256), ("wmma", "wmma", "wmma", "hopper")),
    ((8, 2048, 384, 3, 256), ("wmma", "wmma", "wmma", "wmma")),
], ids=["I24", "I128", "I192", "I256", "8k-I256", "heads3-I256"])
def test_switches_take_every_inducer_count(shape, want):
    """The pool forward, the unpool forward and backward, and the resident
    pool take 24 to 256 inducers at the flagship's and the 8k width
    (``_pool_ext_body``, ``_unpool_body``, ``_unpool_bwd_body``,
    ``_pool_layer_body``), where each raised on the card before, and the
    h-side and the pool backward there too (three heads' D 128 included:
    its fold takes a head's rows in blocks of 64)."""
    switches = (tfa._pool_ext_body, tfa._unpool_body, tfa._unpool_bwd_body, tfa._pool_layer_body)
    assert tuple(s(*shape) for s in switches) == want
    b, n, c, h, i = shape
    assert ths._hside_body(i, c, 2 * c, 32) == "hopper"
    assert tfa._pool_ext_bwd_body(*shape) == "wmma"


def test_mirrors_of_the_new_plans_use_the_sources_constants():
    """The Python mirrors read the constants the CUDA sources give: the
    rect attention's instance widths (forward and backward), the two-pass
    bodies' point tile, the inducer alignment (the h-side's slab), and the
    WMMA unpool backward's tiles, the pool backward fold's row block and
    the resident pool backward's point tiles; the column block of a WMMA
    pool block divides I and fits; the two-pass bodies and the resident
    pool's backward fit where their switches and checks say; the Hopper
    pool forward's point chunk, head widths and ring depths, and the Hopper
    unpool's point tile, rings and column blocks."""
    for name in ("induced_attention.cu", "induced_attention_bwd.cu"):
        text = (_build.CSRC / name).read_text()
        widths = tuple(int(w) for w in re.findall(r"case (\d+):", text))
        assert widths == tia._WIDTHS, name
    text = (_build.CSRC / "pool_bwd_twopass.cuh").read_text()
    assert int(re.search(r"constexpr int kTN = (\d+);", text).group(1)) == 32
    text = (_build.CSRC / "hside.cu").read_text()
    assert int(re.search(r"constexpr int kSlab = (\d+);", text).group(1)) == tfa._I_ALIGN
    text = (_build.CSRC / "unpool_bwd_wmma.cu").read_text()
    assert "for (int tn = 32; tn >= 16; tn /= 2)" in text
    for c, i, d in ((384, 256, 48), (768, 512, 48), (384, 240, 32), (128, 64, 32)):
        ib = tfa._pool_wmma_block(c, i, d)
        assert ib and i % ib == 0 and tfa._pool_wmma_smem(c, ib, d) <= tfa._MAX_SMEM
    text = (_build.CSRC / "backward.cuh").read_text()
    assert int(re.search(r"constexpr int kFoldRows = (\d+);", text).group(1)) == tfa._FOLD_ROWS
    text = (_build.CSRC / "pool_bwd_wmma.cu").read_text()
    assert "for (int TN = C <= 384 ? 64 : 32; TN >= 16; TN /= 2)" in text
    # the resident pool backward's Hopper pass block (csrc/pool_bwd.cu
    # PassSmem: three ring stages, two at C 768) fits at both widths
    text = (_build.CSRC / "pool_bwd.cu").read_text()
    assert int(re.search(r"constexpr int kMaxRing = (\d+);", text).group(1)) == 3
    assert "ring = C <= 384 ? kMaxRing : 2;" in text
    assert all(tfa._pool_layer_bwd_pass_smem(c) <= tfa._MAX_SMEM for c in (384, 768))
    assert tfa._pool_twopass_takes(48, 2048, 128, 4, 64)
    # three heads of 64 inducers: J 192, through the weight gradients'
    # 64-column tail
    assert tfa._pool_twopass_takes(48, 2048, 384, 3, 64)
    assert not tfa._pool_twopass_takes(48, 2048, 384, 3, 56)
    # the resident pool's backward: the flagship's, the 8k and three heads'
    # widths fit, at C 384 and D 48 up to 960 inducers (the main kernel's
    # tile halved where its planes grow), at C 768 up to 912
    fits = lambda c, i, d: tfa._pool_layer_bwd_smem(c, i, d) <= tfa._MAX_SMEM
    assert fits(384, 64, 48) and fits(768, 64, 48) and fits(384, 64, 128)
    assert fits(384, 128, 48) and fits(384, 144, 48) and fits(384, 256, 48)
    assert fits(384, 960, 48) and not fits(384, 976, 48)
    assert fits(768, 912, 48) and not fits(768, 928, 48)
    assert [tfa._pool_layer_bwd_tile(384, i, 48) for i in (64, 128, 144, 512)] == [64, 64, 32, 16]
    assert tfa._pool_layer_bwd_tile(768, 64, 48) == 32
    # the fold's block bytes stop growing at 64 rows
    assert tfa._pool_bwd_fold_smem(384, 256, 128) == tfa._pool_bwd_fold_smem(384, 64, 128)
    # the Hopper pool forward's chunk kernel: its point chunk, its head
    # widths (chunk_smem's cases), its ring depth by heads a block; the
    # Hopper unpool's point tile, rings and column blocks (2 NW per
    # unpool_tile_kernel<NW>: C itself up to 384, else 192)
    text = (_build.CSRC / "pool_ext.cu").read_text()
    assert int(re.search(r"constexpr int kTM = (\d+);", text).group(1)) == tfa._POOL_CHUNK
    launch = text[text.index("int chunk_smem("):]
    widths = tuple(int(w) for w in re.findall(r"case (\d+): total", launch))
    assert widths == tfa._POOL_HOPPER_WIDTHS
    assert "kRing = G == 8 ? 3 : 2;" in text and "H % 4 != 0" in launch
    assert "const bool g8 = H % 8 == 0;" in launch and tfa._pool_ext_group(12) == 4
    text = (_build.CSRC / "unpool.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", text).group(1)) == tfa._UNPOOL_TILE
    assert int(re.search(r"constexpr int kKRing = (\d+);", text).group(1)) == 4
    assert int(re.search(r"constexpr int kVRing = (\d+);", text).group(1)) == 2
    blocks = {int(cb): 2 * int(nw) for cb, nw in
              re.findall(r"case (\d+): kernel = unpool_tile_kernel<(\d+)>", text)}
    assert all(cb == w for cb, w in blocks.items()) and 384 not in blocks
    assert "default: kernel = unpool_tile_kernel<192>;" in text
    assert "const int CB = C <= 384 ? C : 192;" in text
    for c in range(64, 385, 64):
        assert c in blocks or c == 384
        assert tfa._unpool_hopper_takes(c, c // 32, 64)
