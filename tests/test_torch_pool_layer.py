"""The resident pool (``folded_pool_layer``) and the unpool's flags against
the JAX package, on the CPU.

On CPU tensors the port's wrappers run their plain versions (the backward:
autograd through them). The JAX side runs its Pallas kernels in interpret
mode: ``_pool_kernel`` and ``_pool_bwd_kernel`` (at these shapes the JAX
package's VMEM gate routes the backward to its own kernel), and the unpool's
forward and backward kernels in their four flag variants. fp32 throughout;
the tolerances are the JAX package's own tests' (``test_pallas_ops.py``),
with the absolute one scaled by max |ref| for drifted logits, as in
``test_torch_kernels.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu_torch.ops.kernels import folded_attention as tfa

REPO = Path(__file__).resolve().parents[1]
B, N, C, HEADS, I = 2, 128, 64, 4, 16
J, D = HEADS * I, C // HEADS
GROUPS = 8
# per-head scales of the drifted logits (scripts/certify_kernels.py's
# magnitudes): head 0's ~60x head 1's, maxima more than the clamp (80) apart
DRIFT = np.repeat(np.array([60.0, 1.0, 0.1, 0.01], np.float32), D)
PRENORM = [True, False]
DRIFTS = [False, True]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pool_args(seed, drift):
    """x with per-channel offsets (non-zero group means), the AdaGN scale
    and bias, inducers, kvw (k rows scaled by DRIFT where drifted), wo."""
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((B, N, C)) + 0.3 * rng.standard_normal(C)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    ind2 = (rng.standard_normal((J, D)) / 2).astype(np.float32)
    kvw = (rng.standard_normal((2 * C, C)) / 8).astype(np.float32)
    if drift:
        kvw[:C] *= DRIFT[:, None] * 8 / C**0.5
    wo = (rng.standard_normal((C, C)) / 8).astype(np.float32)
    return x, scale, bias, ind2, kvw, wo


def _gind():
    return np.array(jfa.group_indicator(C, GROUPS))


def _jax_vjp(fn, args, cot):
    """``fn``'s outputs and its vjp of ``cot``, in one jitted call: one
    compile of the interpret-mode kernels instead of one per eager op."""

    def go(a, ct):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(ct)

    return jax.jit(go)(tuple(map(jnp.asarray, args)), tuple(map(jnp.asarray, cot)))


def _assert_close(port, ref, rtol, atol, drift, what):
    """With drifted logits (in the hundreds) fp32 rounding of a logit moves
    a value by ~1e-5 of the largest: the absolute tolerance then scales with
    max |ref| (2e-5 of it)."""
    ref = np.asarray(ref, np.float32)
    tol = max(atol, 2e-5 * float(np.abs(ref).max())) if drift else atol
    np.testing.assert_allclose(np.asarray(port.detach().numpy(), np.float32), ref, rtol=rtol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("drift", DRIFTS, ids=["plain", "drift"])
@pytest.mark.parametrize("prenorm", PRENORM, ids=["prenorm", "no-prenorm"])
def test_pool_layer_matches_jax(prenorm, drift):
    """h0, mean_c and inv_c against the JAX op (``_pool_kernel`` in
    interpret mode) and against its XLA twin ``_pool_ref``: forward rtol
    1e-4, atol 1e-5 (1e-4 with drifted logits, as the unpool's drift
    test)."""
    args = _pool_args(0, drift)
    port = tfa.folded_pool_layer(*map(torch.from_numpy, args), torch.from_numpy(_gind()), HEADS,
                                 prenorm)
    gind = jnp.asarray(_gind())
    refs = jax.jit(lambda a: (jfa.folded_pool_layer(*a, gind, HEADS, prenorm),
                              jfa._pool_ref(*a, GROUPS, HEADS, prenorm)))(
        tuple(map(jnp.asarray, args)))
    for ref in refs:
        for name, a, r in zip(("h0", "mean_c", "inv_c"), port, ref):
            _assert_close(a, r, 1e-4, 1e-4 if drift else 1e-5, False, name)


@pytest.mark.parametrize("drift", DRIFTS, ids=["plain", "drift"])
@pytest.mark.parametrize("prenorm", PRENORM, ids=["prenorm", "no-prenorm"])
def test_pool_layer_backward_matches_jax(prenorm, drift):
    """Gradients through all three outputs, the mean/inv cotangents nonzero
    (as test_pallas_ops.py's pool backward test), against ``jax.vjp`` of
    the JAX op (its ``_pool_bwd_kernel`` in interpret mode); that test's
    tolerance (rtol 5e-4, atol 5e-5). The group indicator takes none."""
    args = _pool_args(1, drift)
    rng = np.random.default_rng(2)
    cot = (rng.standard_normal((B, I, C)).astype(np.float32),
           (0.05 * rng.standard_normal((B, C))).astype(np.float32),
           (0.02 * rng.standard_normal((B, C))).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = tfa.folded_pool_layer(*leaves, torch.from_numpy(_gind()), HEADS, prenorm)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    gind = jnp.asarray(_gind())
    _, ref = _jax_vjp(lambda *a: jfa.folded_pool_layer(*a, gind, HEADS, prenorm), args, cot)
    for q, (a, r) in enumerate(zip(leaves, ref)):
        _assert_close(a.grad, r, 5e-4, 5e-5, drift, f"gradient of argument {q}")


def _unpool_args(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    se = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    be = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    k = (rng.standard_normal((B, I, C)) / 3).astype(np.float32)
    v = (rng.standard_normal((B, I, C)) / 3).astype(np.float32)
    wq = (rng.standard_normal((C, C)) / 8).astype(np.float32)
    wo = (rng.standard_normal((C, C)) / 8).astype(np.float32)
    return x, se, be, k, v, wq, wo


@pytest.mark.parametrize("prenorm", PRENORM, ids=["prenorm", "no-prenorm"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no-residual"])
def test_unpool_flags_match_jax(residual, prenorm):
    """``folded_unpool`` with its ``residual``/``prenorm`` flags: out and the
    sums against the JAX op (interpret mode) and its twin (forward rtol
    1e-4, atol 1e-5; the sums relative 1e-3, as test_torch_kernels.py);
    every gradient through both outputs, the sums cotangent nonzero,
    against ``jax.vjp`` of the JAX op (its backward kernel in interpret
    mode), at test_pallas_ops.py's unpool tolerance (rtol 3e-4, atol
    3e-5)."""
    args = _unpool_args(3)
    flags = (HEADS, residual, prenorm)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, sums = tfa.folded_unpool(*leaves, *flags)
    rng = np.random.default_rng(4)
    cot = (rng.standard_normal((B, N, C)).astype(np.float32),
           (0.01 * rng.standard_normal((B, 2, C))).astype(np.float32))
    kernel, grads = _jax_vjp(lambda *a: jfa.folded_unpool(*a, *flags), args, cot)
    twin = jax.jit(lambda a: jfa._unpool_ref(*a, *flags))(tuple(map(jnp.asarray, args)))
    for ref_out, ref_sums in (kernel, twin):
        _assert_close(out, ref_out, 1e-4, 1e-5, False, "out")
        np.testing.assert_allclose(sums.detach().numpy(), np.asarray(ref_sums), rtol=1e-3,
                                   atol=1e-3)
    torch.autograd.backward((out, sums), [torch.from_numpy(c) for c in cot])
    for q, (a, r) in enumerate(zip(leaves, grads)):
        _assert_close(a.grad, r, 3e-4, 3e-5, False, f"gradient of argument {q}")
    if not prenorm:
        assert not leaves[1].grad.any() and not leaves[2].grad.any()


def test_pool_layer_bwd_witness_matches_the_jax_kernel_in_bf16():
    """``chip_smoke.py``'s ``pool_layer_bwd_tpu_algebra``, the witness that
    the card's drifted dbias is held against, is the JAX kernel's own
    algebra: on bf16 operands with drifted logits its dscale/dbias agree
    with ``jax.vjp`` of the JAX op (``_pool_bwd_kernel`` in interpret mode)
    within 1e-3 of max |ref| (fp32 sums in other orders; measured 2e-5),
    while autograd of the plain version departs by about 1e-2 there (bf16
    p before the softmax backward): more than five times the witness's
    limit."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    bf = torch.bfloat16
    args = _pool_args(0, True)
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(args)]
    g_h0 = torch.from_numpy(np.random.default_rng(9).standard_normal((B, I, C)).astype(np.float32))
    g_h0 = g_h0.to(bf)
    witness = chip_smoke.pool_layer_bwd_tpu_algebra(*ops, torch.from_numpy(_gind()), g_h0, HEADS)
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    zero = np.zeros((B, C), np.float32)
    gind = jnp.asarray(_gind())
    _, ref = _jax_vjp(lambda *a: jfa.folded_pool_layer(*a, gind, HEADS, True), jops,
                      (jnp.asarray(g_h0.float().numpy(), jnp.bfloat16), zero, zero))
    leaves = [a.clone().requires_grad_(True) for a in ops]
    tfa._pool_ref(*leaves, GROUPS, HEADS)[0].backward(g_h0)
    for name, w, r, plain in (("dscale", witness[0], ref[1], leaves[1].grad),
                              ("dbias", witness[1], ref[2], leaves[2].grad)):
        r = np.asarray(r, np.float32)
        scale = float(np.abs(r).max())
        assert np.abs(w.numpy() - r).max() < 1e-3 * scale, name
        assert np.abs(plain.float().numpy() - r).max() > 5e-3 * scale, name


def test_pool_layer_bwd_wrapper_is_autograd_of_the_plain_version():
    """``folded_pool_layer_bwd`` (what the CUDA backward replaces) on CPU
    tensors is exactly autograd through ``_pool_ref``, and needs none of
    the forward's results there."""
    args = _pool_args(5, False)
    rng = np.random.default_rng(6)
    cot = [rng.standard_normal((B, I, C)).astype(np.float32),
           rng.standard_normal((B, C)).astype(np.float32),
           rng.standard_normal((B, C)).astype(np.float32)]
    got = tfa.folded_pool_layer_bwd(*map(torch.from_numpy, args), torch.from_numpy(_gind()),
                                    None, None, None, None, None, None,
                                    *map(torch.from_numpy, cot), HEADS)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    torch.autograd.backward(tfa._pool_ref(*leaves, GROUPS, HEADS),
                            [torch.from_numpy(c) for c in cot])
    for a, x in zip(got, leaves):
        torch.testing.assert_close(a, x.grad, rtol=0, atol=0)


# ------------------------------------- the Hopper body's passes, plainly --


def _pool_layer_by_pieces(x, scale, bias, ind2, kvw, wo, prenorm, heads, n_valid=None):
    """The Hopper body's plain pieces in its kernels' order (the pre-norm,
    pass A's chunk max and sum, the merge, pass B's un-rescaled chunk
    partials, their sum, the output projection) -> (h0, M, L, pacc)."""
    _, mean, inv = tfa._pool_ref(x, scale, bias, ind2, kvw, wo, GROUPS, heads, prenorm, n_valid)
    y = (((x.float() - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]).to(x.dtype)
         if prenorm else x)
    qft = tfa.fold_qf(ind2, kvw, heads).t()
    macc, sacc = tfa._pool_layer_merge_ref(*tfa._pool_layer_chunks_ref(y, qft, n_valid))
    part_p = tfa._pool_layer_partials_ref(y, qft, kvw, macc, sacc, heads, n_valid)
    pacc = tfa._pool_layer_sum_ref(part_p, heads)
    return (pacc.to(x.dtype).float() @ wo.float().t()).to(x.dtype), macc, sacc, pacc


def _column_stats(x, scale, bias, ind2, kvw, wo, prenorm, heads):
    """The softmax's column max and sum over all N points [B, J], as the
    plain version forms its logits."""
    _, mean, inv = tfa._pool_ref(x, scale, bias, ind2, kvw, wo, GROUPS, heads, prenorm)
    y = (((x.float() - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]).to(x.dtype)
         if prenorm else x)
    s = torch.einsum("bnc,cj->bnj", y.float(), tfa.fold_qf(ind2, kvw, heads).float())
    m = s.amax(1)
    return m, torch.exp(s - m[:, None]).sum(1)


@pytest.mark.parametrize("case", [
    (128, True, False), (128, True, True), (128, False, False), (128, False, True),
    (100, True, True), (100, False, True)],
    ids=["prenorm-plain", "prenorm-drift", "raw-plain", "raw-drift", "ragged-prenorm",
         "ragged-raw"])
def test_pool_layer_pieces_compose_to_the_plain_version_and_jax(case):
    """The Hopper body's plain pieces (``_pool_layer_chunks_ref``,
    ``_pool_layer_merge_ref``, ``_pool_layer_partials_ref``,
    ``_pool_layer_sum_ref``) compose in fp32 to h0 of the plain version
    ``_pool_ref`` and of the JAX op (``_pool_kernel`` in interpret mode, one
    ``jax.jit``) at the forward tolerances of ``test_pool_layer_matches_jax``
    (rtol 1e-4, atol 1e-5; 1e-4 with drifted logits); the merged M and L are
    the softmax's column max and sum over the N points (rtol 1e-5). A ragged
    N (100 points zero-padded to 128, one chunk holding 36 of them) gives the
    unpadded N's h0 with ``n_valid``."""
    n, prenorm, drift = case
    args = list(_pool_args(20, drift))
    x_pad = torch.from_numpy(args[0]).clone()
    x_pad[:, n:] = 0.0
    args[0] = args[0][:, :n]
    ops = [torch.from_numpy(a) for a in args]
    h0, macc, sacc, _ = _pool_layer_by_pieces(x_pad, *ops[1:], prenorm, HEADS,
                                              None if n == N else n)
    want = tfa._pool_ref(*ops, GROUPS, HEADS, prenorm)[0]
    gind = jnp.asarray(_gind())
    ref = jax.jit(lambda a: jfa.folded_pool_layer(*a, gind, HEADS, prenorm)[0])(
        tuple(map(jnp.asarray, args)))
    for r in (want, ref):
        _assert_close(h0, r, 1e-4, 1e-4 if drift else 1e-5, False, "h0")
    m, l = _column_stats(*ops, prenorm, HEADS)
    torch.testing.assert_close(macc, m, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sacc, l, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("i", [128, 256], ids=["I128", "I256"])
def test_pool_layer_takes_many_inducers_as_jax(i):
    """ROADMAP C1, the resident pool at 128 and 256 inducers: the JAX
    package's resident kernel computes there on the CPU (interpret mode; at
    this small width its VMEM gate ``pool_vmem_ok`` admits it), and the
    port's plain version and the Hopper body's pieces agree with it at the
    forward tolerances (rtol 1e-4, atol 1e-5); on the card the Hopper body
    takes these shapes at the flagship's width (``_pool_layer_body``)."""
    heads, c = 4, 64
    d = c // heads
    rng = np.random.default_rng(21)
    x = (1.5 * rng.standard_normal((1, N, c)) + 0.3 * rng.standard_normal(c)).astype(np.float32)
    args = (x, (1.0 + 0.1 * rng.standard_normal((1, c))).astype(np.float32),
            (0.1 * rng.standard_normal((1, c))).astype(np.float32),
            (rng.standard_normal((heads * i, d)) / 2).astype(np.float32),
            (rng.standard_normal((2 * c, c)) / 8).astype(np.float32),
            (rng.standard_normal((c, c)) / 8).astype(np.float32))
    assert jfa.pool_vmem_ok(N, c, heads * i)
    gind = jnp.asarray(np.array(jfa.group_indicator(c, GROUPS)))
    ref = jax.jit(lambda a: jfa.folded_pool_layer(*a, gind, heads, True))(
        tuple(map(jnp.asarray, args)))
    ops = [torch.from_numpy(a) for a in args]
    port = tfa._pool_ref(*ops, GROUPS, heads, True)
    for name, a, r in zip(("h0", "mean_c", "inv_c"), port, ref):
        _assert_close(a, r, 1e-4, 1e-5, False, name)
    _assert_close(_pool_layer_by_pieces(*ops, True, heads)[0], ref[0], 1e-4, 1e-5, False,
                  "h0 by the pieces")
    assert tfa._pool_layer_body(64, 2048, 384, 8, i) == "hopper"


@pytest.mark.parametrize("shape,want", [
    ((64, 2048, 384, 8, 64), "hopper"), ((2, 8192, 768, 16, 64), "hopper"),
    ((64, 2048, 768, 16, 64), "hopper"), ((64, 2000, 384, 8, 64), "hopper"),
    ((64, 2048, 384, 8, 16), "hopper"), ((64, 2048, 384, 8, 512), "hopper"),
    ((64, 2048, 128, 4, 64), "wmma"), ((64, 2048, 384, 3, 64), "wmma"),
    ((64, 2048, 384, 12, 240), "wmma"), ((64, 2048, 384, 12, 256), "wmma"),
    ((64, 2048, 384, 3, 256), "wmma"), ((64, 2048, 2048, 64, 64), None),
    ((64, 2048, 384, 8, 24), "hopper"), ((1, 2048, 384, 8, 16), None)],
    ids=["flagship", "8k", "8k-B64", "ragged", "I16", "I512", "demo", "three-heads",
         "wmma-I240", "wmma-I256", "three-heads-I256", "C2048", "I24", "B1-I16"])
def test_pool_layer_switch_chooses_by_shape(shape, want):
    """``_pool_layer_body``: the Hopper body at D 48 with H % 8 == 0 and C
    <= 768 at any I of 16s (the flagship's and the 8k width, any N);
    elsewhere the WMMA body, whose blocks take a head's columns whole where
    they fit the SM's shared memory (at C 384 with D 32 up to 240 of them)
    and else in column blocks (``_pool_wmma_block``: 128 of 256); a ragged
    I (24) takes the bodies of its count padded to 16s (32); a shape neither
    takes raises ValueError naming both bodies' bounds (C 2048, whose stream
    tile alone exceeds a block's shared memory; B*I % 64 != 0 at B 1, I
    16)."""
    if want is None:
        with pytest.raises(ValueError, match="no CUDA body takes"):
            tfa._pool_layer_body(*shape)
    else:
        assert tfa._pool_layer_body(*shape) == want


# ------------------------------- the Hopper backward's passes, plainly --


def _pool_layer_saved(x, scale, bias, ind2, kvw, wo, prenorm, n_valid=None):
    """What the forward saves for the backward, by the Hopper forward's
    plain pieces: mean_c, inv_c, M, L [B, J], the fp32 P [B, I, C] and the
    pre-normed stream y (x without the pre-norm)."""
    _, mean, inv = tfa._pool_ref(x, scale, bias, ind2, kvw, wo, GROUPS, HEADS, prenorm, n_valid)
    y = (((x.float() - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]).to(x.dtype)
         if prenorm else x)
    qft = tfa.fold_qf(ind2, kvw, HEADS).t()
    macc, sacc = tfa._pool_layer_merge_ref(*tfa._pool_layer_chunks_ref(y, qft, n_valid))
    part_p = tfa._pool_layer_partials_ref(y, qft, kvw, macc, sacc, HEADS, n_valid)
    return mean, inv, macc, sacc, tfa._pool_layer_sum_ref(part_p, HEADS), y


def _pool_layer_cots(seed, prenorm):
    """The cotangents of h0, mean_c and inv_c (the last two zero without the
    pre-norm, whose mean and inv are constants)."""
    rng = np.random.default_rng(seed)
    g_h0 = torch.from_numpy(rng.standard_normal((B, I, C)).astype(np.float32))
    g_mean, g_inv = (torch.from_numpy((0.1 * rng.standard_normal((B, C))).astype(np.float32))
                     * prenorm for _ in range(2))
    return g_h0, g_mean, g_inv


@pytest.mark.parametrize("case", [
    (N, True, False), (N, True, True), (N, False, False), (N, False, True),
    (100, True, True), (100, False, True)],
    ids=["prenorm-plain", "prenorm-drift", "raw-plain", "raw-drift", "ragged-prenorm",
         "ragged-raw"])
def test_pool_layer_bwd_pieces_compose_to_the_plain_version(case):
    """The Hopper backward's plain pieces (``_pool_layer_bwd_fold_ref``,
    ``_pool_layer_bwd_tiles_ref``, ``_pool_layer_bwd_dy_ref``,
    ``_pool_layer_bwd_dx_ref``, ``_pool_layer_bwd_wgrad_ref``, composed by
    ``_pool_layer_bwd_pieces`` on the forward's saved tensors) give in fp32
    every gradient of ``_pool_layer_bwd_ref`` (autograd of the plain
    version) within 1e-5 of max |ref|: the same algebra (t = sum_d dpool P
    is sum_n dp p), its roundings no-ops in fp32, its sums in other orders
    (readings up to 2.4e-6, the drifted dbias). Without the pre-norm dscale
    and dbias are exactly zero on both sides. A ragged N (100 points
    zero-padded to 128, ``n_valid``) gives the unpadded N's gradients."""
    n, prenorm, drift = case
    args = list(_pool_args(20, drift))
    x_pad = torch.from_numpy(args[0]).clone()
    x_pad[:, n:] = 0.0
    args[0] = args[0][:, :n]
    ops = [torch.from_numpy(a) for a in args]
    gind = torch.from_numpy(_gind())
    cots = _pool_layer_cots(21, prenorm)
    n_valid = None if n == N else n
    saved = _pool_layer_saved(x_pad, *ops[1:], prenorm, n_valid)
    got = tfa._pool_layer_bwd_pieces(x_pad, *ops[1:], gind, *saved, *cots, HEADS, prenorm,
                                     n_valid)
    want = tfa._pool_layer_bwd_ref(*ops, gind, *cots, HEADS, prenorm)
    for name, a, r in zip(("dx", "dscale", "dbias", "dind2", "dkvw", "dwo"), got, want):
        a = a[:, :n] if name == "dx" else a
        if not prenorm and name in ("dscale", "dbias"):
            assert not a.any() and not r.any(), name
            continue
        assert float((a - r).abs().max()) < 1e-5 * float(r.abs().max()), name


@pytest.mark.parametrize("prenorm", PRENORM, ids=["prenorm", "no-prenorm"])
def test_pool_layer_bwd_pieces_match_the_jax_kernel_in_bf16(prenorm):
    """The Hopper backward's plain pieces on bf16 operands with drifted
    logits, from the forward's saved tensors (its plain pieces), against
    ``jax.vjp`` of the JAX op (``_pool_bwd_kernel`` in interpret mode, one
    ``jax.jit``): dscale and dbias within 1e-3 of max |ref| (fp32 sums in
    other orders, ``test_pool_layer_bwd_witness_matches_the_jax_kernel_in_bf16``'
    limit), the bf16 gradients within 4e-3 of it, one bf16 step (readings
    up to 7.5e-5: the same algebra and roundings), where autograd of the
    plain version departs by ~1e-2 (bf16 p before the softmax backward)."""
    bf = torch.bfloat16
    ops = [torch.from_numpy(a).to(bf if q in (0, 3, 4, 5) else torch.float32)
           for q, a in enumerate(_pool_args(0, True))]
    g_h0, g_mean, g_inv = _pool_layer_cots(22, prenorm)
    g_h0 = g_h0.to(bf)
    gind = torch.from_numpy(_gind())
    saved = _pool_layer_saved(*ops, prenorm)
    got = tfa._pool_layer_bwd_pieces(*ops, gind, *saved, g_h0, g_mean, g_inv, HEADS, prenorm)
    jops = [jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf else jnp.float32)
            for a in ops]
    jg = jnp.asarray(_gind())
    _, ref = _jax_vjp(lambda *a: jfa.folded_pool_layer(*a, jg, HEADS, prenorm), jops,
                      (jnp.asarray(g_h0.float().numpy(), jnp.bfloat16), g_mean.numpy(),
                       g_inv.numpy()))
    for name, a, r in zip(("dx", "dscale", "dbias", "dind2", "dkvw", "dwo"), got, ref):
        r = np.asarray(r, np.float32)
        if not prenorm and name in ("dscale", "dbias"):
            assert not a.any() and not r.any(), name
            continue
        tol = 1e-3 if name in ("dscale", "dbias") else 4e-3
        assert np.abs(a.float().numpy() - r).max() < tol * np.abs(r).max(), name


@pytest.mark.parametrize("shape,want", [
    ((48, 2048, 384, 8, 64), "hopper"), ((2, 8192, 768, 16, 64), "hopper"),
    ((48, 2000, 384, 8, 64), "hopper"), ((48, 2048, 384, 8, 256), "hopper"),
    ((48, 2048, 768, 16, 256), "hopper"), ((48, 2048, 384, 8, 24), "hopper"),
    ((48, 2048, 384, 8, 976), "hopper"), ((48, 2048, 384, 3, 64), "wmma"),
    ((48, 2048, 384, 3, 256), "wmma"), ((48, 2048, 128, 4, 64), "wmma"),
    ((48, 2048, 384, 24, 64), "wmma"), ((1, 2048, 384, 8, 16), "wmma"),
    ((48, 2048, 2048, 64, 64), None)],
    ids=["flagship", "8k", "ragged", "I256", "8k-I256", "I24", "I976", "three-heads",
         "three-heads-I256", "demo", "D16", "B1-I16", "C2048"])
def test_pool_layer_bwd_switch_chooses_by_shape(shape, want):
    """``_pool_layer_bwd_body``: the Hopper body (csrc/pool_bwd.cu) at D 48
    with H % 8 == 0, C 384 or 768 and B*I % 64 == 0, any N (a ragged N
    padded) and any I by blocks of 64 columns (24 padded to 32, 976, where
    the WMMA body's tile no longer fits); elsewhere the WMMA body
    (csrc/pool_bwd_wmma.cu), three heads' D 128 at 64 and 256 inducers,
    the demo's C 128, D 16, and B*I % 64 != 0 among them; a shape neither
    takes raises ValueError naming both bodies' bounds (C 2048)."""
    if want is None:
        with pytest.raises(ValueError, match="no CUDA body takes"):
            tfa._pool_layer_bwd_body(*shape)
    else:
        assert tfa._pool_layer_bwd_body(*shape) == want
