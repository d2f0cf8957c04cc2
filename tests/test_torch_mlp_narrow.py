"""The fused MLP at the upsample demo's width (C 128, W 256): the port's
``fused_mlp_residual`` and its gradients against the JAX package's, and
the plain pieces of the two Hopper bodies that take this width on the card
(``csrc/mlp_narrow.cu``'s tiles and fixed-order sums; ``csrc/mlp_bwd.cu``'s
passes at 128 columns) against the plain versions, at N 256 and a ragged
N 200 (the bodies see it zero-padded to 256 with ``n_valid`` 200)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu_torch.ops import kernels
from gecco_tpu_torch.ops.kernels import folded_attention as tfa

C, W, B = 128, 256, 2
NS = (256, 200)
RTOL, ATOL = 1e-4, 1e-5
# the drift case scales the stream per channel (60, 1, 0.1, 0.01 in turn,
# divided by 10), as test_torch_kernels.py's MLP backward test does
DRIFT = np.repeat(np.array([60.0, 1.0, 0.1, 0.01], np.float32), C // 4)
CASES = [(n, drift) for n in NS for drift in (False, True)]
IDS = [f"N{n}-{'drift' if drift else 'plain'}" for n, drift in CASES]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _args(seed, n, drift):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, C)).astype(np.float32)
    if drift:
        x = x * DRIFT[None, None, :] / 10
    se = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    be = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    w1t = (rng.standard_normal((C, W)) / C**0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((1, W))).astype(np.float32)
    w2t = (rng.standard_normal((W, C)) / W**0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((1, C))).astype(np.float32)
    return [x, se, be, w1t, b1, w2t, b2]


def _cotangents(seed, n):
    """The output's cotangent and a nonzero one of the sums."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, C)).astype(np.float32),
            (1e-2 * rng.standard_normal((B, 2, C))).astype(np.float32))


def _maxrel(a, ref) -> float:
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n,drift", CASES, ids=IDS)
def test_demo_width_mlp_and_gradients_match_jax(n, drift):
    """Outputs and gradients through both outputs (the sums' cotangent
    nonzero) against the JAX op (its Pallas kernels in interpret mode) and
    its ``_mlp_ref``, each side's outputs and vjp in one ``jax.jit``; the
    tolerances of test_torch_kernels.py's MLP forward (outputs; sums rtol
    and atol 1e-3) and backward (rtol and atol 2e-4, the absolute one 2e-5
    of max |ref| in the drift case) tests."""
    args = _args(30, n, drift)
    cots = _cotangents(31, n)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, sums = tfa.fused_mlp_residual(*leaves)
    torch.autograd.backward([out, sums], [torch.from_numpy(c) for c in cots])

    def jax_side(fn):
        def run(a, c):
            outs, vjp = jax.vjp(fn, *a)
            return outs, vjp(c)
        return jax.jit(run)([jnp.asarray(a) for a in args], tuple(map(jnp.asarray, cots)))

    for fn in (jfa.fused_mlp_residual, jfa._mlp_ref):
        (ref_out, ref_sums), ref_grads = jax_side(fn)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=RTOL,
                                   atol=1e-4 if drift else ATOL)
        np.testing.assert_allclose(sums.detach().numpy(), np.asarray(ref_sums), rtol=1e-3,
                                   atol=1e-3)
        for q, (leaf, r) in enumerate(zip(leaves, ref_grads)):
            r = np.asarray(r)
            atol = max(2e-4, 2e-5 * float(np.abs(r).max())) if drift else 2e-4
            np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=2e-4, atol=atol,
                                       err_msg=f"gradient of argument {q}")


def _padded(args, n):
    """x zero-padded on its point axis to the bodies' 128s."""
    return [tfa._pad_points(args[0], tfa._n_pad(n)), *args[1:]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,drift", CASES, ids=IDS)
def test_narrow_pieces_compose_to_the_plain_version(n, drift, dtype):
    """``mlp_narrow_kernel``'s plain piece (out and each 128-point tile's
    column sums in the kernel's order, the padding rows left out) and
    ``mlp_colsum_kernel``'s (each batch element's tiles in order) compose
    to ``_mlp_ref``: in fp32 within 1e-5 of max |ref|; in bf16 (the same
    roundings: y, g, the output) within 1e-3 of max |ref| for out, 1e-5 for
    the fp32 sums."""
    dt = getattr(torch, dtype)
    ops = [torch.from_numpy(a).to(dt if q in (0, 3, 5) else torch.float32)
           for q, a in enumerate(_args(32, n, drift))]
    out, part = tfa._mlp_narrow_tiles_ref(*_padded(ops, n), n_valid=n)
    assert part.shape == (B * tfa._n_pad(n) // 128, 2, C) and part.dtype == torch.float32
    sums = tfa._mlp_colsum_ref(part, B)
    r_out, r_sums = tfa._mlp_ref(*ops)
    assert _maxrel(out[:, :n].float().numpy(), r_out.float().numpy()) < (
        1e-5 if dtype == "float32" else 1e-3)
    assert _maxrel(sums.numpy(), r_sums.numpy()) < 1e-5
    if n % 128:
        # the padding rows' outputs are computed, but none reaches a sum
        assert bool(torch.isfinite(out[:, n:].float()).all())


def test_fixed_order_sums_are_the_kernels_order():
    """``_tile_sums`` adds a tile's rows as the Hopper epilogues do (rows r
    and r + 8, the row groups pairwise, the warps in turn) and
    ``_mlp_colsum_ref`` the tiles as ``mlp_colsum_kernel`` does (every
    eighth tile in turn per lane, then the lanes): on integers, exact."""
    u = torch.arange(2 * 128 * 3, dtype=torch.float32).reshape(256, 3)
    assert torch.equal(tfa._tile_sums(u), u.reshape(2, 128, 3).sum(1))
    part = torch.arange(2 * 11 * 2 * 3, dtype=torch.float32).reshape(22, 2, 3)
    assert torch.equal(tfa._mlp_colsum_ref(part, 2), part.reshape(2, 11, 2, 3).sum(1))


def _bwd_by_pieces(x, se, be, w1t, b1, w2t, b2, g, g_sums, n_valid):
    """csrc/mlp_bwd.cu's passes (their 128-column instances at this width:
    the same algebra as the 192-column ones) in plain pieces, on operands
    padded to the 128-row block, the points from n_valid on padding."""
    y = tfa._prenormed(x, se, be).to(x.dtype)
    a = tfa._mlp_act_ref(y, w1t, b1)
    gp, gb, db2 = tfa._mlp_bwd_grad_ref(x, a, w2t, b2, g, g_sums, n_valid)
    dh, db1 = tfa._mlp_bwd_dh_ref(y, w1t, b1, w2t, gb)
    dx, dse, dbe = tfa._mlp_bwd_dx_ref(x, se, w1t, dh, gp)
    dw1t, dw2t = tfa._mlp_bwd_wgrad_ref(y, a, dh, gb)
    return dx[:, :n_valid], dse, dbe, dw1t, db1, dw2t, db2


@pytest.mark.parametrize("n,drift", CASES, ids=IDS)
def test_bwd_pieces_at_128_columns_compose_to_the_plain_backward(n, drift):
    """In fp32 (every bf16 rounding of the passes' algebra a no-op) the
    backward's pass pieces on the padded operands compose to autograd of
    the plain version at N, a nonzero sums cotangent, within 1e-5 of each
    gradient's max |ref|."""
    ops = [torch.from_numpy(a) for a in _args(33, n, drift)]
    g, g_sums = map(torch.from_numpy, _cotangents(34, n))
    n_pad = tfa._n_pad(n)
    got = _bwd_by_pieces(*_padded(ops, n), tfa._pad_points(g, n_pad), g_sums, n)
    want = tfa._mlp_bwd_ref(*ops, g, g_sums)
    for name, a, r in zip(("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2"), got, want):
        assert _maxrel(a.numpy(), r.numpy()) < 1e-5, name


@pytest.mark.parametrize("w,fwd,bwd", [(256, "narrow", "hopper"), (128, "narrow", "hopper"),
                                       (192, "wmma", "wmma"), (384, "hopper", "hopper")],
                         ids=["W256", "W128", "W192", "W384"])
def test_demo_width_switches(w, fwd, bwd):
    """At C 128 the narrow forward takes W 128 and 256 (both weights fit in
    shared memory beside the ring), the 128-column passes every W % 128,
    the WMMA bodies the rest; any point count takes its padded count's
    bodies; CPU tensors run the plain version and count no launch."""
    for n in (1, 200, 2000, 2048):
        assert tfa._mlp_body(48, n, C, w) == fwd
        assert tfa._mlp_bwd_body(48, n, C, w) == bwd
    assert tfa._mlp_body(48, 2048, C, w, torch.float32) == "f32"
    kernels.reset_launch_counts()
    ops = [torch.from_numpy(a) for a in _args(35, 200, False)]
    tfa.fused_mlp_residual(*ops)
    assert kernels.launch_counts()["fused_mlp_residual_narrow"] == 0
