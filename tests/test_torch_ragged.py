"""Ragged point counts: the bodies' padded form against the plain versions
at the unpadded N, on the CPU.

On the card each fused function zero-pads the point axis of its operands
to the next multiple of 128 and hands the bodies ``n_valid = N``; the
bodies mask the padding out of every reduction over points. The plain
pieces (the bodies' structure in PyTorch) take ``n_valid`` the same way:
fed the padded operands they must compose to the plain version at N,
forward and backward, ordinary and drifted, in fp32 to rounding (1e-5 of
each output's max |ref|). Two tails: N 200 (the last 64-point chunk holds 8
points) and N 130 (a chunk with two points, then a chunk of padding alone,
as N 2050 gives on the card). The whole model at a ragged N runs against
the JAX package, whose Pallas kernels take such an N as one whole tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu_torch.ops.kernels import folded_attention as tfa
from test_torch_kernels import (
    DRIFT,
    HEADS,
    B,
    C,
    GROUPS,
    I,
    _cotangent,
    _maxrel,
    _mlp_bwd_by_pieces,
    _mlp_fwd_by_pieces,
    _pool_bwd_by_pieces,
    _unpool_bwd_by_pieces,
)
from torch_parity import f32, jax_model, jax_params, rel_err, t, torch_model
from torch_parity import jax_draws as _jax_draws
from gecco_tpu_torch.convert import to_jax_params

# the tails: N 200 pads to 256 with 56 rows of padding; N 130 pads to 256
# with one 64-point chunk holding 2 points and the last chunk all padding
TAILS = (200, 130)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pad(a, n_pad):
    return tfa._pad_points(a, n_pad)


def _ops(seed, n, drift, kind):
    """fp32 operands of one function at N points (the stream drifted per
    channel, or the pool's and unpool's logits per head)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, C)).astype(np.float32)
    se = (1.0 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
    be = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    if kind == "pool":
        ind2 = rng.standard_normal((HEADS * I, C // HEADS)).astype(np.float32)
        kvw = (rng.standard_normal((2 * C, C)) / C**0.5).astype(np.float32)
        if drift:
            kvw[:C] *= DRIFT[:, None]
        wo = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
        rest = (ind2, kvw, wo)
    elif kind == "unpool":
        k = rng.standard_normal((B, I, C)).astype(np.float32)
        if drift:
            k *= DRIFT[None, None, :]
        v = rng.standard_normal((B, I, C)).astype(np.float32)
        wq = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
        wo = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
        rest = (k, v, wq, wo)
    else:
        w = 2 * C
        if drift:
            x = x * DRIFT[None, None, :] / 10
        rest = ((rng.standard_normal((C, w)) / C**0.5).astype(np.float32),
                (0.1 * rng.standard_normal((1, w))).astype(np.float32),
                (rng.standard_normal((w, C)) / w**0.5).astype(np.float32),
                (0.1 * rng.standard_normal((1, C))).astype(np.float32))
    return [torch.from_numpy(a) for a in (x, se, be, *rest)]


def _check(got, want, names):
    for name, a, r in zip(names, got, want):
        assert a.shape == r.shape, name
        if r.any():
            assert _maxrel(a.detach().numpy(), r.detach().numpy()) < TOL, name
        else:  # the raw pool's constant statistics, its unused affine
            assert torch.equal(a, r), name


def test_padding_keeps_a_multiple_of_128_as_it_is():
    """N % 128 == 0 takes no pad and no copy; any other N pads with zeros
    to the next multiple of 128, and the slice back is the original."""
    x = torch.randn(2, 256, 8)
    assert tfa._n_pad(256) == 256 and tfa._pad_points(x, 256) is x
    assert tfa._unpad(x, 256) is x and tfa._valid_rows(256, 256, "cpu") is None
    assert [tfa._n_pad(n) for n in (1, 127, 129, 2000, 2050)] == [128, 128, 256, 2048, 2176]
    y = torch.randn(2, 200, 8)
    p = tfa._pad_points(y, 256)
    assert p.shape == (2, 256, 8) and not p[:, 200:].any()
    assert torch.equal(tfa._unpad(p, 200), y) and tfa._unpad(p, 200).is_contiguous()


@pytest.mark.parametrize("n", TAILS)
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_pieces_take_a_ragged_tail(n, drift):
    """The pool forward's pieces on the padded stream with n_valid = N
    compose to ``_pool_ext_ref`` at N: the chunk partials leave the padding
    out of the column max, the sum and P (a chunk of padding alone gives
    m = -inf, l = 0, P = 0, and the merge takes nothing from it), and the
    softmax statistics equal those at N."""
    x, se, be, ind2, kvw, wo = _ops(40, n, drift, "pool")
    n_pad = tfa._n_pad(n)
    qft = tfa._fold_qft_ref(ind2, kvw, HEADS)
    m, l, p = tfa._pool_partials_ref(_pad(x, n_pad), se, be, qft, kvw, HEADS, n)
    if n == 130:  # the last chunk holds no point
        assert torch.isneginf(m[:, -1]).all() and not l[:, -1].any() and not p[:, -1].any()
    h0, mm, ll = tfa._pool_merge_ref(m, l, p, wo, HEADS)
    assert torch.isfinite(h0).all()
    _check([h0], [tfa._pool_ext_ref(x, se, be, ind2, kvw, wo, HEADS)], ["h0"])
    s = torch.einsum("bnc,jc->bnj", tfa._prenormed(x, se, be), qft)
    m_ref = s.amax(1)
    l_ref = torch.exp(torch.clamp(s - m_ref[:, None], min=-80.0)).sum(1)
    _check([mm, ll], [m_ref, l_ref], ["macc", "sacc"])


@pytest.mark.parametrize("n", TAILS)
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_pool_bwd_pieces_take_a_ragged_tail(n, drift):
    """The pool backward's pieces on the padded stream (e and ds zero on
    the padding) compose to autograd of the plain version at N: dx on the
    N points, dse, dbe and the weights' gradients unchanged by the
    padding."""
    ops = _ops(41, n, drift, "pool")
    g_h0 = torch.from_numpy(_cotangent(np.random.default_rng(42), B, I, C))
    n_pad = tfa._n_pad(n)
    x, se, be, ind2, kvw, wo = ops
    qft = tfa._fold_qft_ref(ind2, kvw, HEADS)
    xp = _pad(x, n_pad)
    _, macc, sacc = tfa._pool_merge_ref(*tfa._pool_partials_ref(xp, se, be, qft, kvw, HEADS, n),
                                        wo, HEADS)
    ety = tfa._pool_bwd_ety_ref(xp, se, be, qft, macc, n)
    tacc, w3, dwv, dwo = tfa._pool_bwd_fold_ref(ety, g_h0, kvw, wo, sacc, HEADS)
    dx, dse, dbe, ds = tfa._pool_bwd_dy_ref(xp, se, be, qft, w3, macc, tacc, n)
    assert not ds[:, n:].any() and not dx[:, n:].any()
    dqf = tfa._pool_bwd_dqf_ref(xp, se, be, ds)
    got = (dx[:, :n], dse, dbe, *tfa._chain_dqf(dqf, dwv, ind2, kvw, HEADS), dwo)
    _check(got, tfa._pool_ext_bwd_ref(*ops, g_h0, HEADS),
           ("dx", "dse", "dbe", "dind2", "dkvw", "dwo"))
    # at N % 128 == 0 the padded form is the unpadded one
    full = _ops(41, n_pad, drift, "pool")
    _check(_pool_bwd_by_pieces(*full, g_h0, HEADS), tfa._pool_ext_bwd_ref(*full, g_h0, HEADS),
           ("dx", "dse", "dbe", "dind2", "dkvw", "dwo"))


@pytest.mark.parametrize("n", TAILS)
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_unpool_pieces_take_a_ragged_tail(n, drift):
    """The unpool's pieces on the padded stream leave the padding out of
    the output's channel sums; the backward's point-wise passes give the
    padding no share of the sums' cotangent, so d_attn, ds and dy are zero
    there and the weights' gradients are those at N."""
    x, se, be, k, v, wq, wo = ops = _ops(43, n, drift, "unpool")
    rng = np.random.default_rng(44)
    g = torch.from_numpy(_cotangent(rng, B, n, C))
    g_sums = torch.from_numpy(_cotangent(rng, B, 2, C, scale=1e-2))
    n_pad = tfa._n_pad(n)
    xp = _pad(x, n_pad)
    kft, vft, brow = tfa._unpool_fold_ref(se, be, k, v, wq, wo, HEADS)
    out, sums = tfa._unpool_tiles_ref(xp, kft, vft, brow, HEADS, n_valid=n)
    _check([out[:, :n], sums], tfa._unpool_ref(*ops, HEADS), ("out", "sums"))
    kfb, vfb = tfa._unpool_bwd_fold_ref(k, v, wq, wo, HEADS)
    p, ds, d_attn, dx, dse, dbe = tfa._unpool_bwd_tiles_ref(xp, se, be, kfb, vfb, _pad(g, n_pad),
                                                            g_sums, HEADS, n_valid=n)
    assert not d_attn[:, n:].any() and not ds[:, n:].any()
    dkf, dvf = tfa._unpool_bwd_wgrad_ref(xp, se, be, p, ds, d_attn)
    got = (dx[:, :n], dse, dbe, *tfa._chain_unpool(dkf, dvf, k, v, wq, wo, HEADS))
    _check(got, tfa._unpool_bwd_ref(*ops, g, g_sums, HEADS),
           ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo"))
    full = _ops(43, n_pad, drift, "unpool")
    gf = torch.from_numpy(_cotangent(np.random.default_rng(45), B, n_pad, C))
    _check(_unpool_bwd_by_pieces(*full, gf, g_sums, HEADS),
           tfa._unpool_bwd_ref(*full, gf, g_sums, HEADS), ("dx", "dse", "dbe", "dk", "dv"))


@pytest.mark.parametrize("n", TAILS)
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_mlp_pieces_take_a_ragged_tail(n, drift):
    """The MLP's pieces on the padded stream: the output pass leaves the
    padding out of its sums, the grad pass gives it no share of the sums'
    cotangent (g' is the padded g, zero), so db1, db2, dse, dbe and both
    weight gradients are those at N."""
    x, se, be, w1t, b1, w2t, b2 = ops = _ops(46, n, drift, "mlp")
    rng = np.random.default_rng(47)
    g = torch.from_numpy(_cotangent(rng, B, n, C))
    g_sums = torch.from_numpy(_cotangent(rng, B, 2, C, scale=1e-2))
    n_pad = tfa._n_pad(n)
    xp, gp_in = _pad(x, n_pad), _pad(g, n_pad)
    y = tfa._prenormed(xp, se, be).to(x.dtype)
    a = tfa._mlp_act_ref(y, w1t, b1)
    out, sums = tfa._mlp_out_ref(xp, a, w2t, b2, n_valid=n)
    _check([out[:, :n], sums], tfa._mlp_ref(*ops), ("out", "sums"))
    gp, gb, db2 = tfa._mlp_bwd_grad_ref(xp, a, w2t, b2, gp_in, g_sums, n_valid=n)
    assert not gp[:, n:].any()
    dh, db1 = tfa._mlp_bwd_dh_ref(y, w1t, b1, w2t, gb)
    dx, dse, dbe = tfa._mlp_bwd_dx_ref(xp, se, w1t, dh, gp)
    dw1t, dw2t = tfa._mlp_bwd_wgrad_ref(y, a, dh, gb)
    _check((dx[:, :n], dse, dbe, dw1t, db1, dw2t, db2), tfa._mlp_bwd_ref(*ops, g, g_sums),
           ("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2"))
    full = _ops(46, n_pad, drift, "mlp")
    gf = torch.from_numpy(_cotangent(np.random.default_rng(48), B, n_pad, C))
    _check([*_mlp_fwd_by_pieces(*full), *_mlp_bwd_by_pieces(*full, gf, g_sums)],
           [*tfa._mlp_ref(*full), *tfa._mlp_bwd_ref(*full, gf, g_sums)],
           ("out", "sums", "dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2"))


@pytest.mark.parametrize("n", TAILS)
@pytest.mark.parametrize("prenorm", [True, False], ids=["prenorm", "raw"])
def test_resident_pool_takes_a_ragged_tail(n, prenorm):
    """The resident pool's plain version in the kernels' padded form (the
    statistics count n_valid points, the softmax masks the padding) gives
    h0 and the GroupNorm statistics at N, and autograd through it the
    gradients at N, drifted logits and nonzero cotangents of all three
    outputs."""
    x, scale, bias, ind2, kvw, wo = _ops(49, n, True, "pool")
    n_pad = tfa._n_pad(n)
    rng = np.random.default_rng(50)
    cots = [torch.from_numpy(_cotangent(rng, *s)) for s in ((B, I, C), (B, C), (B, C))]
    args = (scale, bias, ind2, kvw, wo)
    ref_out = tfa._pool_ref(x, *args, GROUPS, HEADS, prenorm)
    pad_out = tfa._pool_ref(_pad(x, n_pad), *args, GROUPS, HEADS, prenorm, n)
    _check(pad_out, ref_out, ("h0", "mean_c", "inv_c"))
    ref = tfa._pool_layer_bwd_ref(x, *args, torch.zeros(C, GROUPS), *cots, HEADS, prenorm)
    xp = _pad(x, n_pad).requires_grad_()
    leaves = [a.clone().requires_grad_() for a in args]
    outs = tfa._pool_ref(xp, *leaves, GROUPS, HEADS, prenorm, n)
    used = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in used], [xp, *leaves], [c for _, c in used],
                                allow_unused=True)
    got = [grads[0][:, :n]] + [torch.zeros_like(a) if gr is None else gr
                               for a, gr in zip(args, grads[1:])]
    _check(got, ref, ("dx", "dscale", "dbias", "dind2", "dkvw", "dwo"))


def test_the_switches_take_the_configs_widths_at_any_point_count():
    """Every body switch takes the flagship's, the 8k width's and the
    demo's widths at ragged point counts with the bodies it takes at the
    padded count (the N of the bodies' conditions is the padded one)."""
    for shape in ((48, 2048, 384, 8, 64), (2, 8192, 768, 16, 64), (48, 2048, 128, 4, 64)):
        b, n, c, h, i = shape
        for m in (1, 200, n - 48, n + 2):
            for switch in (tfa._pool_ext_body, tfa._unpool_body, tfa._pool_ext_bwd_body,
                           tfa._unpool_bwd_body):
                assert switch(b, m, c, h, i) == switch(b, tfa._n_pad(m), c, h, i)
            for switch in (tfa._mlp_body, tfa._mlp_bwd_body):
                assert switch(b, m, c, 2 * c) == switch(b, tfa._n_pad(m), c, 2 * c)


# ------------------------------------------------------- the whole model --

RAGGED = (2, 200, 3)


def test_ragged_sample_matches_jax():
    """The small flagship-shaped model on ``folded_pallas`` samples 8 steps
    at N 200 from one latent as the JAX package does (its Pallas kernels
    in interpret mode take N 200 as one whole tile): fp32, within 1e-4 of
    the largest value, as at N 128 (test_torch_sample.py)."""
    jm = jax_model("folded_pallas", n_steps=8)
    details = jm.sample(jax.random.PRNGKey(11), RAGGED, return_details=True)
    tm = torch_model(jm, "folded_pallas", n_steps=8)
    ours = tm.sample_from_latent(t(details.latent), return_details=True)
    assert ours.sample_data.shape == RAGGED
    assert rel_err(ours.sample_data, details.sample_data) < 1e-4
    np.testing.assert_array_equal(f32(ours.latent), f32(details.latent))


def test_ragged_loss_gradient_matches_jax():
    """One loss gradient of the same model at N 200 against ``jax.grad`` of
    the JAX loss on the same draws: fp32, the loss within 1e-5 and each
    gradient within 1e-4 of its max |ref|, as at N 256
    (test_torch_train.py)."""
    jm = jax_model("folded_pallas")
    tm = torch_model(jm, "folded_pallas")
    points = (0.35 * np.random.default_rng(5).standard_normal(RAGGED)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jloss, jgrads = jax.value_and_grad(lambda m: m.loss(jnp.asarray(points), None, key))(jm)
    sigma, noise = _jax_draws(jm, points, key)
    loss = tm.loss_from(t(points), t(sigma), t(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    for name, g in ref.items():
        if np.abs(g).max() > 0:
            assert _maxrel(ours[name], g) < 1e-4, name
