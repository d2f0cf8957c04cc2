"""The h-side's Hopper body in plain PyTorch: its pass pieces against the
plain version and the JAX package's, on the CPU.

``csrc/hside.cu`` runs the h-side as five passes over all B I token rows
(norm_1, the act product, the out product with its 16-row slab sums,
norm_2 from those sums, one [k | v] product). Their plain pieces
(``_hside_norm_ref``, ``_mlp_act_ref``, ``_hside_out_ref``,
``_hside_kv_ref``) composed in the kernel's order must give ``_hside_ref``
and the JAX package's ``_hside_ref``: in fp32 to rounding (1e-5 of each
output's max |ref|), in bf16 within a few bf16 steps (every rounding point
is the plain version's: y1, g, h, k, v; the slab sums add the same fp32
values in another order). The body takes any I of 16s: I 80 and 128 too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu.ops.pallas import hside as jhs
from gecco_tpu_torch.ops.kernels import folded_attention as tfa
from gecco_tpu_torch.ops.kernels import hside as ths

C, B, GROUPS = 64, 2, 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _args(seed, i, drift):
    """The h-side's operands at I inducers (the tokens scaled per channel by
    60, 1, 0.1, 0.01 in turn where ``drift``)."""
    rng = np.random.default_rng(seed)
    w = 2 * C
    h0 = rng.standard_normal((B, i, C)).astype(np.float32)
    if drift:
        h0 *= np.tile(np.array([60.0, 1.0, 0.1, 0.01], np.float32), C // 4)
    aff = [(1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32) if q % 2 == 0
           else (0.2 * rng.standard_normal((B, C))).astype(np.float32) for q in range(4)]
    gind = np.array(jfa.group_indicator(C, GROUPS))
    w1t = (rng.standard_normal((C, w)) / C**0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((1, w))).astype(np.float32)
    w2t = (rng.standard_normal((w, C)) / w**0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((1, C))).astype(np.float32)
    wk = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    wv = (rng.standard_normal((C, C)) / C**0.5).astype(np.float32)
    return (h0, *aff, gind, w1t, b1, w2t, b2, wk, wv)


def _by_pieces(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv):
    """The Hopper body's passes in its order: norm_1, act, out (hh and the
    slab sums), norm_2 from the slabs, [k | v]."""
    groups, dt = gind.shape[1], h0.dtype
    y1 = ths._hside_norm_ref(h0, s1, b1n, groups, dt)
    g = tfa._mlp_act_ref(y1, w1t, b1)
    hh, slabs = ths._hside_out_ref(g, w2t, b2)
    h = ths._hside_norm_ref(hh, s2, b2n, groups, dt, sums=slabs.sum(1))
    return (h, *ths._hside_kv_ref(h, wk, wv))


def _maxrel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("i", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("drift", [False, True], ids=["plain", "drift"])
def test_hside_pieces_compose_to_the_plain_version(i, drift):
    """In fp32 the pieces give the port's and the JAX package's
    ``_hside_ref`` (h, k, v) within 1e-5 of max |ref|, at every I of 16s
    (above 64 too: the Hopper body's shapes), ordinary and drifted."""
    args = _args(30 + i, i, drift)
    ops = [torch.from_numpy(a) for a in args]
    got = _by_pieces(*ops)
    for ref in (ths._hside_ref(*ops), jhs._hside_ref(*map(jnp.asarray, args))):
        for name, a, r in zip("hkv", got, ref):
            assert _maxrel(a.numpy(), np.asarray(r)) < 1e-5, name


def test_hside_pieces_round_as_the_plain_version_in_bf16():
    """On bf16 tokens and weights the pieces round y1, g, h, k and v where
    the plain version does: within a few bf16 steps (2^-8) of max |ref|."""
    bf = torch.bfloat16
    ops = [torch.from_numpy(a).to(bf if q in (0, 6, 8, 10, 11) else torch.float32)
           for q, a in enumerate(_args(50, 64, True))]
    for name, a, r in zip("hkv", _by_pieces(*ops), ths._hside_ref(*ops)):
        assert a.dtype == bf
        assert _maxrel(a.float().numpy(), r.float().numpy()) < 2e-2, name


def test_hside_slab_sums_are_the_out_pass_rows():
    """The out pass's slab sums are each 16 rows' sums of hh and hh^2, and
    added per set they are the channel sums norm_2's statistics read."""
    ops = [torch.from_numpy(a) for a in _args(51, 48, False)]
    g = tfa._mlp_act_ref(torch.randn(B, 48, C), ops[6], ops[7])
    hh, slabs = ths._hside_out_ref(g, ops[8], ops[9])
    assert slabs.shape == (B, 3, 2, C)
    torch.testing.assert_close(slabs[:, 1, 0], hh[:, 16:32].sum(1))
    torch.testing.assert_close(slabs.sum(1)[:, 1], (hh * hh).sum(1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,body", [
    ((64, 384, 768, 32), "hopper"),   # the flagship
    ((64, 768, 1536, 32), "hopper"),  # the 8k width
    ((64, 128, 256, 32), "hopper"),   # the upsample demo
    ((16, 384, 768, 32), "hopper"),   # 16 inducers
    ((128, 384, 768, 32), "hopper"),  # more than 64 inducers
    ((64, 192, 384, 32), "wmma"),     # C % 128 != 0
    ((64, 48, 128, 8), "wmma"),       # C % 128 != 0
    ((128, 192, 384, 32), None),      # neither: I > 64 and C % 128 != 0
    ((20, 384, 768, 32), "hopper"),   # I % 16 != 0: zero-padded to 32
    ((20, 192, 384, 32), None),       # neither: I % 16 != 0 and C % 128 != 0
], ids=["flagship", "8k", "demo", "I16", "I128", "C192", "C48", "none-I128-C192", "I20",
        "none-I20-C192"])
def test_hside_body_switch_chooses_by_shape(shape, body):
    """The h-side picks its Hopper body wherever it takes the shape (every
    configuration's, and a ragged I padded to 16s), its WMMA body where
    only that one does, and raises naming both bodies' conditions
    otherwise."""
    if body is None:
        with pytest.raises(ValueError, match="Hopper body .* WMMA body"):
            ths._hside_body(*shape)
    else:
        assert ths._hside_body(*shape) == body
