"""Hand-written Hopper kernels (sources in ``gecco_tpu_torch/csrc``), each
beside its plain PyTorch version. Importing this package builds nothing.

``KERNELS`` lists every wrapper that launches a kernel, forward and
backward (fourteen: eight forward, six backward); each counts its default
body's launches in ``.launches``. Twelve of them have a second body, WMMA
beside the Hopper design, chosen by shape (``folded_pool_ext``, ``fused_h_side``,
``folded_unpool``, ``fused_mlp_residual``, ``folded_pool_layer``, the three
folded backwards, ``folded_pool_layer_bwd``, ``rect_attention_fwd``,
``rect_attention_bwd`` and ``fused_unpool_mlp``): those count its launches
in ``.launches_wmma``,
reported as ``<name>_wmma``, and all twelve an fp32 route for fp32 operands
(``f32.py``, ``csrc/f32_simt.cu``), counted in ``.launches_f32`` and
reported as ``<name>_f32`` (``F32_BODIES``; the megakernel's runs the
unpool's and the MLP's, which count it). The projective gather's forward and backward
have a SIMT body beside the Hopper one (``SIMT_BODIES``), counted in
``.launches_simt`` and reported as ``<name>_simt``. The pool backward's v1,
v2 and v2j bodies (``GECCO_POOL_BWD``) count theirs in ``.launches_v1``,
``.launches_v2`` and ``.launches_v2j`` (``folded_pool_ext_bwd_v1`` ...) where
their Hopper body runs, and in ``.launches_v1_wmma`` ...
(``folded_pool_ext_bwd_v1_wmma`` ...) where their WMMA body does."""

from gecco_tpu_torch.ops.kernels.folded_attention import (
    TWOPASS_BODIES,
    folded_pool_ext,
    folded_pool_ext_bwd,
    folded_pool_layer,
    folded_pool_layer_bwd,
    folded_unpool,
    folded_unpool_bwd,
    fused_mlp_residual,
    fused_mlp_residual_bwd,
    fused_unpool_mlp,
)
from gecco_tpu_torch.ops.kernels.hside import fused_h_side
from gecco_tpu_torch.ops.kernels.induced_attention import (
    rect_attention_bwd,
    rect_attention_fwd,
    rect_attention_pallas,
)
from gecco_tpu_torch.ops.kernels.projective_gather import projective_gather, projective_gather_bwd

KERNELS = (
    folded_pool_ext, fused_h_side, folded_unpool, fused_mlp_residual, projective_gather,
    rect_attention_fwd, fused_unpool_mlp, folded_pool_layer,
    folded_pool_ext_bwd, folded_unpool_bwd, fused_mlp_residual_bwd, projective_gather_bwd,
    rect_attention_bwd, folded_pool_layer_bwd,
)


TWO_BODIES = (folded_pool_ext, fused_h_side, folded_unpool, fused_mlp_residual,
              folded_pool_layer, folded_pool_ext_bwd, folded_unpool_bwd, fused_mlp_residual_bwd,
              folded_pool_layer_bwd, rect_attention_fwd, rect_attention_bwd, fused_unpool_mlp)
SIMT_BODIES = (projective_gather, projective_gather_bwd)
# the wrappers counting an fp32 route, csrc/f32_simt.cu (ops/kernels/f32.py):
# the gather's SIMT bodies take fp32 themselves, and the megakernel's fp32
# case runs the unpool's and the MLP's routes, counted there
F32_BODIES = tuple(fn for fn in TWO_BODIES if fn is not fused_unpool_mlp)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in TWO_BODIES:
        fn.launches_wmma = 0
    for fn in SIMT_BODIES:
        fn.launches_simt = 0
    for fn in F32_BODIES:
        fn.launches_f32 = 0
    for body in TWOPASS_BODIES:
        setattr(folded_pool_ext_bwd, f"launches_{body}", 0)
        setattr(folded_pool_ext_bwd, f"launches_{body}_wmma", 0)


def launch_counts() -> dict:
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts.update({f"{fn.__name__}_wmma": fn.launches_wmma for fn in TWO_BODIES})
    counts.update({f"{fn.__name__}_simt": fn.launches_simt for fn in SIMT_BODIES})
    counts.update({f"{fn.__name__}_f32": fn.launches_f32 for fn in F32_BODIES})
    for body in TWOPASS_BODIES:
        for name in (body, f"{body}_wmma"):
            counts[f"folded_pool_ext_bwd_{name}"] = getattr(folded_pool_ext_bwd, f"launches_{name}")
    return counts


__all__ = [
    "folded_pool_ext",
    "folded_pool_ext_bwd",
    "folded_pool_layer",
    "folded_pool_layer_bwd",
    "folded_unpool",
    "folded_unpool_bwd",
    "fused_h_side",
    "fused_mlp_residual",
    "fused_mlp_residual_bwd",
    "fused_unpool_mlp",
    "projective_gather",
    "projective_gather_bwd",
    "rect_attention_bwd",
    "rect_attention_fwd",
    "rect_attention_pallas",
    "KERNELS",
    "SIMT_BODIES",
    "F32_BODIES",
    "TWO_BODIES",
    "TWOPASS_BODIES",
    "launch_counts",
    "reset_launch_counts",
]
