"""The rect attention's Hopper bodies at the per-head flagship's shapes:
trees side by side.

    python3 gecco_tpu_torch/probes/rect_trees.py TREE [TREE ...]

Each TREE is the root of a checkout with the Hopper rect attention
(``git archive`` of a commit, or a copy with one constant of
``csrc/induced_attention.cu`` changed, say). First every tree's two
libraries are built, all trees at once; then for each tree, in the order
given, a fresh process imports that tree's package and reads the device
time of one call (``torch.profiler``, 5 calls after 1) and the median of
20 calls by CUDA events of ``_rect_attention_fwd_hopper`` and
``_rect_attention_bwd_hopper`` on operands drawn as ``chip_smoke.py``
draws them: the pool and the unpool at the flagship's D 48 (8 heads at C
384, 64 inducers, 2048 points; forwards at batch 64, backwards at 48),
the pool forward at D 32 and 128, and the pool forward with k and v from
two [B, N, C] tensors (rows of C) in place of the two halves of the
[B, N, 2C] projection. Give A B B A to compare two trees in turns. Prints
one JSON line per tree and the card's name and power limit. Run by file
path, not with ``-m``. Needs the card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

LIBRARIES = ("induced_attention", "induced_attention_bwd")


def measure(tree: str) -> dict:
    """The readings of one tree, in this process (its package and
    ``chip_smoke.py`` first on the path)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from gecco_tpu_torch.ops.kernels import induced_attention as ia
    from gecco_tpu_torch.probes import pool_bwd

    if not os.path.abspath(ia.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {ia.__file__}, not the tree {tree}")
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    cases = {}
    for direction in ("pool", "unpool"):
        q, k, v = cs.attn_operands(g, 64, 2048, 384, 8, 64, direction, False, dev, dt)
        cases[f"forward {direction} D 48"] = lambda q=q, k=k, v=v: ia._rect_attention_fwd_hopper(
            q, k, v)
        q, k, v = cs.attn_operands(g, 48, 2048, 384, 8, 64, direction, False, dev, dt)
        o, lse = ia._rect_attention_fwd_hopper(q, k, v)
        ops = (q, k, v, o, lse, cs.merged_randn(g, o))
        cases[f"backward {direction} D 48"] = lambda ops=ops: ia._rect_attention_bwd_hopper(*ops)
    for heads in (12, 3):
        q, k, v = cs.attn_operands(g, 64, 2048, 384, heads, 64, "pool", False, dev, dt)
        cases[f"forward pool D {384 // heads}"] = \
            lambda q=q, k=k, v=v: ia._rect_attention_fwd_hopper(q, k, v)
    q, _, _ = cs.attn_operands(g, 64, 2048, 384, 8, 64, "pool", False, dev, dt)
    k, v = (cs._split_heads(torch.randn(64, 2048, 384, generator=g, device=dev).to(dt), 8)
            for _ in range(2))
    cases["forward pool D 48, rows of C"] = lambda: ia._rect_attention_fwd_hopper(q, k, v)
    out = {}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        out[name] = {"device_ms": sum(pool_bwd.launch_split(fn).values()),
                     "event_ms": statistics.median(pool_bwd.timed(fn))}
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps({"tree": sys.argv[2], **measure(os.path.abspath(sys.argv[2]))}))
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from gecco_tpu_torch.ops.kernels import _build; "
                                f"_build.build_all({LIBRARIES!r})", tree])
              for tree in dict.fromkeys(trees)]
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("probes.rect_trees: a build failed")
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probes.rect_trees on {tree}:\n{res.stdout}\n{res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
