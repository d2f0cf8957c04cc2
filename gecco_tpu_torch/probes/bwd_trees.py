"""The Hopper pool and unpool backwards at the upsample demo's and three
heads' shapes: trees side by side.

    python3 gecco_tpu_torch/probes/bwd_trees.py TREE [TREE ...]

Each TREE is the root of a checkout whose Hopper pool and unpool
backwards take these shapes (``git archive`` of a commit, or a copy with
one constant of ``csrc/pool_ext_bwd.cu`` changed, say): for each, in the
order given, a fresh process imports that tree's package (the two
backward libraries built from its own sources) and reads, at the demo's
training shapes (B 48, N 2048, C 128, 4 heads of 32, 64 inducers) and with
three heads at the flagship's width (C 384, 3 heads of 128), the Hopper
pool and unpool backwards (``_pool_ext_bwd_hopper``,
``_unpool_bwd_hopper``) on operands drawn as ``probes.pool_bwd`` and
``probes.unpool_bwd`` draw them: the device time of a call and of each of
its launches (``torch.profiler``, 5 calls after 1) and the median of 20
calls by CUDA events. Give A B B A to compare two trees in turns. Prints
one JSON line per tree and the card's name and power limit. Run by file
path, not with ``-m``. Needs the card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPES = {"demo": (48, 2048, 128, 4, 64), "three heads": (48, 2048, 384, 3, 64)}


def measure(tree: str) -> dict:
    """The readings of one tree, in this process (its package first on the
    path)."""
    sys.path.insert(0, tree)
    import torch

    from gecco_tpu_torch.ops.kernels import folded_attention as fa
    from gecco_tpu_torch.probes import pool_bwd, unpool_bwd

    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for width, (b, n, c, heads, i) in SHAPES.items():
        x, se, be, ind2, kvw, wo = pool_bwd.operands(g, b, n, c, heads, i, False, dev)
        _, qft, macc, sacc = fa._pool_ext_launch(x, se, be, ind2, kvw, wo, heads, True)
        gh = (0.1 * torch.randn(b, i, c, generator=g, device=dev)).to(x.dtype)
        uops, gg, gs = unpool_bwd.operands(g, b, n, c, heads, i, False, dev)
        for name, fn in (
                ("pool", lambda: fa._pool_ext_bwd_hopper(x, se, be, qft, kvw, wo, gh, macc, sacc,
                                                         heads)),
                ("unpool", lambda: fa._unpool_bwd_hopper(*uops, gg, gs, heads, True, True))):
            fn()
            torch.cuda.synchronize()
            split = pool_bwd.launch_split(fn)
            out[f"{name} {width}"] = {"device_ms": sum(split.values()),
                                      "event_ms": statistics.median(pool_bwd.timed(fn)),
                                      "per_launch_ms": split}
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps({"tree": sys.argv[2], **measure(os.path.abspath(sys.argv[2]))}))
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for tree in sys.argv[1:]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probes.bwd_trees on {tree}:\n{res.stdout}\n{res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
