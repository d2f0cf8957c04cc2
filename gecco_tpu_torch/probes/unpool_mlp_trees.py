"""The unpool + MLP megakernel's Hopper body at the flagship's shapes: trees
side by side.

    python3 gecco_tpu_torch/probes/unpool_mlp_trees.py TREE [TREE ...]

Each TREE is the root of a checkout with the Hopper megakernel (``git
archive`` of a commit, or a copy with one constant of ``csrc/unpool_mlp.cu``
changed, say). First every tree's library is built, all trees at once;
then for each tree, in the order given, a fresh process imports that tree's
package and reads the device time of one call (``torch.profiler``, 5 calls
after 1, split by launch) and the median of 20 calls by CUDA events of the
Hopper body (``_unpool_mlp_launch(..., body="hopper")``) on operands drawn
as ``chip_smoke.py``'s megakernel phase draws them: B 64, N 2048, C 384, 8
heads of 48, 64 inducers, W 768, bf16. Give A B B A to compare two trees in
turns. Prints one JSON line per tree and the card's name and power limit.
Run by file path, not with ``-m``. Needs the card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

LIBRARIES = ("unpool_mlp",)


def measure(tree: str) -> dict:
    """The readings of one tree, in this process (its package and
    ``chip_smoke.py`` first on the path)."""
    sys.path.insert(0, tree)
    import torch

    from chip_smoke import GROUPS
    from gecco_tpu_torch.ops.kernels import folded_attention as fa
    from gecco_tpu_torch.probes import pool_bwd
    from gecco_tpu_torch.probes.unpool_mlp import HEADS, operands

    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    ops, mlp = operands(g, 64, 2048, False, dev)
    gind = fa.group_indicator(ops[0].shape[2], GROUPS, dev)
    fn = lambda: fa._unpool_mlp_launch(*ops, gind, *mlp, HEADS, GROUPS, 2048, body="hopper")
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        split = pool_bwd.launch_split(fn)
        return {"device_ms": sum(split.values()), "per_launch_ms": split,
                "event_ms": statistics.median(pool_bwd.timed(fn))}


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
        raise RuntimeError("probes.unpool_mlp_trees: a build failed")
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probes.unpool_mlp_trees on {tree}:\n{res.stdout}\n{res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
