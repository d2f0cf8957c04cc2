"""Whether two source trees build the same machine code for the pool and
unpool forwards' and backwards' flagship and 8k-width kernels, the unpool's
fold, the rect attention's WMMA bodies, the megakernel's WMMA body, the
projective gather's Hopper bodies and every ``mlp_gemm`` instance of
``csrc/mlp_hopper.cuh`` that predates its 128-column ones (the MLP's, the
h-side's, the two-pass pool backward's and the resident pool backward's).

    python3 gecco_tpu_torch/probes/sass.py PARENT CHANGE

Each argument is the root of a checkout whose libraries are built (run
``chip_smoke.py`` or ``probes/trees.py`` there first). For each kernel
below, found by name in PARENT's library and in CHANGE's (a pair names
both: a parent from before the megakernel's WMMA body moved to
``unpool_mlp_wmma.cu`` has it in ``unpool_mlp``), this reads both libraries'
SASS with ``cuobjdump -sass``, drops the addresses and encodings, and
prints whether the instruction lists are identical (and the first few
instructions that differ). Needs the CUDA toolkit (the card's machine);
run by file path.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

# (library in PARENT, library in CHANGE, kernel), by the mangled names'
# identifiers and template arguments: the flagship's and the 8k width's
# chunk kernel (D 48, 8 heads a block, without and with the ragged mask),
# merge and tile kernels (384 and 192 columns a block); the pool
# backward's pass-0 and pass-1 kernels (384 columns a block, J in chunks of
# 64 rows at C 384 and 32 at 768, without and with the mask), the unpool
# backward's heads and rows kernels (384 columns a block), and the weight
# gradients' kernel (no row tail) in both backwards' libraries; every
# instance of the rect attention's WMMA bodies, forward (head width 16 DT)
# and backward (DT, and the DT of a column slice); the unpool's three fold
# kernels; both instances of the megakernel's WMMA body (64- and 32-point
# tiles); the gather's Hopper forward and its backward's three kernels (the
# SIMT bodies are templated on the element type since they took fp32, so
# their code is new); the mlp_gemm kernels of the 192-column (and the dual
# and 64-column) instances, by their names
PAIRS = (
    ("pool_ext", "pool_ext", "17pool_chunk_kernelILi48ELi8ELb0E"),
    ("pool_ext", "pool_ext", "17pool_chunk_kernelILi48ELi8ELb1E"),
    ("pool_ext", "pool_ext", "17pool_merge_kernelILi48EEEvPKf"),
    ("unpool", "unpool", "18unpool_tile_kernelILi192E"),
    ("unpool", "unpool", "18unpool_tile_kernelILi96E"),
    *(("pool_ext_bwd", "pool_ext_bwd", f"19pool_bwd_ety_kernelILi384ELb{m}E") for m in (0, 1)),
    *(("pool_ext_bwd", "pool_ext_bwd", f"18pool_bwd_dy_kernelILi384ELi{jc}ELb{m}E")
      for jc in (64, 32) for m in (0, 1)),
    ("pool_ext_bwd", "pool_ext_bwd", "12wgrad_kernelILb0EE"),
    *(("unpool_bwd", "unpool_bwd", f"23unpool_bwd_heads_kernelILi{m}E") for m in (0, 1)),
    *(("unpool_bwd", "unpool_bwd", f"22unpool_bwd_rows_kernelILi{m}ELi192E") for m in (0, 1)),
    ("unpool_bwd", "unpool_bwd", "12wgrad_kernelILb0EE"),
    *(("induced_attention_wmma", "induced_attention_wmma", f"20rect_attn_fwd_kernelILi{dt}E")
      for dt in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16)),
    *(("induced_attention_bwd_wmma", "induced_attention_bwd_wmma",
       f"20rect_attn_bwd_kernelILi{dt}ELi{st}E")
      for dt, st in ((1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (7, 7), (8, 8), (12, 12),
                     (16, 8))),
    *(("unpool", "unpool", name) for name in ("16unpool_bq_kernel", "20unpool_fold_k_kernel",
                                              "20unpool_fold_v_kernel")),
    *(("unpool_mlp_wmma", "unpool_mlp_wmma", f"17unpool_mlp_kernelILi{rows}E")
      for rows in (4, 2)),
    *(("projective_gather", "projective_gather", name)
      for name in ("17gather_fwd_kernelE", "17gather_bin_kernelE", "19gather_pixel_kernelE",
                   "19gather_coord_kernelE")),
    *(("mlp", "mlp", name) for name in ("14mlp_act_kernel", "14mlp_out_kernel")),
    *(("mlp_bwd", "mlp_bwd", name)
      for name in ("18mlp_bwd_act_kernel", "19mlp_bwd_grad_kernel", "17mlp_bwd_dh_kernel",
                   "17mlp_bwd_dx_kernel")),
    *(("hside", "hside", name)
      for name in ("16hside_act_kernel", "16hside_out_kernel", "15hside_kv_kernel")),
    *(("pool_ext_bwd_twopass", "pool_ext_bwd_twopass", name)
      for name in ("16twopass_s_kernel", "18twopass_s64_kernel", "16twopass_v_kernel",
                   "17twopass_dy_kernel")),
    *(("pool_bwd", "pool_bwd", name)
      for name in ("22layer_bwd_dpool_kernel", "19layer_bwd_dy_kernel")),
)

@functools.lru_cache(maxsize=None)
def functions(tree: str, lib: str) -> dict:
    """Mangled name -> the function's SASS instructions, without addresses
    or encodings, from the tree's built library."""
    built = [p for p in (Path(tree) / "gecco_tpu_torch" / "_build").glob(f"lib{lib}_*.so")
             if re.fullmatch(rf"lib{lib}_[0-9a-f]{{12}}\.so", p.name)]
    if len(built) != 1:
        raise SystemExit(f"probes.sass: {tree} holds {len(built)} built lib{lib} libraries")
    text = subprocess.run(["cuobjdump", "-sass", str(built[0])], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*(/\*.*\*/)?\s*$", line)
        if name and m and m.group(1):
            out[name].append(m.group(1))
    return out


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    parent, change = sys.argv[1:]
    result = {}
    for lib_a, lib, name in PAIRS:
        a = [v for k, v in functions(parent, lib_a).items() if name in k]
        b = [v for k, v in functions(change, lib).items() if name in k]
        if len(a) != 1 or len(b) != 1:
            raise SystemExit(f"probes.sass: {name} found {len(a)} / {len(b)} times")
        diff = [(q, u, v) for q, (u, v) in enumerate(zip(a[0], b[0])) if u != v]
        result[f"{lib} {name}"] = {"same": a[0] == b[0],
                                   "instructions": [len(a[0]), len(b[0])],
                                   "first_differences": diff[:5]}
        same = "the same" if a[0] == b[0] else "DIFFERENT"
        print(f"  {name} ({lib_a} -> {lib}): {same} SASS "
              f"({len(a[0])} / {len(b[0])} instructions, {len(diff)} differ)")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
