"""Whether two source trees build the same machine code for the pool and
unpool forwards' flagship and 8k-width kernels.

    python3 gecco_tpu_torch/probes/sass.py PARENT CHANGE

Each argument is the root of a checkout whose libraries are built (run
``chip_smoke.py`` or ``probes/trees.py`` there first). For each pair of
kernels below, the old name in PARENT and the new one in CHANGE (the
chunk and merge kernels became templates on the head width), this reads
both libraries' SASS with ``cuobjdump -sass``, drops the addresses and
encodings, and prints whether the instruction lists are identical (and
the first few instructions that differ). Needs
the CUDA toolkit (the card's machine); run by file path.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

# (library, kernel in PARENT, kernel in CHANGE), by the mangled names'
# identifiers and template arguments: the flagship's and the 8k width's
# chunk kernel (D 48, 8 heads a block, without and with the ragged mask),
# merge and tile kernels (384 and 192 columns a block)
PAIRS = (
    ("pool_ext", "17pool_chunk_kernelILb0E", "17pool_chunk_kernelILi48ELi8ELb0E"),
    ("pool_ext", "17pool_chunk_kernelILb1E", "17pool_chunk_kernelILi48ELi8ELb1E"),
    ("pool_ext", "17pool_merge_kernelEPKf", "17pool_merge_kernelILi48EEEvPKf"),
    ("unpool", "18unpool_tile_kernelILi192E", "18unpool_tile_kernelILi192E"),
    ("unpool", "18unpool_tile_kernelILi96E", "18unpool_tile_kernelILi96E"),
)


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
    for lib, old, new in PAIRS:
        a = [v for k, v in functions(parent, lib).items() if old in k]
        b = [v for k, v in functions(change, lib).items() if new in k]
        if len(a) != 1 or len(b) != 1:
            raise SystemExit(f"probes.sass: {old} / {new} found {len(a)} / {len(b)} times")
        diff = [(q, u, v) for q, (u, v) in enumerate(zip(a[0], b[0])) if u != v]
        result[new] = {"same": a[0] == b[0], "instructions": [len(a[0]), len(b[0])],
                       "first_differences": diff[:5]}
        print(f"  {lib} {old} -> {new}: {'the same' if a[0] == b[0] else 'DIFFERENT'} SASS "
              f"({len(a[0])} / {len(b[0])} instructions, {len(diff)} differ)")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
