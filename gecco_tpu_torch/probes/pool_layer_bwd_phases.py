"""The resident pool backward's main pass: trees side by side, and its time
by phase.

    python3 gecco_tpu_torch/probes/pool_layer_bwd_phases.py [--phases] [TREE ...]

Each TREE is the root of a checkout with this Hopper body and
``probes.pool_layer_bwd`` (``git archive`` of a commit, say; this checkout
where none is given): for each, in the order given, a fresh
process imports that tree's package (its kernels built from its own
sources) and reads the Hopper body of ``folded_pool_layer_bwd`` at the
flagship's training shapes (B 48, N 2048, C 384, 8 heads, 64 inducers) and
at the 8k width (B 2, N 8192, C 768, 16 heads), with and without the
pre-norm: the device time of a call and of its main pass
(``layer_bwd_pass_kernel``), ``torch.profiler`` over 10 calls, and the
median of 20 calls by CUDA events. Give PARENT CHANGE CHANGE PARENT to
compare two trees in turns. With ``--phases`` it then builds a copy of
the last tree's ``csrc/pool_bwd.cu`` with ``clock64()`` read at the main
pass's phase boundaries (text edits; they fail loudly once the kernel
changes under them), swaps it in for the shipped library, and prints the
cycles each warpgroup spends a head in each phase at the flagship's
shapes. Run by file path, not with ``-m``. Prints the card's name and
power limit. Needs the card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

# the phase boundaries in csrc/pool_bwd.cu's main pass: (text, text with a
# timer read before and/or after it)
MARKS = [
    ("  bar_wait(yfull, 0);\n", "  TSTART;\n  bar_wait(yfull, 0);\n  TMARK(10);\n"),
    ("      for (int kp = 0; kp < KP; ++kp, ++it) {\n",
     "      TMARK(9);\n      for (int kp = 0; kp < KP; ++kp, ++it) {\n"),
    ('      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n',
     '      TMARK(0);\n      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'),
    ("      // every warp's dpool rows and statistics are in\n      named_sync(2 + w, 128);\n",
     "      TMARK(1);\n      named_sync(2 + w, 128);\n      TMARK(2);\n"),
    ("      // z = s - M (kept in s_acc)", "      TMARK(3);\n      // z = s - M (kept in s_acc)"),
    ("      fence_async_smem();\n      named_sync(2 + w, 128);\n\n      // dp = bf16(v_h)",
     "      TMARK(4);\n      fence_async_smem();\n      named_sync(2 + w, 128);\n      TMARK(5);\n"
     "\n      // dp = bf16(v_h)"),
    ("      // ds = bf16(p (dp - t)", "      TMARK(6);\n      // ds = bf16(p (dp - t)"),
    ("    // dv_h = bf16 of the blocks' sum", "    TMARK(7);\n    // dv_h = bf16 of the blocks' sum"),
]
# timer index -> phase (each timer reads the time since the one before it)
PHASES = {0: "K loop", 1: "statistics and v", 2: "sync", 3: "dpool transpose", 4: "p",
          5: "fence and sync", 6: "dp and dv products", 7: "ds",
          9: "dv, sync and the next block's prefetch", 10: "y tile's arrival"}
TIMERS = '''
__device__ unsigned long long g_phase[16];
#define TSTART long long t_prev = clock64();
#define TMARK(k) do { long long t_now = clock64(); if (threadIdx.x % 128 == 0) \\
  atomicAdd(&g_phase[k], (unsigned long long)(t_now - t_prev)); t_prev = t_now; } while (0)
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
'''
SHAPES = {"flagship": (48, 2048, 384, 8, 64), "8k width": (2, 8192, 768, 16, 64)}


def measure(tree: str, phases: bool) -> dict:
    """This process's readings of ``tree`` (its package first on the path)."""
    sys.path.insert(0, tree)
    import torch

    from gecco_tpu_torch.ops.kernels import _build
    from gecco_tpu_torch.ops.kernels import folded_attention as fa
    from gecco_tpu_torch.probes import pool_layer_bwd as plb
    from gecco_tpu_torch.probes.pool_bwd import launch_split, timed

    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree}
    for width, (b, n, c, h, i) in SHAPES.items():
        ops = plb.operands(gen, b, n, c, h, i, False, dev)
        for prenorm in (True, False):
            mean, inv, fwd, cot = plb.saved(ops, h, prenorm, gen)
            fn = lambda: fa._pool_layer_bwd_launch(*ops, mean, inv, *fwd, *cot, h, prenorm,
                                                   body="hopper")
            split = launch_split(fn, n=10)
            t = sorted(timed(fn))
            out[f"{width}, {'prenorm' if prenorm else 'no pre-norm'}"] = dict(
                device_ms=sum(split.values()), pass_ms=split.get("layer_bwd_pass_kernel"),
                median_ms=(t[len(t) // 2 - 1] + t[len(t) // 2]) / 2)
    if phases:
        out["phases"] = phase_cycles(torch, _build, fa, plb, dev, gen)
    return out


def phase_cycles(torch, _build, fa, plb, dev, gen) -> dict:
    """Cycles a warpgroup spends a head in each phase of the main pass, by
    a timed copy of csrc/pool_bwd.cu at the flagship's training shapes."""
    src = (_build.CSRC / "pool_bwd.cu").read_text()
    for text, timed_text in MARKS:
        if src.count(text) != 1:
            raise RuntimeError(f"csrc/pool_bwd.cu changed under the phase marks: {text!r}")
        src = src.replace(text, timed_text)
    src = src.replace("namespace {\n", TIMERS + "namespace {\n", 1)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    path = os.path.join(work, "pool_bwd_phases.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(work, "libpool_bwd_phases.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                          lib_path, path], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    _build._libs["pool_bwd"] = lib
    b, n, c, h, i = SHAPES["flagship"]
    ops = plb.operands(gen, b, n, c, h, i, False, dev)
    mean, inv, fwd, cot = plb.saved(ops, h, False, gen)
    fn = lambda: fa._pool_layer_bwd_launch(*ops, mean, inv, *fwd, *cot, h, False, body="hopper")
    fn()
    torch.cuda.synchronize()
    lib.phase_reset()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.phase_read(buf)
    # every warpgroup walks eight heads of its 64 points (C 384)
    heads = b * n // 64 * h
    return {name: buf[k] / heads for k, name in PHASES.items()}


def main():
    args = [a for a in sys.argv[1:] if a != "--phases"]
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]), sys.argv[3] == "1")))
        return
    trees = args or [os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))]
    for q, tree in enumerate(trees):
        # the phases once, of the last tree's kernel
        phases = "--phases" in sys.argv and q == len(trees) - 1
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              "1" if phases else "0"], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"pool_layer_bwd_phases on {tree}:\n{res.stdout}\n{res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
