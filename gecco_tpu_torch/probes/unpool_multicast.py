"""The folded unpool's tile kernel in clusters of two blocks that share the
heads' operands by TMA multicast, against the shipped kernel.

    python3 -m gecco_tpu_torch.probes.unpool_multicast

``csrc/unpool.cu``'s tile kernel stages every head's kft_h panels and vf_h^T
slabs for each 64-point tile. This probe rewrites a copy of the source so
that two blocks on neighbouring tiles of one batch element each load half of
every panel (``mcK``), every slab (``mcV``) or both (``mcKV``) and multicast
it to both blocks; a ring stage is refilled once the consumers of both
blocks have released it. It builds the three variants, checks that each
gives the shipped kernel's output bit for bit at the flagship and 8k widths
(an odd tile count included), and times each against the shipped kernel in
the order shipped, variants, variants reversed, shipped. It prints the card's
name and power limit and one JSON line of median milliseconds. Needs the
card; the copy is built under ``gecco_tpu_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from gecco_tpu_torch.ops.kernels import _build
from gecco_tpu_torch.ops.kernels import folded_attention as fa

VARIANTS = {"mcKV": (1, 1), "mcK": (1, 0), "mcV": (0, 1)}

_HELPERS = r'''
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                   int row, int col, uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "h"(cta_mask)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void bar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
'''

# (old, new) edits of csrc/unpool.cu; MC_K / MC_V choose what is multicast
_EDITS = (
    ("  int KP, CB, lane, col, r0;\n};",
     "  int KP, CB, lane, col, r0;\n  uint32_t peer;\n};\n"
     "__device__ __forceinline__ void release_stage(const TileCtx& t, uint64_t* empty) {\n"
     "  bar_arrive(empty);\n  bar_arrive_cluster(empty, t.peer);\n}"),
    ("    if (t.lane == 0) bar_arrive(t.kempty + s);",
     "    if (t.lane == 0) { if (MC_K) release_stage(t, t.kempty + s); "
     "else bar_arrive(t.kempty + s); }"),
    ("    bar_arrive(t.vempty + s);",
     "    if (MC_V) release_stage(t, t.vempty + s); else bar_arrive(t.vempty + s);"),
    ("__global__ void __launch_bounds__(384, 1)\nunpool_tile_kernel(",
     "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(384, 1)\nunpool_tile_kernel("),
    ("  const int KP = C / 64, J = H * kInd;\n"
     "  const int row0 = blockIdx.x * kTile, b = row0 / N, cbase = blockIdx.y * CB;",
     "  const int KP = C / 64, J = H * kInd, T = N / kTile, T2 = (T + 1) / 2 * 2;\n"
     "  const int b = blockIdx.x / T2, tile = blockIdx.x % T2, cbase = blockIdx.y * CB;\n"
     "  const bool writes = tile < T;\n"
     "  const int row0 = b * N + min(tile, T - 1) * kTile;\n"
     "  const uint32_t rank = cluster_rank(), peer = rank ^ 1;"),
    ("      bar_init(kempty + q, 4);", "      bar_init(kempty + q, MC_K ? 8 : 4);"),
    ("      bar_init(vempty + q, 8);", "      bar_init(vempty + q, MC_V ? 16 : 8);"),
    ("    fence_barrier_init();\n  }\n  __syncthreads();",
     "    fence_barrier_init();\n  }\n  cluster_sync();"),
    ("        tma_load(kstage(w, s), &tm_k, kfull + w * kKRing + s, b * J + h * kInd, kp * 64);",
     "        if (MC_K) tma_load_multicast(kstage(w, s) + rank * (kInd / 2) * 128, &tm_k,\n"
     "            kfull + w * kKRing + s, b * J + h * kInd + rank * (kInd / 2), kp * 64, 3);\n"
     "        else tma_load(kstage(w, s), &tm_k, kfull + w * kKRing + s, b * J + h * kInd, kp * 64);"),
    ("        for (int r = 0; r < CB; r += 192) {\n"
     "          tma_load(vstage(s) + r * 128, &tm_v, vfull + s, b * C + cbase + r, h * kInd);\n"
     "        }",
     "        if (MC_V) tma_load_multicast(vstage(s) + rank * (CB / 2) * 128, &tm_v, vfull + s,\n"
     "                                     b * C + cbase + rank * (CB / 2), h * kInd, 3);\n"
     "        else for (int r = 0; r < CB; r += CB / 2)\n"
     "          tma_load(vstage(s) + r * 128, &tm_v, vfull + s, b * C + cbase + r, h * kInd);"),
    ("pfull, pempty, KP, CB, lane, col, r0};", "pfull, pempty, KP, CB, lane, col, r0, peer};"),
    ("    for (int c = threadIdx.x; c < CB; c += 256) {",
     "    for (int c = threadIdx.x; writes && c < CB; c += 256) {"),
    ("      atomicAdd(sums + (size_t)b * 2 * C + C + cbase + c, s2);\n    }\n  }\n}",
     "      atomicAdd(sums + (size_t)b * 2 * C + C + cbase + c, s2);\n    }\n  }\n"
     "  cluster_sync();\n}"),
    ("encode_tiled(&tm_k, kft, (uint64_t)B * J, C, kInd)",
     "encode_tiled(&tm_k, kft, (uint64_t)B * J, C, MC_K ? kInd / 2 : kInd)"),
    ("encode_tiled(&tm_v, vft, (uint64_t)B * C, J, 192)",
     "encode_tiled(&tm_v, vft, (uint64_t)B * C, J, CB / 2)"),
    ("  kernel<<<dim3(B * N / kTile, C / CB), 384, L.total, st>>>(",
     "  kernel<<<dim3(B * ((N / kTile + 1) / 2 * 2), C / CB), 384, L.total, st>>>("),
)


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the probe's edit no longer matches csrc: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict[str, ctypes.CDLL]:
    """Copy csrc with the cluster edits into the build directory and compile
    one library per variant, all at once."""
    src = _build.BUILD_DIR / "probe_unpool_multicast"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    hopper = (src / "hopper.cuh").read_text()
    marker = "// make the generic proxy's shared-memory writes visible"
    (src / "hopper.cuh").write_text(_edit(hopper, ((marker, _HELPERS + marker),)))
    (src / "unpool.cu").write_text(_edit((src / "unpool.cu").read_text(), _EDITS))
    procs = {}
    for name, (k, v) in VARIANTS.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMC_K={k}", f"-DMC_V={v}", "-I", str(src),
               "-o", str(src / f"lib{name}.so"), str(src / "unpool.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        spills = [line.strip() for line in out.splitlines() if "spill" in line]
        print(f"{name}: {sorted(set(spills))}")
        libs[name] = ctypes.CDLL(str(src / f"lib{name}.so"))
        libs[name].unpool_launch.restype = ctypes.c_int
    return libs


def variant_unpool(lib, x, se, be, k, v, wq, wo, heads: int):
    """``folded_unpool``'s forward through a variant library -> (out, sums)."""
    b, n, c = x.shape
    i = k.shape[1]
    dev = x.device
    bufs = [torch.empty((b, c), dtype=torch.float32, device=dev),
            torch.empty((b, heads * i, c), dtype=torch.bfloat16, device=dev),
            torch.empty((b, c, heads * i), dtype=torch.bfloat16, device=dev),
            torch.empty((b, heads * i), dtype=torch.float32, device=dev),
            torch.empty_like(x), torch.zeros((b, 2, c), dtype=torch.float32, device=dev)]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, se, be, k, v, wq, wo, *bufs)]
    ints = [ctypes.c_int(q) for q in (b, n, c, heads, i, 1, 1)]
    err = lib.unpool_launch(*ptrs, *ints, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"unpool_launch: CUDA error {err}")
    return bufs[4], bufs[5]


def operands(rng, b, n, c, heads, device):
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
    bf = torch.bfloat16
    return (r(b, n, c).to(bf), 1.0 + 0.1 * r(b, c), 0.1 * r(b, c), r(b, 64, c).to(bf),
            r(b, 64, c).to(bf), (r(c, c) / c**0.5).to(bf), (r(c, c) / c**0.5).to(bf))


def median_ms(fn, reps=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("unpool_multicast: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build_variants()
    rng = np.random.default_rng(0)
    exact = True
    for b, n, c, h in ((64, 2048, 384, 8), (3, 192, 384, 8), (2, 8192, 768, 16), (2, 320, 768, 16)):
        ops = operands(rng, b, n, c, h, dev)
        out, sums = fa.folded_unpool(*ops, h)
        for name, lib in libs.items():
            vo, vs = variant_unpool(lib, *ops, h)
            same = torch.equal(vo, out)
            ds = float((vs - sums).abs().max() / sums.abs().max())
            exact &= same and ds < 1e-5
            print(f"{name} B {b} N {n} C {c}: out bitwise equal {same}, sums {ds:.2e} of max")
    record = {}
    for b, n, c, h in ((64, 2048, 384, 8), (2, 8192, 768, 16)):
        ops = operands(rng, b, n, c, h, dev)
        runs = {"shipped": lambda: fa.folded_unpool(*ops, h)}
        runs.update({name: (lambda lib=lib: variant_unpool(lib, *ops, h)) for name, lib in libs.items()})
        order = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(median_ms(runs[name]))
        record[f"B{b}_N{n}_C{c}"] = times
    print(json.dumps({"unpool_multicast_ms": record, "exact": exact}))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
