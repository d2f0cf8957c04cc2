// Pieces shared by the per-head rectangular attention's Hopper bodies
// (csrc/induced_attention.cu, csrc/induced_attention_bwd.cu): the tile
// plan, tensor maps of one head's slice of a strided [B, H, rows, D]
// operand, tiles staged by threads, the in-kernel delta, register-A
// products against an MN-major B, and the fixed-order sum of a register
// tile over a thread-block cluster.
//
// A "head tile" is 64 rows of one head's D columns in P = ceil(D / 64)
// panels of 64 columns (hopper.cuh's 128-byte swizzle, 8 KB a panel),
// columns from D to 64 P zero. One layout serves both uses of a tile: as
// a K-major operand (K = D, a wgmma step of 16 columns inside a panel) and
// as an MN-major one (hopper.cuh desc_mn: K = the 64 rows, N = D).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace gecco {
namespace rect {

using namespace gecco::hopper;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;             // rows of a tile: queries or keys
constexpr int kBlock = 128;        // one warpgroup a block
constexpr int kPanel = kT * 128;   // one 64-column panel of a head tile
constexpr int kRangeTiles = 16;    // tiles of the long side a block aims at
constexpr int kMaxCluster = 8;     // blocks of one (b, h) that sum in a cluster
// a block's shared-memory limit on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;

template <int D>
__host__ __device__ constexpr int panels() {
  return (D + 63) / 64;
}

// ----------------------------------------------------------- host side --

// The blocks of one (b, h) over nt tiles of the long side: ranges of tpb
// tiles, ``r`` of them; with a cluster (the sums across the ranges) at
// most kMaxCluster, else as many as kRangeTiles-tile ranges need.
struct Plan {
  int r, tpb;
  Plan(int nt, bool cluster) {
    r = (nt + kRangeTiles - 1) / kRangeTiles;
    if (r < 1) r = 1;
    if (cluster && r > kMaxCluster) r = kMaxCluster;
    tpb = (nt + r - 1) / r;
  }
};

// The strides of a [B, H, rows, D] operand, in elements (last stride 1).
struct Op {
  const bf16* ptr;
  int sb, sh, sr;
  __host__ __device__ const bf16* at(int b, int h) const {
    return ptr + (long long)b * sb + (long long)h * sh;
  }
};

// Whether an operand can be staged by threads (16-byte loads: strides in
// multiples of 8 elements, the base 16-byte aligned; a zero batch stride
// is fine) and whether it can be read by TMA (as staged, and the heads
// adjacent: sh == D, a positive batch stride). induced_attention.py's
// _staged_ok and _tma_ok repeat these: change both together.
inline bool staged_ok(const Op& t) {
  return t.sb % 8 == 0 && t.sh % 8 == 0 && t.sr % 8 == 0 && t.sb >= 0 && t.sh >= 0 &&
         t.sr > 0 && (uintptr_t)t.ptr % 16 == 0;
}
inline bool tma_ok(const Op& t, int D) { return staged_ok(t) && t.sh == D && t.sb > 0; }

// cuTensorMapEncodeTiled looked up in libcuda.so.1, which the process has
// loaded (no link against it).
inline CUresult encode_heads(CUtensorMap* map, const Op& t, int B, int H, int rows, int D) {
  using Fn = decltype(&cuTensorMapEncodeTiled);
  static Fn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return CUDA_ERROR_NOT_INITIALIZED;
    fn = reinterpret_cast<Fn>(dlsym(lib, "cuTensorMapEncodeTiled"));
    if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  }
  // dims (fastest first) D, H, rows, B: a box is 64 columns (past D: zero)
  // of one head's 64 rows (past ``rows``: zero) of one batch element
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)t.sh * 2, (cuuint64_t)t.sr * 2,
                                 (cuuint64_t)t.sb * 2};
  const cuuint32_t box[4] = {64, 1, kT, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(t.ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// --------------------------------------------------------- device side --

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~(uintptr_t)1023);
}

// One head tile by TMA: rows row0 ... row0 + 63 of head h of batch
// element b, into dst (P panels), completing on bar.
template <int D>
__device__ __forceinline__ void load_head_tile(unsigned char* dst, const CUtensorMap* map,
                                               uint64_t* bar, int b, int h, int row0) {
#pragma unroll
  for (int p = 0; p < panels<D>(); ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst + p * kPanel)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(64 * p), "r"(h), "r"(row0),
        "r"(b)
        : "memory");
  }
}

// A head tile staged by the block's threads: rows 0 ... valid - 1 of a
// head slice (row stride sr elements) with 16-byte loads; rows from valid
// on and columns from D on zero.
template <int D>
__device__ __forceinline__ void stage_head_tile(unsigned char* dst, const bf16* src, int sr,
                                                int valid) {
  constexpr int CH = 8 * panels<D>();  // 16-byte chunks a row
  for (int t = threadIdx.x; t < kT * CH; t += kBlock) {
    const int r = t / CH, c = (t % CH) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid && c < D) val = __ldg(reinterpret_cast<const int4*>(src + (long long)r * sr + c));
    *reinterpret_cast<int4*>(dst + swz(r, c, kPanel)) = val;
  }
}

// delta[r] = sum_d f32(g[r, d]) f32(o[r, d]) for the 64 rows of two head
// tiles: thread t sums half t % 2 of row t / 2, the halves added by a
// shuffle (the same sum in both lanes). Ends with delta written by the
// even threads (the caller's barrier makes it visible).
template <int D>
__device__ __forceinline__ void tile_delta(const unsigned char* g, const unsigned char* o,
                                           float* delta) {
  static_assert(D % 16 == 0, "tile_delta: half a row in 16-byte chunks");
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  float s = 0.0f;
#pragma unroll
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += 8) {
    const int4 gv = *reinterpret_cast<const int4*>(g + swz(r, c, kPanel));
    const int4 ov = *reinterpret_cast<const int4*>(o + swz(r, c, kPanel));
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 gf = __bfloat1622float2(g2[e]), of = __bfloat1622float2(o2[e]);
      s += gf.x * of.x;
      s += gf.y * of.y;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0) delta[r] = s;
}

// acc[64, 64] = A[64, D] @ B[64, D]^T over the D columns of two head
// tiles, both K-major (each 16-column step inside its panel). Issues the
// products; the caller fences before and commits and waits after.
template <int D>
__device__ __forceinline__ void tile_logits(float (&acc)[32], const unsigned char* a,
                                            const unsigned char* bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kPanel;
    wgmma_ss<64>(acc, desc(a + off) + 2 * (kk % 4), desc(bt + off) + 2 * (kk % 4), kk != 0);
  }
}

// the max and the sum of a quad's four lanes (one accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows row0 + r and row0 + r + 8 (those below ``rows``; r = the thread's
// accumulator row) of an accumulator's N columns, times mul, as bf16 pairs
// into base (row stride sr) from column c0 on.
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, int sr, const float (&acc)[N / 2], int c0,
                                           int row0, int rows, float mul) {
  const int lane = threadIdx.x % 32, r = (threadIdx.x / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int g = 0; g < N / 8; ++g) {
    if (row0 + r < rows) {
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(row0 + r) * sr + c0 + 8 * g + col) =
          __floats2bfloat162_rn(mul * acc[4 * g], mul * acc[4 * g + 1]);
    }
    if (row0 + r + 8 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(row0 + r + 8) * sr + c0 + 8 * g +
                                         col) =
          __floats2bfloat162_rn(mul * acc[4 * g + 2], mul * acc[4 * g + 3]);
    }
  }
}

// bf16 pairs of a [64, 64] accumulator (32 floats) as the A operand of
// wgmma_rs / wgmma_rs_t: pairs 4 kk ... 4 kk + 3 are K step kk
// (hopper.cuh wgmma_rs).
__device__ __forceinline__ void pack_bf16(const float (&d)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(d[2 * j], d[2 * j + 1]);
    a[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ const uint32_t (&kstep(const uint32_t (&a)[16], int kk))[4] {
  return *reinterpret_cast<const uint32_t(*)[4]>(a + 4 * kk);
}

// d[64, N] (+)= A[64, 16] @ B[16, N], A from registers (as wgmma_rs), B
// MN-major in shared memory (desc_mn): rows of K, N values each, the
// layout TMA leaves for a row-major [K, N] tile. Overloaded on the
// accumulator's size (N / 2 floats).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The sum over the cluster's blocks, in rank order, of each block's
// [64, N] fp32 accumulator (wgmma layout); the block of rank j emits rows
// 64 j / R ... 64 (j + 1) / R of it, as column pairs, through emit(row,
// col, v0, v1). buf: N * 256 bytes of this block's shared memory. Every
// thread of every block of the cluster calls it; the sum is the same bits
// from call to call.
template <int R2, class Emit>
__device__ __forceinline__ void cluster_sum(const float (&acc)[R2], float* buf, Emit emit) {
  constexpr int N = 2 * R2;
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int nb = (int)cl.num_blocks(), me = (int)cl.block_rank();
  const int lane = threadIdx.x % 32, r = (threadIdx.x / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int g = 0; g < N / 8; ++g) {
    *reinterpret_cast<float2*>(buf + r * N + 8 * g + col) = make_float2(acc[4 * g], acc[4 * g + 1]);
    *reinterpret_cast<float2*>(buf + (r + 8) * N + 8 * g + col) =
        make_float2(acc[4 * g + 2], acc[4 * g + 3]);
  }
  cl.sync();
  const int r0 = kT * me / nb, r1 = kT * (me + 1) / nb;
  for (int e = threadIdx.x; e < (r1 - r0) * (N / 2); e += kBlock) {
    const int row = r0 + e / (N / 2), c = 2 * (e % (N / 2));
    float2 sum = *reinterpret_cast<const float2*>(cl.map_shared_rank(buf, 0) + row * N + c);
    for (int j = 1; j < nb; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(cl.map_shared_rank(buf, j) + row * N + c);
      sum.x += v.x;
      sum.y += v.y;
    }
    emit(row, c, sum.x, sum.y);
  }
  cl.sync();  // every block is done reading the others' buffers
}

}  // namespace rect
}  // namespace gecco
