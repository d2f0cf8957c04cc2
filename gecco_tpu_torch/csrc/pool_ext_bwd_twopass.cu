// Backward of the tiled online-softmax attention pool (folded_pool_ext):
// the v1, v2 and v2j bodies (GECCO_POOL_BWD) on Hopper, for 64 inducers a
// head and D 48 (the flagship's training shapes and the 8k width) or D 128
// (three heads at C 384, six at C 768), the head width a template argument.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel_v1
// (v1), _pool_ext_bwd_kernel (v2) and _pool_ext_bwd_kernel_v2j (v2j), with
// their algebra and bf16 rounding points as pool_bwd_twopass.cuh sets them
// out (the WMMA body, kept for every other shape):
//   v = bf16(y Wv_h^T);  pacc_h = sum_n bf16(e_h)^T v_h;  v1: t = sum_n e dp
//   ds = bf16(...) masked where s - macc <= -80 and past n_valid;
//   dv = bf16(bf16(p or e) DM_h);  dy = ds qf^T + dv Wv
//
// Bound on the H100: tensor-core operations (~2 [N, C] x [C, J]-sized
// products of each kind per batch element), ~0.24 ms at the flagship's B
// 48, ~0.09 ms at three heads (J 192). The WMMA body spends ~6.4 ms in its two passes on the H100: pass
// 0 one block per (head, b) walking every point in turn (384 blocks, under
// three waves; 32 at the 8k width), pass 1 one block per 32-point tile
// walking the heads, each tile forming s, v, dp, dv and dy through
// shared-memory WMMA tiles with qf^T and Wv re-read from L2 per head.
//
// Design: every product over C is one pass over the B N rows by the
// Hopper GEMM of the MLP (mlp_hopper.cuh, 128-row blocks, TMA rings,
// wgmma), and the per-head work between them touches only [64, 64] tiles:
// 0. prenorm_kernel (backward.cuh): y = bf16(x se + be) once;
// 1. twopass_fold_kernel (pool_bwd_twopass.cuh): DM_h or DMs_h [B, J, D];
// 2. S = y qf [B N, J] fp32 (mlp_gemm, epilogue kF32; 128-column tiles,
//    64-column ones where J % 128 != 0, three heads' J 192) and V = bf16(y Wv^T)
//    [B N, C] (mlp_gemm, kKV): the logits and values both passes read,
//    formed once (the WMMA body formed them twice, per head and tile);
// 3. twopass_range_kernel, one block (a warpgroup) per (range of 512
//    points, head, b): per 64-point tile e from the tile's S in registers,
//    bf16(e)^T into shared memory, V_h^T beside it, pacc_h [64, D] +=
//    bf16(e)^T v_h by one m64nD wgmma (m64n48 or m64n128) into registers
//    kept across the range;
//    v1 also dp = v_h DM_h^T (m64n64) and t += e dp in registers; the
//    range's fp32 partials [R, B, J, D] (and t [R, B, J]) to device memory
//    (~19 MB at B 48, D 48);
// 4. twopass_merge_kernel, one warp per (b, row of J): pacc = the ranges'
//    partials in range order, merged = bf16(pacc / sacc), tacc (v1: t /
//    sacc; v2: rowsum(DMs pacc) / sacc) as the WMMA body's tail forms them;
// 5. twopass_tile_kernel, one block (a warpgroup) per (64-point tile, head,
//    b): dp = v_h DM_h^T (m64n64 wgmma), ds in registers from the tile's S
//    and tacc, bf16(ds) to device memory, bf16(p or e) to shared memory, dv
//    = bf16(bf16(p or e) DM_h) (m64nD wgmma), bf16(dv) to device memory;
// 6. dy = ds qf^T + dv Wv: one mlp_gemm of depth J + C over [ds | dv]
//    (its second operand pair), epilogue kDx without a residual: dx =
//    bf16(dy se) and each 128-row block's column sums of dy x and dy;
// 7. twopass_colsum_kernel: dse, dbe = the blocks' sums in block order;
// 8. wgrad_kernel (wgrad.cuh) three times: dqf = y^T ds, dWv = dv^T y,
//    dWo = g_h0^T merged, fixed-order split-K.
// No atomics: every output is the same bits from call to call, and v2j
// (reading the wrapper's 1/sacc) gives v2's. A ragged N comes zero-padded
// to a multiple of 128: e is 0 from n_valid on, so ds, dv and dy are too.
// One warpgroup a block at both widths: at D 128 pacc and dv are [64, 128]
// fp32, 64 registers a thread, and a [64, D] operand is two 64-column
// panels of the 128-byte swizzle.
#include <cmath>

#include "mlp_hopper.cuh"
#include "pool_bwd_twopass.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kInd = 64;             // inducers per head (I)
constexpr int kTile = 64;            // points per tile
constexpr int kRangeTiles = 8;       // tiles per range of the pass-0 partials
constexpr int kOp = 64 * 128;     // one [64, 64] bf16 operand, 128-byte swizzled
constexpr int kWgThreads = 128;      // one warpgroup

// the bytes of a [64, HD] K-major operand (HD / 64 panels, rounded up),
// which also hold a [HD, 64] one (HD rows of 128 bytes)
template <int HD>
__host__ __device__ constexpr int op_bytes() {
  return (HD + 63) / 64 * kOp;
}

MLP_GEMM_KERNEL(twopass_s_kernel, 128, 0, mlp::kF32, 4)
// J % 128 != 0 (three heads: J 192)
MLP_GEMM_KERNEL(twopass_s64_kernel, 64, 0, mlp::kF32, 4)
MLP_GEMM_KERNEL(twopass_v_kernel, mlp::kBnWide, 0, mlp::kKV, mlp::kStagesWide)
MLP_GEMM_KERNEL(twopass_dy_kernel, mlp::kBnWide, 1, mlp::kDx, mlp::kStagesWide)

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~(uintptr_t)1023);
}

// rows [64] of a [rows, HD] bf16 block (row stride ld) into a K-major
// operand: element (r, d) at swz(r, d) (16-byte chunks; d past 63 in the
// second panel), or with ``trans`` element (d, r) at swz(d, r)
template <int HD, bool trans>
__device__ __forceinline__ void stage_head(unsigned char* dst, const bf16* src, size_t ld) {
  for (int t = threadIdx.x; t < 64 * (HD / 8); t += kWgThreads) {
    const int r = t / (HD / 8), q = (t % (HD / 8)) * 8;
    const int4 raw = __ldg(reinterpret_cast<const int4*>(src + (size_t)r * ld + q));
    if constexpr (trans) {
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) *reinterpret_cast<bf16*>(dst + swz(q + e, r, kOp)) = v[e];
    } else {
      *reinterpret_cast<int4*>(dst + swz(r, q, kOp)) = raw;
    }
  }
}

// The thread's logits of a [64 points, 64 inducers] tile of S in the
// accumulator layout (hopper.cuh): s[4g + e] at row r, column 8g + col + e,
// s[4g + 2 + e] at row r + 8.
__device__ __forceinline__ void load_logits(float (&s)[32], const float* S, size_t ld, int r,
                                            int col) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(S + (size_t)r * ld + 8 * g + col));
    const float2 c = __ldg(reinterpret_cast<const float2*>(S + (size_t)(r + 8) * ld + 8 * g + col));
    s[4 * g] = a.x;
    s[4 * g + 1] = a.y;
    s[4 * g + 2] = c.x;
    s[4 * g + 3] = c.y;
  }
}

// dp = v_h DM_h^T [64 points, 64 inducers], depth HD: both operands
// K-major [64, HD], a 64-column panel per four steps
template <int HD>
__device__ __forceinline__ void dp_product(float (&dp)[32], const unsigned char* vt,
                                           const unsigned char* dmk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int pan = (kk / 4) * kOp;
    wgmma_tt<0, 0>(dp, desc(vt + pan) + 2 * (kk % 4), desc(dmk + pan) + 2 * (kk % 4), kk != 0);
  }
}

// ------------------------------------------------------ pass 0: ranges --

// Shared memory: bf16 e^T [64 inducers, 64 points], V_h^T [HD channels, 64
// points], v1: V_h [64 points, HD] and DM_h [64 inducers, HD], then the
// four warps' t sums [4][64].
template <int ALG, int HD>
__global__ void __launch_bounds__(kWgThreads)
twopass_range_kernel(const float* __restrict__ S, const bf16* __restrict__ V,
                     const float* __restrict__ macc, const bf16* __restrict__ dm,
                     float* __restrict__ ppart, float* __restrict__ tpart, int B, int N,
                     int n_valid, int C, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int kOpD = op_bytes<HD>();
  unsigned char* et = smem;
  unsigned char* vT = smem + kOp;
  unsigned char* vt = vT + kOpD;
  unsigned char* dmk = vt + kOpD;
  float* red = reinterpret_cast<float*>(dmk + kOpD);  // [4 warps][64]
  const int J = H * kInd, rg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4), r = wi * 16 + lane / 4;
  const size_t col0 = (size_t)b * J + h * kInd;
  float mcol[16];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    mcol[2 * g] = __ldg(macc + col0 + 8 * g + col);
    mcol[2 * g + 1] = __ldg(macc + col0 + 8 * g + col + 1);
  }
  if (ALG == twopass::kV1) stage_head<HD, false>(dmk, dm + col0 * HD, HD);
  float pacc[HD / 2], tsum[16];
  zero(pacc);
  zero(tsum);
  const int t0 = rg * kRangeTiles, t1 = min(t0 + kRangeTiles, N / kTile);
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * kTile;
    const size_t row0 = (size_t)b * N + n0;
    float e[32];
    load_logits(e, S + row0 * J + h * kInd, J, r, col);
    const bool ok0 = n0 + r < n_valid, ok1 = n0 + r + 8 < n_valid;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float m = mcol[2 * g + q % 2];
        e[4 * g + q] = (q < 2 ? ok0 : ok1) ? expf(fmaxf(e[4 * g + q] - m, -80.0f)) : 0.0f;
        // bf16(e)^T: element (inducer, point)
        *reinterpret_cast<bf16*>(et + swz(8 * g + col + q % 2, r + 8 * (q / 2), kOp)) =
            __float2bfloat16(e[4 * g + q]);
      }
    }
    stage_head<HD, true>(vT, V + row0 * C + h * HD, C);
    if (ALG == twopass::kV1) stage_head<HD, false>(vt, V + row0 * C + h * HD, C);
    fence_async_smem();
    __syncthreads();
    // pacc_h += bf16(e)^T v_h [64 inducers, HD]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tt<0, 0>(pacc, desc(et) + 2 * kk, desc(vT) + 2 * kk, 1);
    if (ALG == twopass::kV1) {
      // dp = v_h DM_h^T [64 points, 64 inducers], depth HD
      float dp[32];
      dp_product<HD>(dp, vt, dmk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      // t += sum over the tile's points of e dp (fp32 e)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          tsum[2 * g + q] += e[4 * g + q] * dp[4 * g + q] + e[4 * g + 2 + q] * dp[4 * g + 2 + q];
        }
      }
    } else {
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(pacc);
    __syncthreads();  // et, vT and vt are rewritten by the next tile
  }
  // the range's partial pacc: rows r, r + 8 (inducers), columns 8g + col
  float* pp = ppart + (((size_t)rg * B + b) * J + h * kInd) * HD;
#pragma unroll
  for (int g = 0; g < HD / 8; ++g) {
    *reinterpret_cast<float2*>(pp + (size_t)r * HD + 8 * g + col) =
        make_float2(pacc[4 * g], pacc[4 * g + 1]);
    *reinterpret_cast<float2*>(pp + (size_t)(r + 8) * HD + 8 * g + col) =
        make_float2(pacc[4 * g + 2], pacc[4 * g + 3]);
  }
  if (ALG == twopass::kV1) {
    // t's columns: the thread's rows over the warp, then the warps in order
#pragma unroll
    for (int k = 0; k < 16; ++k) tsum[k] = mlp::rows_sum(tsum[k]);
    if (lane < 4) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        red[wi * 64 + 8 * g + col] = tsum[2 * g];
        red[wi * 64 + 8 * g + col + 1] = tsum[2 * g + 1];
      }
    }
    __syncthreads();
    if (threadIdx.x < kInd) {
      const int i = threadIdx.x;
      tpart[((size_t)rg * B + b) * J + h * kInd + i] =
          ((red[i] + red[64 + i]) + red[128 + i]) + red[192 + i];
    }
  }
}

// --------------------------------------------------------- the merge --

// One warp per (b, row j = h I + i): pacc = the ranges' partials in range
// order; merged[b, i, hD + d] = bf16(pacc inv); tacc = (v1: the ranges' t
// in order; v2: rowsum(DMs pacc)) inv.
template <int ALG, bool GIVEN, int HD>
__global__ void __launch_bounds__(kThreads)
twopass_merge_kernel(const float* __restrict__ ppart, const float* __restrict__ tpart,
                     const float* __restrict__ norm, const bf16* __restrict__ dm,
                     float* __restrict__ tacc, bf16* __restrict__ merged, int B, int C, int H,
                     int R) {
  const int J = H * kInd, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;  // b J + j
  if (row >= (size_t)B * J) return;
  const int b = (int)(row / J), j = (int)(row % J), h = j / kInd, i = j % kInd;
  const float inv = twopass::inv_norm<GIVEN>(norm, row);
  float acc = 0.0f;
  for (int d = lane; d < HD; d += 32) {
    float p = 0.0f;
    for (int rg = 0; rg < R; ++rg) p += ppart[(((size_t)rg * B) * J + row) * HD + d];
    if (ALG == twopass::kV2) acc += __bfloat162float(dm[row * HD + d]) * p;
    merged[((size_t)b * kInd + i) * C + h * HD + d] = __float2bfloat16(p * inv);
  }
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    if (ALG == twopass::kV1) {
      float t = 0.0f;
      for (int rg = 0; rg < R; ++rg) t += tpart[(size_t)rg * B * J + row];
      acc = t;
    }
    tacc[row] = acc * inv;
  }
}

// ----------------------------------------------------- pass 1: tiles --

// Shared memory: V_h [64 points, HD], DM_h [64 inducers, HD] and DM_h^T
// [HD, 64 inducers] (K-major operands), bf16(p or e) [64 points, 64].
template <int ALG, bool GIVEN, int HD>
__global__ void __launch_bounds__(kWgThreads)
twopass_tile_kernel(const float* __restrict__ S, const bf16* __restrict__ V,
                    const float* __restrict__ macc, const float* __restrict__ norm,
                    const bf16* __restrict__ dm, const float* __restrict__ tacc,
                    bf16* __restrict__ ds_out, bf16* __restrict__ dv_out, int N, int n_valid,
                    int C, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int kOpD = op_bytes<HD>();
  unsigned char* vt = smem;
  unsigned char* dmk = smem + kOpD;
  unsigned char* dmt = smem + 2 * kOpD;
  unsigned char* pe = smem + 3 * kOpD;
  const int J = H * kInd, tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n0 = tile * kTile;
  const size_t row0 = (size_t)b * N + n0, col0 = (size_t)b * J + h * kInd;
  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4), r = wi * 16 + lane / 4;
  stage_head<HD, false>(vt, V + row0 * C + h * HD, C);
  stage_head<HD, false>(dmk, dm + col0 * HD, HD);
  stage_head<HD, true>(dmt, dm + col0 * HD, HD);
  float s[32];
  load_logits(s, S + row0 * J + h * kInd, J, r, col);
  fence_async_smem();
  __syncthreads();
  // dp = v_h DM_h^T [64 points, 64 inducers], depth HD
  float dp[32];
  wgmma_fence();
  dp_product<HD>(dp, vt, dmk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dp);
  const bool ok0 = n0 + r < n_valid, ok1 = n0 + r + 8 < n_valid;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    float dsv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t jj = col0 + 8 * g + col + q % 2;
      const float z = s[4 * g + q] - __ldg(macc + jj);
      // e, and so ds and dv, 0 on a ragged tail's padding rows
      const float e = (q < 2 ? ok0 : ok1) ? expf(fmaxf(z, -80.0f)) : 0.0f;
      const float w = ALG == twopass::kV1 ? e * twopass::inv_norm<GIVEN>(norm, jj) : e;  // p or e
      dsv[q] = z > -80.0f ? w * (dp[4 * g + q] - __ldg(tacc + jj)) : 0.0f;
      *reinterpret_cast<bf16*>(pe + swz(r + 8 * (q / 2), 8 * g + col + q % 2, kOp)) =
          __float2bfloat16(w);
    }
    const int c = h * kInd + 8 * g + col;
    *reinterpret_cast<__nv_bfloat162*>(ds_out + (row0 + r) * J + c) =
        __floats2bfloat162_rn(dsv[0], dsv[1]);
    *reinterpret_cast<__nv_bfloat162*>(ds_out + (row0 + r + 8) * J + c) =
        __floats2bfloat162_rn(dsv[2], dsv[3]);
  }
  fence_async_smem();
  __syncthreads();
  // dv_h = bf16(bf16(p or e)_h DM_h) [64 points, HD], depth 64
  float dv[HD / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tt<0, 0>(dv, desc(pe) + 2 * kk, desc(dmt) + 2 * kk, kk != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
#pragma unroll
  for (int g = 0; g < HD / 8; ++g) {
    const int c = h * HD + 8 * g + col;
    *reinterpret_cast<__nv_bfloat162*>(dv_out + (row0 + r) * C + c) =
        __floats2bfloat162_rn(dv[4 * g], dv[4 * g + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dv_out + (row0 + r + 8) * C + c) =
        __floats2bfloat162_rn(dv[4 * g + 2], dv[4 * g + 3]);
  }
}

// + alignment slack
template <int HD>
constexpr size_t range_smem() {
  return kOp + 3 * op_bytes<HD>() + 4 * 64 * 4 + 1024;
}
template <int HD>
constexpr size_t tile_smem() {
  return 3 * op_bytes<HD>() + kOp + 1024;
}

// The shapes this body takes (folded_attention.py _pool_twopass_hopper_takes:
// change both together): 64 inducers a head of D 48 or 128, C a multiple of
// 384 up to 768 (the GEMMs' 192-column tiles; J then a multiple of 64: 192
// at three heads), N a multiple of the GEMMs' 128-row block.
inline bool body_takes(int B, int N, int C, int H, int I) {
  return I == kInd && C % H == 0 && (C / H == 48 || C / H == 128) && C % 384 == 0 &&
         C <= 768 && N % mlp::kRows == 0 && B >= 1;
}

template <int ALG, bool GIVEN, int HD>
cudaError_t launch(const void* x, const void* se, const void* be, const void* qft,
                   const void* kvw, const void* wo, const void* gh, const void* macc,
                   const void* norm, void* y, void* dm, void* s, void* v, void* ppart,
                   void* tpart, void* tacc, void* merged, void* ds, void* dv, void* colpart,
                   void* wpart, void* dx, void* dsum, void* dqf, void* dwv, void* dwo, int B,
                   int N, int C, int H, int I, int s_qf, int s_wv, int s_wo, int n_valid,
                   cudaStream_t st) {
  using namespace mlp;
  if (!body_takes(B, N, C, H, I) || n_valid < 1 || n_valid > N) return cudaErrorInvalidValue;
  const int J = H * kInd, R = (N / kTile + kRangeTiles - 1) / kRangeTiles;
  const long long M = (long long)B * N;
  cudaError_t err;
  // 0. y = bf16(x se + be)
  if ((err = launch_prenorm((const bf16*)x, (const float*)se, (const float*)be, (bf16*)y, B, N,
                            C, st)) != cudaSuccess) {
    return err;
  }
  // 1. DM_h / DMs_h
  {
    auto kernel = twopass::twopass_fold_kernel<ALG, GIVEN>;
    if ((err = set_smem((const void*)kernel, kBlockProductSmem)) != cudaSuccess) return err;
    kernel<<<dim3(H, B), kThreads, kBlockProductSmem, st>>>(
        (const bf16*)gh, (const bf16*)wo, (const float*)norm, (bf16*)dm, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 2. S = y qf (fp32) and V = bf16(y Wv^T)
  const bool s128 = J % 128 == 0;  // the S product's column tile: 128, else 64
  CUtensorMap tm_y, tm_q, tm_wv;
  if (!tmap(&tm_y, y, M, C, 64) || !tmap(&tm_q, qft, J, C, s128 ? 128 : 64) ||
      !tmap(&tm_wv, (const bf16*)kvw + (size_t)C * C, C, C, kBnWide)) {
    return cudaErrorInvalidValue;
  }
  {
    MlpEpi e{};
    e.K = C;
    e.N = J;
    e.rows_b = N;
    e.gp = (float*)s;
    err = s128 ? launch_gemm<128, kF32, 4>(twopass_s_kernel, tm_y, tm_q, tm_y, tm_q, e, M, st)
               : launch_gemm<64, kF32, 4>(twopass_s64_kernel, tm_y, tm_q, tm_y, tm_q, e, M, st);
    if (err != cudaSuccess) return err;
    e = MlpEpi{};
    e.K = C;
    e.N = C;
    e.rows_b = N;
    e.out = (bf16*)v;
    e.split = C;
    if ((err = launch_gemm<kBnWide, kKV, kStagesWide>(twopass_v_kernel, tm_y, tm_wv, tm_y, tm_wv,
                                                      e, M, st)) != cudaSuccess) {
      return err;
    }
  }
  // 3. pass 0: the ranges' partials
  {
    auto kernel = twopass_range_kernel<ALG, HD>;
    constexpr size_t smem = range_smem<HD>();
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(R, H, B), kWgThreads, smem, st>>>(
        (const float*)s, (const bf16*)v, (const float*)macc, (const bf16*)dm, (float*)ppart,
        (float*)tpart, B, N, n_valid, C, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 4. the merge: tacc, merged
  {
    const long long rows = (long long)B * J;
    twopass_merge_kernel<ALG, GIVEN, HD>
        <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        (const float*)ppart, (const float*)tpart, (const float*)norm, (const bf16*)dm,
        (float*)tacc, (bf16*)merged, B, C, H, R);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 5. pass 1: ds and dv
  {
    auto kernel = twopass_tile_kernel<ALG, GIVEN, HD>;
    constexpr size_t smem = tile_smem<HD>();
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(N / kTile, H, B), kWgThreads, smem, st>>>(
        (const float*)s, (const bf16*)v, (const float*)macc, (const float*)norm, (const bf16*)dm,
        (const float*)tacc, (bf16*)ds, (bf16*)dv, N, n_valid, C, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 6. dy = ds qf^T + dv Wv; dx and the row blocks' dse/dbe sums
  {
    CUtensorMap tm_ds, tm_qn, tm_dv, tm_wn;
    if (!tmap(&tm_ds, ds, M, J, 64) || !tmap(&tm_qn, qft, J, C, 64) ||
        !tmap(&tm_dv, dv, M, C, 64) ||
        !tmap(&tm_wn, (const bf16*)kvw + (size_t)C * C, C, C, 64)) {
      return cudaErrorInvalidValue;
    }
    MlpEpi e{};
    e.K = J;
    e.K2 = C;
    e.N = C;
    e.rows_b = N;
    e.x = (const bf16*)x;
    e.se = (const float*)se;
    e.out = (bf16*)dx;
    e.part = (float*)colpart;
    if ((err = launch_gemm<kBnWide, kDx, kStagesWide>(twopass_dy_kernel, tm_ds, tm_qn, tm_dv,
                                                      tm_wn, e, M, st)) != cudaSuccess) {
      return err;
    }
  }
  // 7. dse, dbe: the row blocks' sums in block order
  {
    const int total = B * 2 * C;
    twopass::twopass_colsum_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        (const float*)colpart, (float*)dsum, N / kRows, C, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 8. dqf = y^T ds, dWv = dv^T y (B N rows), dWo = g_h0^T merged (B I rows)
  if ((err = launch_wgrad(y, ds, (float*)wpart, (float*)dqf, row_major(C, J), 1, B * N, C, J,
                          s_qf, st)) != cudaSuccess) {
    return err;
  }
  if ((err = launch_wgrad(dv, y, (float*)wpart, (float*)dwv, row_major(C, C), 1, B * N, C, C,
                          s_wv, st)) != cudaSuccess) {
    return err;
  }
  return launch_wgrad(gh, merged, (float*)wpart, (float*)dwo, row_major(C, C), 1, B * I, C, C,
                      s_wo, st);
}

// the instance of the head width C / H (body_takes holds it to 48 or 128)
template <int ALG, bool GIVEN>
cudaError_t launch_any(const void* x, const void* se, const void* be, const void* qft,
                       const void* kvw, const void* wo, const void* gh, const void* macc,
                       const void* norm, void* y, void* dm, void* s, void* v, void* ppart,
                       void* tpart, void* tacc, void* merged, void* ds, void* dv, void* colpart,
                       void* wpart, void* dx, void* dsum, void* dqf, void* dwv, void* dwo, int B,
                       int N, int C, int H, int I, int s_qf, int s_wv, int s_wo, int n_valid,
                       cudaStream_t st) {
  auto fn = H > 0 && C / H == 128 ? launch<ALG, GIVEN, 128> : launch<ALG, GIVEN, 48>;
  return fn(x, se, be, qft, kvw, wo, gh, macc, norm, y, dm, s, v, ppart, tpart, tacc, merged, ds,
            dv, colpart, wpart, dx, dsum, dqf, dwv, dwo, B, N, C, H, I, s_qf, s_wv, s_wo, n_valid,
            st);
}

}  // namespace

// norm: sacc (v1, v2) or the wrapper's 1/sacc (v2j); s [B N, J] fp32, v
// [B N, C] bf16, ppart [R, B, J, D] and tpart [R, B, J] fp32 (R ranges of
// 512 points), colpart [B N / 128, 2, C] fp32: scratch; the rest as
// pool_ext_bwd_v1_launch's.
#define TWOPASS_HOPPER_LAUNCH(name, ALG, GIVEN)                                                 \
  extern "C" int name(const void* x, const void* se, const void* be, const void* qft,          \
                      const void* kvw, const void* wo, const void* gh, const void* macc,        \
                      const void* norm, void* y, void* dm, void* s, void* v, void* ppart,       \
                      void* tpart, void* tacc, void* merged, void* ds, void* dv, void* colpart, \
                      void* wpart, void* dx, void* dsum, void* dqf, void* dwv, void* dwo, int B, \
                      int N, int C, int H, int I, int s_qf, int s_wv, int s_wo, int n_valid,    \
                      void* stream) {                                                           \
    return (int)launch_any<ALG, GIVEN>(x, se, be, qft, kvw, wo, gh, macc, norm, y, dm, s, v,   \
                                       ppart, tpart, tacc, merged, ds, dv, colpart, wpart, dx, \
                                       dsum, dqf, dwv, dwo, B, N, C, H, I, s_qf, s_wv, s_wo,   \
                                       n_valid, (cudaStream_t)stream);                         \
  }

TWOPASS_HOPPER_LAUNCH(pool_ext_bwd_v1_hopper_launch, twopass::kV1, false)
TWOPASS_HOPPER_LAUNCH(pool_ext_bwd_v2_hopper_launch, twopass::kV2, false)
TWOPASS_HOPPER_LAUNCH(pool_ext_bwd_v2j_hopper_launch, twopass::kV2, true)
