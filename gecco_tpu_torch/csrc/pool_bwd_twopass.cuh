// The pool backward's two-pass bodies, v1 (pool_ext_bwd_v1.cu) and v2 /
// v2j (pool_ext_bwd_v2.cu): one template, the algebra a parameter.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel_v1
// (v1), _pool_ext_bwd_kernel (v2) and _pool_ext_bwd_kernel_v2j (v2j), the
// bodies GECCO_POOL_BWD forces, at their bf16 rounding points. With
// y = bf16(x * se + be), s = y @ qf (qf^T = qft, the forward's folded
// query), e = exp(max(s - macc, -80)), v = bf16(y @ Wv^T), the forward's
// column max macc and sum sacc, inv = 1/sacc, per batch element and head
// h (I inducers, D channels; J = H I):
//   v1: DM_h = bf16(g_h0 @ Wo[:, hD:(h+1)D])                      [I, D]
//       pass 0: dp = v_h DM_h^T;  t += sum_n e dp;  pacc_h += bf16(e_h)^T v_h
//       then:   t = t inv;  merged_h = bf16(pacc_h inv)
//       pass 1: p = e inv;  ds = bf16(p (dp - t) [s - macc > -80]);
//               dv_h = bf16(bf16(p_h) DM_h)
//   v2: DMs_h = bf16((g_h0 @ Wo[:, hD:(h+1)D]) inv)
//       pass 0: pacc_h += bf16(e_h)^T v_h
//       then:   T = rowsum(DMs_h pacc_h) inv;  merged_h = bf16(pacc_h inv)
//       pass 1: ds = bf16(e (v_h DMs_h^T - T) [s - macc > -80]);
//               dv_h = bf16(bf16(e_h) DMs_h)
//   both: dy = ds qf^T + dv Wv;  dx = bf16(dy se);  dse = sum dy x;
//         dbe = sum dy;  dqf = sum y^T ds;  dWv = sum dv^T y;
//         dWo = sum_b g_h0^T merged
// v2j is v2 with inv read from the wrapper's [B, J] 1/sacc where v2
// forms 1.0f / sacc itself (IEEE division in both: the same bits).
//
// The TPU bodies place DM in a [J, C] matrix, zero off each head's
// columns, and keep a [J, C] (v2) or [J, D] (v1) accumulator; only the
// head-diagonal [I, D] blocks are ever nonzero or read, so these kernels
// keep those blocks alone, and no placement matrix exists.
//
// A ragged N comes zero-padded to a multiple of 128 by the wrapper: e is 0
// on the points from n_valid on in both passes, so they add nothing to
// pacc, t, ds, dv, dy or the weight gradients.
//
// Bound on the H100: tensor-core operations (s, v, e^T v, dp, dv, dy's two
// products and the three weight gradients: ~2 [N, C] x [C, J]-sized
// products of each kind per batch element). Design (a simple body: WMMA
// tiles staged in shared memory; eight launches, more with split sums):
// 0. prenorm_kernel (backward.cuh): y [B, N, C] once;
// 1. twopass_fold_kernel, one block per (head, b): DM_h or DMs_h [B, J, D];
// 2. twopass_pass0_kernel, one block per (head, b), walking all N points
//    in 32-point tiles: s_h, v_h (WMMA, qf^T_h and Wv_h read in place from
//    L2), e, pacc_h += bf16(e)^T v_h in shared memory (v1: dp and t too);
//    at the end tacc [B, J] and merged [B, I, C]. One block owns each
//    (head, b): no atomics, a fixed sum order;
// 3. twopass_pass1_kernel, one block per (32-point tile, b), the heads in
//    turn: s_h, v_h, dp, ds (bf16, also to device memory for dqf), dv_h
//    (bf16, also to device memory for dWv), dy += ds_h qf^T_h + dv_h Wv_h
//    in registers; dx, and the tile's column partials of dse and dbe;
// 4. twopass_colsum_kernel: dse, dbe = the tiles' partials in tile order;
// 5. wgrad_kernel (wgrad.cuh) three times: dqf = y^T ds and dWv = dv^T y
//    over the B N rows, dWo = g_h0^T merged over the B I rows, each a
//    fixed-order split-K. Every output is the same bits from call to call.
#pragma once

#include <cmath>

#include "backward.cuh"
#include "wgrad.cuh"

namespace gecco {
namespace twopass {

enum Alg { kV1 = 0, kV2 = 1 };

constexpr int kTN = 32;  // points per tile of both passes

inline bool fits(int C, int I, int D);

// The shapes these bodies take (folded_attention.py _pool_twopass_takes:
// change both together): C % 128 == 0 up to 768 (the pass-1 register tiles
// and wgrad.cuh's 128-row tiles), D % 16 == 0, I % 16 == 0 with J % 64 ==
// 0 (wgrad.cuh's 64-column tail; three heads of 64 inducers give J 192)
// and B I % 64 == 0 (wgrad.cuh), N % 64 == 0 (a ragged N comes padded to
// 128s), and both passes' blocks within the SM's shared memory.
inline bool takes(int B, int N, int C, int H, int I) {
  const int D = C / H;
  return C % 128 == 0 && C <= 768 && C % H == 0 && D % 16 == 0 && I % 16 == 0 &&
         (H * I) % 64 == 0 && (B * I) % 64 == 0 && N % 64 == 0 && fits(C, I, D);
}

// 1/sacc of column idx: read (v2j, GIVEN) or formed here (v1, v2)
template <bool GIVEN>
__device__ __forceinline__ float inv_norm(const float* norm, size_t idx) {
  if constexpr (GIVEN) {
    return norm[idx];
  } else {
    return 1.0f / norm[idx];
  }
}

// the offset of a region of ``bytes`` at ``o`` (then past it, 128-aligned)
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 127) / 128 * 128;
  return at;
}

// out[M, N] (fp32, shared, row-major) += A^T B, A [K, M] and B [K, N] bf16
// row-major in shared memory; one 16 x 16 output tile a warp at a time.
__device__ __forceinline__ void acc_atb(float* out, int ldo, const bf16* A, int lda, const bf16* B,
                                        int ldb, int M, int N, int K) {
  const int warp = threadIdx.x / 32, tn = N / 16;
  for (int t = warp; t < (M / 16) * tn; t += kWarps) {
    const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
    FragC c;
    wmma::load_matrix_sync(c, out + (size_t)m0 * ldo + n0, ldo, wmma::mem_row_major);
    for (int k0 = 0; k0 < K; k0 += 16) {
      FragA<wmma::col_major> a;
      FragB<wmma::row_major> b;
      wmma::load_matrix_sync(a, A + (size_t)k0 * lda + m0, lda);
      wmma::load_matrix_sync(b, B + (size_t)k0 * ldb + n0, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(out + (size_t)m0 * ldo + n0, c, ldo, wmma::mem_row_major);
  }
}

// DM_h (v1) or DMs_h (v2) [B, J, D] bf16, one block per (head h, b).
template <int ALG, bool GIVEN>
__global__ void __launch_bounds__(kThreads)
twopass_fold_kernel(const bf16* __restrict__ gh, const bf16* __restrict__ wo,
                    const float* __restrict__ norm, bf16* __restrict__ dm, int C, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I, h = blockIdx.x, b = blockIdx.y;
  const size_t col0 = (size_t)b * J + h * I;
  bf16* out = dm + col0 * D;
  block_product<wmma::row_major, wmma::row_major>(
      gh + (size_t)b * I * C, C, wo + h * D, C, I, D, C, reinterpret_cast<float*>(smem),
      [&](int r, int c, float v) {
        out[(size_t)r * D + c] =
            __float2bfloat16(ALG == kV1 ? v : v * inv_norm<GIVEN>(norm, col0 + r));
      });
}

// Shared memory of the two passes (byte offsets, each region 128-aligned).
struct Pass0Smem {
  size_t ys, s, vf, vb, eb, pacc, dmh, dp, t, total;
  __host__ __device__ Pass0Smem(int C, int I, int D) {
    size_t o = 0;
    ys = take(o, (size_t)kTN * (C + kPad) * 2);
    s = take(o, (size_t)kTN * (I + kPadF) * 4);
    vf = take(o, (size_t)kTN * (D + kPadF) * 4);
    vb = take(o, (size_t)kTN * (D + kPad) * 2);
    eb = take(o, (size_t)kTN * (I + kPad) * 2);
    pacc = take(o, (size_t)I * (D + kPadF) * 4);
    dmh = take(o, (size_t)I * (D + kPad) * 2);
    dp = take(o, (size_t)kTN * (I + kPadF) * 4);
    t = take(o, (size_t)I * 4);
    total = o;
  }
};

struct Pass1Smem {
  size_t ys, s, dp, vf, vb, dmh, dsb, pe, dvb, total;
  __host__ __device__ Pass1Smem(int C, int I, int D) {
    size_t o = 0;
    // the y tile, then (after the heads) the fp32 dy tile in its place
    const size_t y_bytes = (size_t)kTN * (C + kPad) * 2, dy_bytes = (size_t)kTN * (C + kPadF) * 4;
    ys = take(o, y_bytes > dy_bytes ? y_bytes : dy_bytes);
    s = take(o, (size_t)kTN * (I + kPadF) * 4);
    dp = take(o, (size_t)kTN * (I + kPadF) * 4);
    vf = take(o, (size_t)kTN * (D + kPadF) * 4);
    vb = take(o, (size_t)kTN * (D + kPad) * 2);
    dmh = take(o, (size_t)I * (D + kPad) * 2);
    dsb = take(o, (size_t)kTN * (I + kPad) * 2);
    pe = take(o, (size_t)kTN * (I + kPad) * 2);
    dvb = take(o, (size_t)kTN * (D + kPad) * 2);
    total = o;
  }
};

// both passes' blocks within the SM's shared memory (folded_attention.py
// _twopass_smem repeats the two layouts: change them together)
inline bool fits(int C, int I, int D) {
  return Pass0Smem(C, I, D).total <= kMaxSmem && Pass1Smem(C, I, D).total <= kMaxSmem;
}

// s_h = y @ qf_h [kTN, I] and v_h = bf16(y @ Wv_h^T) [kTN, D] of the staged
// y tile (both passes), qf^T_h and Wv_h read as column-major operands in
// place; the fp32 v_h passes through vf. Ends on a barrier.
__device__ __forceinline__ void tile_logits_values(const bf16* ys, int ldy, const bf16* qfh,
                                                   const bf16* wvh, float* s, int lds, float* vf,
                                                   int ldvf, bf16* vb, int ldvb, int C, int I,
                                                   int D) {
  gemm_to_smem<wmma::row_major, wmma::col_major>(ys, ldy, qfh, C, s, lds, kTN, I, C);
  gemm_to_smem<wmma::row_major, wmma::col_major>(ys, ldy, wvh, C, vf, ldvf, kTN, D, C);
  __syncthreads();
  for (int t = threadIdx.x; t < kTN * D; t += kThreads) {
    const int r = t / D, q = t % D;
    vb[r * ldvb + q] = __float2bfloat16(vf[r * ldvf + q]);
  }
  __syncthreads();
}

// Pass 0, one block per (head h, b) over all N points: pacc_h, and for v1
// dp and t; at the end tacc [B, J] (t or T, times inv) and merged [B, I, C].
template <int ALG, bool GIVEN>
__global__ void __launch_bounds__(kThreads)
twopass_pass0_kernel(const bf16* __restrict__ y, const bf16* __restrict__ qft,
                     const bf16* __restrict__ kvw, const float* __restrict__ macc,
                     const float* __restrict__ norm, const bf16* __restrict__ dm,
                     float* __restrict__ tacc, bf16* __restrict__ merged, int N, int n_valid,
                     int C, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I, h = blockIdx.x, b = blockIdx.y;
  const Pass0Smem L(C, I, D);
  const int ldy = C + kPad, lds = I + kPadF, ldvf = D + kPadF, ldvb = D + kPad, ldeb = I + kPad,
            ldp = D + kPadF, lddm = D + kPad;
  bf16* ys = reinterpret_cast<bf16*>(smem + L.ys);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* vf = reinterpret_cast<float*>(smem + L.vf);
  bf16* vb = reinterpret_cast<bf16*>(smem + L.vb);
  bf16* eb = reinterpret_cast<bf16*>(smem + L.eb);
  float* pacc = reinterpret_cast<float*>(smem + L.pacc);
  bf16* dmh = reinterpret_cast<bf16*>(smem + L.dmh);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  float* tsum = reinterpret_cast<float*>(smem + L.t);

  const size_t col0 = (size_t)b * J + h * I;
  const bf16* qfh = qft + (size_t)h * I * C;
  const bf16* wvh = kvw + (size_t)(C + h * D) * C;
  const float* mb = macc + col0;
  for (int t = threadIdx.x; t < I * ldp; t += kThreads) pacc[t] = 0.0f;
  for (int t = threadIdx.x; t < I; t += kThreads) tsum[t] = 0.0f;
  stage(dmh, lddm, dm + col0 * D, D, I, D);
  for (int n0 = 0; n0 < N; n0 += kTN) {
    stage(ys, ldy, y + ((size_t)b * N + n0) * C, C, kTN, C);
    __syncthreads();
    tile_logits_values(ys, ldy, qfh, wvh, s, lds, vf, ldvf, vb, ldvb, C, I, D);
    for (int t = threadIdx.x; t < kTN * I; t += kThreads) {
      const int r = t / I, q = t % I;
      // a ragged tail's padding rows (from n_valid on) take no part
      const float e = n0 + r < n_valid ? expf(fmaxf(s[r * lds + q] - mb[q], -80.0f)) : 0.0f;
      s[r * lds + q] = e;
      eb[r * ldeb + q] = __float2bfloat16(e);
    }
    if (ALG == kV1) {
      // dp = v_h DM_h^T, then t += sum over the tile's points of e dp
      gemm_to_smem<wmma::row_major, wmma::col_major>(vb, ldvb, dmh, lddm, dp, lds, kTN, I, D);
    }
    __syncthreads();
    if (ALG == kV1) {
      for (int q = threadIdx.x; q < I; q += kThreads) {
        float a = 0.0f;
        for (int r = 0; r < kTN; ++r) a += s[r * lds + q] * dp[r * lds + q];
        tsum[q] += a;
      }
    }
    acc_atb(pacc, ldp, eb, ldeb, vb, ldvb, I, D, kTN);
    __syncthreads();  // every buffer is rewritten by the next tile
  }
  // tacc and merged_h, one warp per row of the head's block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < I; r += kWarps) {
    const float inv = inv_norm<GIVEN>(norm, col0 + r);
    float acc = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float p = pacc[r * ldp + c];
      if (ALG == kV2) acc += __bfloat162float(dmh[r * lddm + c]) * p;
      merged[((size_t)b * I + r) * C + h * D + c] = __float2bfloat16(p * inv);
    }
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) tacc[col0 + r] = (ALG == kV1 ? tsum[r] : acc) * inv;
  }
}

// Pass 1, one block per (32-point tile, b), the heads in turn: ds and dv
// to device memory, dy in registers; dx and the tile's column partials
// part[b, tile, 0 / 1, C] of dse / dbe.
template <int ALG, bool GIVEN, int COLS>
__global__ void __launch_bounds__(kThreads)
twopass_pass1_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
                     const bf16* __restrict__ y, const bf16* __restrict__ qft,
                     const bf16* __restrict__ kvw, const float* __restrict__ macc,
                     const float* __restrict__ norm, const bf16* __restrict__ dm,
                     const float* __restrict__ tacc, bf16* __restrict__ ds_out,
                     bf16* __restrict__ dv_out, bf16* __restrict__ dx, float* __restrict__ part,
                     int N, int n_valid, int C, int H, int I) {
  constexpr int ROWS = kTN / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I, b = blockIdx.y, tile = blockIdx.x, n0 = tile * kTN;
  const Pass1Smem L(C, I, D);
  const int ldy = C + kPad, ldf = C + kPadF, lds = I + kPadF, ldvf = D + kPadF, ldvb = D + kPad,
            lddm = D + kPad, ldb = I + kPad;
  bf16* ys = reinterpret_cast<bf16*>(smem + L.ys);
  float* dyb = reinterpret_cast<float*>(smem + L.ys);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  float* vf = reinterpret_cast<float*>(smem + L.vf);
  bf16* vb = reinterpret_cast<bf16*>(smem + L.vb);
  bf16* dmh = reinterpret_cast<bf16*>(smem + L.dmh);
  bf16* dsb = reinterpret_cast<bf16*>(smem + L.dsb);
  bf16* pe = reinterpret_cast<bf16*>(smem + L.pe);
  bf16* dvb = reinterpret_cast<bf16*>(smem + L.dvb);

  const size_t row0 = (size_t)b * N + n0;
  stage(ys, ldy, y + row0 * C, C, kTN, C);
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int h = 0; h < H; ++h) {
    const size_t col0 = (size_t)b * J + h * I;
    const bf16* qfh = qft + (size_t)h * I * C;
    const bf16* wvh = kvw + (size_t)(C + h * D) * C;
    stage(dmh, lddm, dm + col0 * D, D, I, D);
    __syncthreads();
    tile_logits_values(ys, ldy, qfh, wvh, s, lds, vf, ldvf, vb, ldvb, C, I, D);
    // dp = v_h DM_h^T (v1), v_h DMs_h^T (v2)
    gemm_to_smem<wmma::row_major, wmma::col_major>(vb, ldvb, dmh, lddm, dp, lds, kTN, I, D);
    __syncthreads();
    for (int t = threadIdx.x; t < kTN * I; t += kThreads) {
      const int r = t / I, q = t % I;
      const float z = s[r * lds + q] - macc[col0 + q];
      // e, and so ds and dv, 0 on a ragged tail's padding rows
      const float e = n0 + r < n_valid ? expf(fmaxf(z, -80.0f)) : 0.0f;
      float d, w;
      if (ALG == kV1) {
        w = e * inv_norm<GIVEN>(norm, col0 + q);  // p
        d = z > -80.0f ? w * (dp[r * lds + q] - tacc[col0 + q]) : 0.0f;
      } else {
        w = e;
        d = z > -80.0f ? e * (dp[r * lds + q] - tacc[col0 + q]) : 0.0f;
      }
      const bf16 db = __float2bfloat16(d);
      dsb[r * ldb + q] = db;
      pe[r * ldb + q] = __float2bfloat16(w);
      ds_out[(row0 + r) * J + h * I + q] = db;
    }
    __syncthreads();
    // dv_h = bf16(bf16(p or e)_h DM_h)
    gemm_to_smem<wmma::row_major, wmma::row_major>(pe, ldb, dmh, lddm, vf, ldvf, kTN, D, I);
    __syncthreads();
    for (int t = threadIdx.x; t < kTN * D; t += kThreads) {
      const int r = t / D, q = t % D;
      const bf16 v = __float2bfloat16(vf[r * ldvf + q]);
      dvb[r * ldvb + q] = v;
      dv_out[(row0 + r) * C + h * D + q] = v;
    }
    __syncthreads();
    // dy += bf16(ds_h) qf^T_h + bf16(dv_h) Wv_h
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, dsb, ldb, qfh, C, C, I);
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, dvb, ldvb, wvh, C, C, D);
    __syncthreads();  // dmh, s, dp, dsb, pe, dvb (and, after the last head, ys) are rewritten
  }
  acc_store(acc, dyb, ldf, C);
  __syncthreads();
  const float* seb = se + (size_t)b * C;
  float* pb = part + ((size_t)b * (N / kTN) + tile) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s_se = 0.0f, s_be = 0.0f;
    for (int r = 0; r < kTN; ++r) {
      const float d = dyb[r * ldf + c];
      const size_t e = (row0 + r) * C + c;
      dx[e] = __float2bfloat16(d * seb[c]);
      s_se += d * __bfloat162float(x[e]);
      s_be += d;
    }
    pb[c] = s_se;
    pb[C + c] = s_be;
  }
}

// out[b, q, c] = the sum over the tiles of part[b, tile, q, c], in tile order
__global__ void __launch_bounds__(kThreads)
twopass_colsum_kernel(const float* __restrict__ part, float* __restrict__ out, int tiles, int C,
                      int total) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int b = idx / (2 * C), qc = idx % (2 * C);
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += part[((size_t)b * tiles + t) * 2 * C + qc];
  out[idx] = s;
}

template <int ALG, bool GIVEN, int COLS>
inline cudaError_t launch_pass1(const bf16* x, const float* se, const bf16* y, const bf16* qft,
                                const bf16* kvw, const float* macc, const float* norm,
                                const bf16* dm, const float* tacc, bf16* ds, bf16* dv, bf16* dx,
                                float* part, int B, int N, int n_valid, int C, int H, int I,
                                cudaStream_t st) {
  auto kernel = twopass_pass1_kernel<ALG, GIVEN, COLS>;
  const size_t smem = Pass1Smem(C, I, C / H).total;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kTN, B), kThreads, smem, st>>>(x, se, y, qft, kvw, macc, norm, dm, tacc, ds,
                                                  dv, dx, part, N, n_valid, C, H, I);
  return cudaGetLastError();
}

// pass 1's instance for C (COLS = C / 128 register tile columns a warp)
template <int ALG, bool GIVEN>
inline decltype(&launch_pass1<ALG, GIVEN, 1>) pass1_for(int C) {
  switch (C / 128) {
    case 1: return launch_pass1<ALG, GIVEN, 1>;
    case 2: return launch_pass1<ALG, GIVEN, 2>;
    case 3: return launch_pass1<ALG, GIVEN, 3>;
    case 4: return launch_pass1<ALG, GIVEN, 4>;
    case 5: return launch_pass1<ALG, GIVEN, 5>;
    default: return launch_pass1<ALG, GIVEN, 6>;
  }
}

// The whole backward of one body (see the top of this file). norm is sacc
// (v1, v2) or 1/sacc (v2j, GIVEN); wpart holds the weight gradients'
// split partials (the largest of s_qf C J, s_wv C C, s_wo C C floats where
// a split count exceeds 1).
template <int ALG, bool GIVEN>
inline cudaError_t launch(const void* x, const void* se, const void* be, const void* qft,
                          const void* kvw, const void* wo, const void* gh, const void* macc,
                          const void* norm, void* y, void* dm, void* tacc, void* merged, void* ds,
                          void* dv, void* colpart, void* wpart, void* dx, void* dsum, void* dqf,
                          void* dwv, void* dwo, int B, int N, int C, int H, int I, int s_qf,
                          int s_wv, int s_wo, int n_valid, cudaStream_t st) {
  if (!takes(B, N, C, H, I) || n_valid < 1 || n_valid > N) return cudaErrorInvalidValue;
  const int D = C / H, J = H * I;
  cudaError_t err;
  // 0. y = bf16(x se + be)
  if ((err = launch_prenorm((const bf16*)x, (const float*)se, (const float*)be, (bf16*)y, B, N,
                            C, st)) != cudaSuccess) {
    return err;
  }
  // 1. DM_h / DMs_h
  {
    auto kernel = twopass_fold_kernel<ALG, GIVEN>;
    if ((err = set_smem((const void*)kernel, kBlockProductSmem)) != cudaSuccess) return err;
    kernel<<<dim3(H, B), kThreads, kBlockProductSmem, st>>>(
        (const bf16*)gh, (const bf16*)wo, (const float*)norm, (bf16*)dm, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 2. pass 0: tacc, merged
  {
    auto kernel = twopass_pass0_kernel<ALG, GIVEN>;
    const size_t smem = Pass0Smem(C, I, D).total;
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(H, B), kThreads, smem, st>>>((const bf16*)y, (const bf16*)qft, (const bf16*)kvw,
                                              (const float*)macc, (const float*)norm,
                                              (const bf16*)dm, (float*)tacc, (bf16*)merged, N,
                                              n_valid, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 3. pass 1: ds, dv, dx and the dse/dbe partials
  err = pass1_for<ALG, GIVEN>(C)((const bf16*)x, (const float*)se, (const bf16*)y,
                                 (const bf16*)qft, (const bf16*)kvw, (const float*)macc,
                                 (const float*)norm, (const bf16*)dm, (const float*)tacc,
                                 (bf16*)ds, (bf16*)dv, (bf16*)dx, (float*)colpart, B, N, n_valid,
                                 C, H, I, st);
  if (err != cudaSuccess) return err;
  // 4. dse, dbe
  {
    const int total = B * 2 * C;
    twopass_colsum_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        (const float*)colpart, (float*)dsum, N / kTN, C, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 5. dqf = y^T ds, dWv = dv^T y (B N rows), dWo = g_h0^T merged (B I rows)
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

}  // namespace twopass
}  // namespace gecco
