// Resident attention pool onto the inducers, with the set-level GroupNorm
// statistics computed on the card (folded_pool_layer).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_kernel. Per batch
// element b, with ``prenorm``:
//   s1, s2 = channel sums of x over N; per group g of C/G contiguous
//   channels (count = N * C/G): mean_g = g1 / count, var_g = g2 / count -
//   mean_g^2, inv_g = 1 / sqrt(max(var_g, 0) + 1e-5); mean_c, inv_c [B, C]
//   are outputs;  y = bf16((x - mean_c) * (inv_c * scale) + bias)
// and without it y = x (the wrapper returns mean 0 and inv 1). Then per
// head h:
//   s = y @ qf[:, hI:(h+1)I] [N, I] fp32; m = column max over the N points;
//   l = sum_n exp(max(s - m, -80));  p = bf16(exp(max(s - m, -80)) / l)
//   v = bf16(y @ Wv_h^T) [N, D];  P_h = p^T v [I, D] fp32
//   pooled[b, :, hD:(h+1)D] = bf16(P_h);  h0 = bf16(pooled @ Wo^T) [I, C]
// Where a gradient will be taken the column max m and sum l [B, J], the
// fp32 P [B, I, C] and y [B, N, C] are kept for the backward (pool_bwd.cu).
//
// Bound on the H100: tensor-core operations (2*N*C*(J + C) + 2*N*J*D per
// batch element against 2*N*C bytes of stream). Design: the TPU kernel held
// one batch element's whole [N, J] logit block in VMEM (4 MB fp32 at the
// flagship, 32 MB at the 8k width); a block has 227 KB of shared memory. So
// the stream goes by 64-point tiles:
//   1. the statistics: the channel sums of each tile (one block per tile
//      and batch element), then one block per batch element folds them per
//      group in a fixed order (a group is a run of C/G channels, so no
//      indicator product) into mean_c and inv_c; then y, written once to
//      device memory: every head's block reads each tile twice, and
//      normalising it there cost more than the pool itself;
//   2. the pool: one block per (head, batch element), two passes over the
//      tiles of y: the running column max and sum of the logits, then p
//      normalised before its bf16 rounding (the TPU kernel's rounding
//      point) against the head's values, P in shared memory. The head's qf
//      and Wv slices are staged in shared memory where they fit, as in
//      pool_ext.cu (pool.cuh's layout); the logits are computed twice;
//   3. h0 = pooled @ Wo^T (pool.cuh's linear_nt_kernel).
// The same kernels serve the flagship (C = 384) and the 8k width (C = 768).
// A ragged N comes zero-padded to a multiple of 128 by the wrapper: the
// statistics count the first n_valid points (the padding adds zero to the
// sums) and the pool walks the tiles holding points, the rest of the last
// masked out of the softmax.
#include <cmath>

#include "pool.cuh"

using namespace gecco;

namespace {

// part[b, tile] = [sum x | sum x^2] [2, C] over the 64 rows of one tile of
// batch element b: each thread sums 8 channels (one 16-byte vector) over
// every rp-th row, then the row phases are added in shared memory.
__global__ void __launch_bounds__(kThreads)
pool_layer_sums_kernel(const bf16* __restrict__ x, float* __restrict__ part, int N, int C) {
  __shared__ float red[2][kThreads * 8];
  const int vecs = C / 8, rp = kThreads / vecs;
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int v = threadIdx.x % vecs, r0 = threadIdx.x / vecs;
  float s1[8], s2[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) s1[q] = s2[q] = 0.0f;
  if (r0 < rp) {
    const bf16* xb = x + ((size_t)b * N + (size_t)tile * kPoolTile) * C + v * 8;
    for (int r = r0; r < kPoolTile; r += rp) {
      int4 raw = __ldg(reinterpret_cast<const int4*>(xb + (size_t)r * C));
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float f = __bfloat162float(e[q]);
        s1[q] += f;
        s2[q] += f * f;
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      red[0][r0 * C + v * 8 + q] = s1[q];
      red[1][r0 * C + v * 8 + q] = s2[q];
    }
  }
  __syncthreads();
  float* out = part + ((size_t)b * tiles + tile) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int r = 0; r < rp; ++r) {
      a1 += red[0][r * C + c];
      a2 += red[1][r * C + c];
    }
    out[c] = a1;
    out[C + c] = a2;
  }
}

// One block per batch element: each channel's sums over the tiles (one
// thread per channel), then each group's over its channels (one thread per
// group), in a fixed order -> mean_c, inv_c [B, C].
__global__ void __launch_bounds__(kThreads)
pool_layer_stats_kernel(const float* __restrict__ part, float* __restrict__ mean,
                        float* __restrict__ inv, int tiles, int n_valid, int C, int G) {
  __shared__ float sums[2][kThreads * 8];
  const int b = blockIdx.x, pg = C / G;
  const float count = (float)n_valid * (float)pg;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float c1 = 0.0f, c2 = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const float* pt = part + ((size_t)b * tiles + t) * 2 * C;
      c1 += pt[c];
      c2 += pt[C + c];
    }
    sums[0][c] = c1;
    sums[1][c] = c2;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float g1 = 0.0f, g2 = 0.0f;
    for (int c = g * pg; c < (g + 1) * pg; ++c) {
      g1 += sums[0][c];
      g2 += sums[1][c];
    }
    const float mean_g = g1 / count;
    const float var_g = g2 / count - mean_g * mean_g;
    const float inv_g = 1.0f / sqrtf(fmaxf(var_g, 0.0f) + 1e-5f);
    for (int c = g * pg; c < (g + 1) * pg; ++c) {
      mean[(size_t)b * C + c] = mean_g;
      inv[(size_t)b * C + c] = inv_g;
    }
  }
}

// y = bf16((x - mean_c) * (inv_c * scale) + bias), the GroupNorm + AdaGN
// pre-norm in the TPU kernel's form (not the collapsed x * se + be), one
// block per (64-point tile, b), 8 channels per 16-byte load.
__global__ void __launch_bounds__(kThreads)
pool_layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ inv, const float* __restrict__ scale,
                       const float* __restrict__ bias, bf16* __restrict__ y, int N, int C) {
  const int b = blockIdx.y, vecs = C / 8;
  const size_t base = ((size_t)b * N + (size_t)blockIdx.x * kPoolTile) * C, off = (size_t)b * C;
  for (int t = threadIdx.x; t < kPoolTile * vecs; t += kThreads) {
    const int c0 = (t % vecs) * 8;
    const size_t e = base + (size_t)(t / vecs) * C + c0;
    int4 raw = __ldg(reinterpret_cast<const int4*>(x + e));
    bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const size_t c = off + c0 + q;
      v[q] = __float2bfloat16((__bfloat162float(v[q]) - mean[c]) * (inv[c] * scale[c]) + bias[c]);
    }
    *reinterpret_cast<int4*>(y + e) = raw;
  }
}

// One block per (head h, batch element b) over the pre-normed stream y;
// shared memory: pool.cuh's PoolSmem.
__global__ void __launch_bounds__(kThreads)
pool_layer_kernel(const bf16* __restrict__ yin, const bf16* __restrict__ qf,
                  const bf16* __restrict__ kvw, bf16* __restrict__ pooled,
                  float* __restrict__ macc, float* __restrict__ sacc, float* __restrict__ pacc,
                  int N, int n_valid, int C, int H, int I, int stage_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const PoolSmem L(C, I, D);
  bf16* y = reinterpret_cast<bf16*>(smem + L.y);        // [kPoolTile, C]
  float* s = reinterpret_cast<float*>(smem + L.s);      // [kPoolTile, I] logits
  float* vt = reinterpret_cast<float*>(smem + L.vt);    // [kPoolTile, D] fp32 v
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);  // [I, D] the tile's p^T v
  float* P = reinterpret_cast<float*>(smem + L.P);      // [I, D] accumulator
  float* m = reinterpret_cast<float*>(smem + L.stats);  // [I] column max
  float* l = m + I;                                     // [I] column sum
  bf16* p = reinterpret_cast<bf16*>(smem + L.e);        // [kPoolTile, I] bf16 p
  bf16* vb = reinterpret_cast<bf16*>(smem + L.vb);      // [kPoolTile, D] bf16 v

  const int h = blockIdx.x, b = blockIdx.y;
  const bf16 *qB, *wB;
  int ldqB, ldwB;
  pool_head_operands(smem, L, qf, kvw, C, H, I, h, stage_w, &qB, &ldqB, &wB, &ldwB);
  for (int t = threadIdx.x; t < I * D; t += kThreads) P[t] = 0.0f;
  for (int t = threadIdx.x; t < I; t += kThreads) {
    m[t] = -3.0e38f;
    l[t] = 0.0f;
  }

  // pass 1: the column max and sum of the logits, online across the tiles
  // holding points (the rows of the last from n_valid on are padding)
  for (int n0 = 0; n0 < n_valid; n0 += kPoolTile) {
    const int valid = n_valid - n0;
    stage(y, L.ldy, yin + ((size_t)b * N + n0) * C, C, kPoolTile, C);
    __syncthreads();
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, L.ldy, qB, ldqB, s, L.lds, kPoolTile, I, C);
    __syncthreads();
    // 4 lanes per column, shuffle-reduced; each reads the old max before
    // the shuffles, and lane 0 writes after them
    for (int i = threadIdx.x / 4; i < I; i += kThreads / 4) {
      const float mo = m[i];
      float tmax = -3.0e38f;
      for (int r = threadIdx.x % 4; r < kPoolTile && r < valid; r += 4) {
        tmax = fmaxf(tmax, s[r * L.lds + i]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mn = fmaxf(mo, tmax);
      float sum = 0.0f;
      for (int r = threadIdx.x % 4; r < kPoolTile && r < valid; r += 4) {
        sum += expf(fmaxf(s[r * L.lds + i] - mn, -80.0f));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (threadIdx.x % 4 == 0) {
        l[i] = l[i] * expf(fmaxf(mo - mn, -80.0f)) + sum;
        m[i] = mn;
      }
    }
    __syncthreads();
  }

  // pass 2: p = bf16(e / l) against the head's values (0 on the padding)
  for (int n0 = 0; n0 < n_valid; n0 += kPoolTile) {
    const int valid = n_valid - n0;
    stage(y, L.ldy, yin + ((size_t)b * N + n0) * C, C, kPoolTile, C);
    __syncthreads();
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, L.ldy, qB, ldqB, s, L.lds, kPoolTile, I, C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, L.ldy, wB, ldwB, vt, L.ldv, kPoolTile, D, C);
    __syncthreads();
    for (int t = threadIdx.x; t < kPoolTile * I; t += kThreads) {
      const int r = t / I, i = t % I;
      p[r * L.lde + i] =
          __float2bfloat16(r < valid ? expf(fmaxf(s[r * L.lds + i] - m[i], -80.0f)) / l[i] : 0.0f);
    }
    for (int t = threadIdx.x; t < kPoolTile * D; t += kThreads) {
      vb[(t / D) * L.ldvb + t % D] = __float2bfloat16(vt[(t / D) * L.ldv + t % D]);
    }
    __syncthreads();
    // p^T is p [kPoolTile, I] read as a column-major [I, kPoolTile] operand
    gemm_to_smem<wmma::col_major, wmma::row_major>(p, L.lde, vb, L.ldvb, tmp, L.ldv, I, D,
                                                   kPoolTile);
    __syncthreads();
    for (int t = threadIdx.x; t < I * D; t += kThreads) P[t] += tmp[(t / D) * L.ldv + t % D];
    __syncthreads();
  }

  const size_t ob = (size_t)b * I * C + h * D;
  for (int t = threadIdx.x; t < I * D; t += kThreads) {
    const int i = t / D, d = t % D;
    pooled[ob + (size_t)i * C + d] = __float2bfloat16(P[t]);
    if (pacc != nullptr) pacc[ob + (size_t)i * C + d] = P[t];
  }
  if (macc != nullptr) {
    for (int i = threadIdx.x; i < I; i += kThreads) {
      macc[(size_t)b * J + h * I + i] = m[i];
      sacc[(size_t)b * J + h * I + i] = l[i];
    }
  }
}

}  // namespace

// With the pre-norm (mean non-null), part [B, N / 64, 2, C] fp32 is
// scratch and mean, inv and y [B, N, C] are written; without, mean and y
// must be null (inv, scale and bias are not read) and the pool reads x.
// macc/sacc/pacc null where no gradient will be taken.
extern "C" int pool_layer_launch(const void* x, const void* scale, const void* bias,
                                 const void* qf, const void* kvw, const void* wo, void* part,
                                 void* mean, void* inv, void* y, void* pooled, void* h0,
                                 void* macc, void* sacc, void* pacc, int B, int N, int C, int H,
                                 int I, int G, int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = C / H;
  if (N % kPoolTile || n_valid < 1 || n_valid > N || C % 64 || C / 8 > kThreads || D % 16 ||
      I % 16 || (B * I) % 64 ||
      (mean != nullptr && (G <= 0 || C % G))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (mean != nullptr) {
    pool_layer_sums_kernel<<<dim3(N / kPoolTile, B), kThreads, 0, st>>>((const bf16*)x,
                                                                         (float*)part, N, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pool_layer_stats_kernel<<<B, kThreads, 0, st>>>((const float*)part, (float*)mean, (float*)inv,
                                                    N / kPoolTile, n_valid, C, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pool_layer_norm_kernel<<<dim3(N / kPoolTile, B), kThreads, 0, st>>>(
        (const bf16*)x, (const float*)mean, (const float*)inv, (const float*)scale,
        (const float*)bias, (bf16*)y, N, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const PoolSmem L(C, I, D);
  const int stage_w = L.total <= kMaxSmem;
  const size_t smem = stage_w ? L.total : L.total_unstaged;
  if ((err = set_smem((const void*)pool_layer_kernel, smem)) != cudaSuccess) return (int)err;
  pool_layer_kernel<<<dim3(H, B), kThreads, smem, st>>>(
      (const bf16*)(mean != nullptr ? y : x), (const bf16*)qf, (const bf16*)kvw, (bf16*)pooled,
      (float*)macc, (float*)sacc, (float*)pacc, N, n_valid, C, H, I, stage_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_nt_kernel<<<dim3(C / 64, B * I / 64), kThreads, 0, st>>>(
      (const bf16*)pooled, (const bf16*)wo, (bf16*)h0, B * I, C, C);
  return (int)cudaGetLastError();
}
