// Resident attention pool onto the inducers, with the set-level GroupNorm
// statistics computed on the card (folded_pool_layer): the WMMA body, for
// the shapes the Hopper body (csrc/pool.cu) does not take.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_kernel. Per batch
// element b, with ``prenorm``, mean_c, inv_c [B, C] and y = bf16((x -
// mean_c) * (inv_c * scale) + bias) (pool_layer.cuh), and without it y = x
// (the wrapper returns mean 0 and inv 1). Then per head h:
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
//   1. the pre-norm's statistics and y, written once to device memory
//      (pool_layer.cuh): every head's block reads each tile twice, and
//      normalising it there cost more than the pool itself;
//   2. the pool: one block per (head, batch element), two passes over the
//      tiles of y: the running column max and sum of the logits, then p
//      normalised before its bf16 rounding (the TPU kernel's rounding
//      point) against the head's values, P in shared memory. The head's qf
//      and Wv slices are staged in shared memory where they fit, as in
//      pool_ext.cu (pool.cuh's layout); the logits are computed twice.
//      Where a head's I columns do not fit one block, each block takes a
//      column block of them (pool.cuh's pool_wmma_block), recomputing the
//      values per block;
//   3. h0 = pooled @ Wo^T (pool.cuh's linear_nt_kernel).
// A ragged N comes zero-padded to a multiple of 128 by the wrapper: the
// statistics count the first n_valid points (the padding adds zero to the
// sums) and the pool walks the tiles holding points, the rest of the last
// masked out of the softmax.
#include <cmath>

#include "pool.cuh"
#include "pool_layer.cuh"

using namespace gecco;

namespace {

// One block per (head h, batch element b) over the pre-normed stream y;
// shared memory: pool.cuh's PoolSmem.
__global__ void __launch_bounds__(kThreads)
pool_layer_kernel(const bf16* __restrict__ yin, const bf16* __restrict__ qf,
                  const bf16* __restrict__ kvw, bf16* __restrict__ pooled,
                  float* __restrict__ macc, float* __restrict__ sacc, float* __restrict__ pacc,
                  int N, int n_valid, int C, int H, int I, int IB, int stage_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const PoolSmem L(C, IB, D);
  bf16* y = reinterpret_cast<bf16*>(smem + L.y);        // [kPoolTile, C]
  float* s = reinterpret_cast<float*>(smem + L.s);      // [kPoolTile, IB] logits
  float* vt = reinterpret_cast<float*>(smem + L.vt);    // [kPoolTile, D] fp32 v
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);  // [IB, D] the tile's p^T v
  float* P = reinterpret_cast<float*>(smem + L.P);      // [IB, D] accumulator
  float* m = reinterpret_cast<float*>(smem + L.stats);  // [IB] column max
  float* l = m + IB;                                    // [IB] column sum
  bf16* p = reinterpret_cast<bf16*>(smem + L.e);        // [kPoolTile, IB] bf16 p
  bf16* vb = reinterpret_cast<bf16*>(smem + L.vb);      // [kPoolTile, D] bf16 v

  // the block's columns: i0 ... i0 + IB of head h
  const int h = blockIdx.x / (I / IB), i0 = blockIdx.x % (I / IB) * IB, b = blockIdx.y;
  const bf16 *qB, *wB;
  int ldqB, ldwB;
  pool_head_operands(smem, L, qf, kvw, C, H, I, IB, i0, h, stage_w, &qB, &ldqB, &wB, &ldwB);
  for (int t = threadIdx.x; t < IB * D; t += kThreads) P[t] = 0.0f;
  for (int t = threadIdx.x; t < IB; t += kThreads) {
    m[t] = -3.0e38f;
    l[t] = 0.0f;
  }

  // pass 1: the column max and sum of the logits, online across the tiles
  // holding points (the rows of the last from n_valid on are padding)
  for (int n0 = 0; n0 < n_valid; n0 += kPoolTile) {
    const int valid = n_valid - n0;
    stage(y, L.ldy, yin + ((size_t)b * N + n0) * C, C, kPoolTile, C);
    __syncthreads();
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, L.ldy, qB, ldqB, s, L.lds, kPoolTile, IB,
                                                   C);
    __syncthreads();
    // 4 lanes per column, shuffle-reduced; each reads the old max before
    // the shuffles, and lane 0 writes after them
    for (int i = threadIdx.x / 4; i < IB; i += kThreads / 4) {
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
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, L.ldy, qB, ldqB, s, L.lds, kPoolTile, IB,
                                                   C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, L.ldy, wB, ldwB, vt, L.ldv, kPoolTile, D, C);
    __syncthreads();
    for (int t = threadIdx.x; t < kPoolTile * IB; t += kThreads) {
      const int r = t / IB, i = t % IB;
      p[r * L.lde + i] = __float2bfloat16(
          r < valid ? expf(fmaxf(s[r * L.lds + i] - m[i], -80.0f)) / l[i] : 0.0f);
    }
    for (int t = threadIdx.x; t < kPoolTile * D; t += kThreads) {
      vb[(t / D) * L.ldvb + t % D] = __float2bfloat16(vt[(t / D) * L.ldv + t % D]);
    }
    __syncthreads();
    // p^T is p [kPoolTile, IB] read as a column-major [IB, kPoolTile] operand
    gemm_to_smem<wmma::col_major, wmma::row_major>(p, L.lde, vb, L.ldvb, tmp, L.ldv, IB, D,
                                                   kPoolTile);
    __syncthreads();
    for (int t = threadIdx.x; t < IB * D; t += kThreads) P[t] += tmp[(t / D) * L.ldv + t % D];
    __syncthreads();
  }

  const size_t ob = ((size_t)b * I + i0) * C + h * D;
  for (int t = threadIdx.x; t < IB * D; t += kThreads) {
    const int i = t / D, d = t % D;
    pooled[ob + (size_t)i * C + d] = __float2bfloat16(P[t]);
    if (pacc != nullptr) pacc[ob + (size_t)i * C + d] = P[t];
  }
  if (macc != nullptr) {
    for (int i = threadIdx.x; i < IB; i += kThreads) {
      macc[(size_t)b * J + h * I + i0 + i] = m[i];
      sacc[(size_t)b * J + h * I + i0 + i] = l[i];
    }
  }
}

}  // namespace

// With the pre-norm (mean non-null), part [B, N / 64, 2, C] fp32 is
// scratch and mean, inv and y [B, N, C] are written; without, mean and y
// must be null (inv, scale and bias are not read) and the pool reads x.
// macc/sacc/pacc null where no gradient will be taken.
extern "C" int pool_layer_wmma_launch(const void* x, const void* scale, const void* bias,
                                      const void* qf, const void* kvw, const void* wo,
                                      void* part, void* mean, void* inv, void* y, void* pooled,
                                      void* h0, void* macc, void* sacc, void* pacc, int B, int N,
                                      int C, int H, int I, int G, int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = C / H;
  if (N % kPoolTile || n_valid < 1 || n_valid > N || C % 64 || C / 8 > kThreads || D % 16 ||
      I % 16 || (B * I) % 64 ||
      (mean != nullptr && (G <= 0 || C % G))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (mean != nullptr &&
      (err = pool_layer_prenorm((const bf16*)x, (const float*)scale, (const float*)bias,
                                (float*)part, (float*)mean, (float*)inv, (bf16*)y, B, N, C, G,
                                n_valid, st)) != cudaSuccess) {
    return (int)err;
  }
  const int IB = pool_wmma_block(C, I, D);
  if (IB == 0) return (int)cudaErrorInvalidValue;
  const PoolSmem L(C, IB, D);
  const int stage_w = L.total <= kMaxSmem;
  const size_t smem = stage_w ? L.total : L.total_unstaged;
  if ((err = set_smem((const void*)pool_layer_kernel, smem)) != cudaSuccess) return (int)err;
  pool_layer_kernel<<<dim3(H * (I / IB), B), kThreads, smem, st>>>(
      (const bf16*)(mean != nullptr ? y : x), (const bf16*)qf, (const bf16*)kvw, (bf16*)pooled,
      (float*)macc, (float*)sacc, (float*)pacc, N, n_valid, C, H, I, IB, stage_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_nt_kernel<<<dim3(C / 64, B * I / 64), kThreads, 0, st>>>(
      (const bf16*)pooled, (const bf16*)wo, (bf16*)h0, B * I, C, C);
  return (int)cudaGetLastError();
}
