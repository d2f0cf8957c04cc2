// Tiled online-softmax attention pool onto the inducers.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_kernel_wfold
// and _pool_ext_kernel (both served by folded_pool_ext), in the v-stream
// form of the latter. Per batch element b and head h, with y = bf16(x*se+be):
//   s = y @ qf[:, hI:(h+1)I]              [N, I] logits (fp32)
//   v = bf16(y @ Wv_h^T)                   [N, D]
//   softmax over the POINT axis per column, online across point tiles:
//   running max m (from -3e38), corr = exp(max(m_old - m_new, -80)),
//   e = exp(max(s - m_new, -80)), l = l * corr + sum e,
//   P = P * corr + bf16(e)^T @ v           [I, D] fp32
//   pooled[b, :, hD:(h+1)D] = bf16(P / l)
// and a second kernel: h0 = bf16(pooled @ Wo^T)  [B, I, C]. Where the
// caller asks (a gradient will be taken), the final column max m and sum l
// are written to macc/sacc [B, J] for the backward (pool_ext_bwd.cu).
//
// Bound on the H100: tensor-core operations (2*N*C*(J + C) + 2*N*J*D per
// batch element against 2*N*C bytes of stream read: about 900 FLOP per byte
// at the flagship). Design: the TPU carried the running max, sum and
// accumulator across its sequential point-tile axis; here one block owns one
// (batch, head) pair and loops over all N itself, so the online softmax
// needs no merge pass. Splitting by head keeps the accumulator at [I, D]
// fp32 (12 KB) instead of the all-head [C, J] (786 KB) that the TPU's folded
// Wv.Wo form would need; the head sum of the output projection is the
// second kernel's K = C contraction. The head's qf and Wv slices are staged
// in shared memory once per block where they fit (the flagship; not the 8k
// width, where they are read from L2). Each block re-reads and re-normalises
// the stream tile for its head (H reads of the stream, mostly from L2).
// The same kernel serves the flagship (C = 384) and the 8k width (C = 768).
#include <cmath>

#include "common.cuh"

using namespace gecco;

namespace {

constexpr int kTile = 64;

// Shared-memory layout of the pool kernel, in bytes from the start; the
// head's weight operands qf_h [C, I] and Wv_h [D, C] are staged at the end
// where they fit (stage_w), else read from device memory.
struct PoolSmem {
  int ldy, lds, ldv, lde, ldvb, ldq, ldw;
  size_t y, s, vt, tmp, P, stats, e, vb, qst, wst, total_unstaged, total;
  __host__ __device__ PoolSmem(int C, int I, int D) {
    ldy = C + kPad; lds = I + kPadF; ldv = D + kPadF; lde = I + kPad; ldvb = D + kPad;
    ldq = I + kPad; ldw = C + kPad;
    y = 0;
    s = y + (size_t)kTile * ldy * 2;
    vt = s + (size_t)kTile * lds * 4;
    tmp = vt + (size_t)kTile * ldv * 4;
    P = tmp + (size_t)I * ldv * 4;
    stats = P + (size_t)I * D * 4;
    e = stats + (size_t)3 * I * 4;
    vb = e + (size_t)kTile * lde * 2;
    qst = vb + (size_t)kTile * ldvb * 2;
    total_unstaged = qst;
    wst = qst + (size_t)C * ldq * 2;
    total = wst + (size_t)D * ldw * 2;
  }
};

__global__ void __launch_bounds__(kThreads)
pool_kernel(const bf16* __restrict__ x, const float* __restrict__ se, const float* __restrict__ be,
            const bf16* __restrict__ qf, const bf16* __restrict__ kvw, bf16* __restrict__ pooled,
            float* __restrict__ macc, float* __restrict__ sacc, int N, int C, int H, int I,
            int stage_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const PoolSmem L(C, I, D);
  bf16* y = reinterpret_cast<bf16*>(smem + L.y);        // [kTile, C]
  float* s = reinterpret_cast<float*>(smem + L.s);      // [kTile, I] logits, then fp32 e
  float* vt = reinterpret_cast<float*>(smem + L.vt);    // [kTile, D] fp32 v
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);  // [I, D] the tile's e^T v
  float* P = reinterpret_cast<float*>(smem + L.P);      // [I, D] accumulator
  float* m = reinterpret_cast<float*>(smem + L.stats);  // [I] running max
  float* l = m + I;                                     // [I] running sum
  float* corr = l + I;                                  // [I]
  bf16* e = reinterpret_cast<bf16*>(smem + L.e);        // [kTile, I] bf16 e
  bf16* vb = reinterpret_cast<bf16*>(smem + L.vb);      // [kTile, D] bf16 v

  const int h = blockIdx.x, b = blockIdx.y;
  // Wv_h = kvw[C + hD : C + (h+1)D, :], read as a column-major [C, D] operand
  const bf16* qB = qf + h * I;
  int ldqB = J;
  const bf16* wB = kvw + (size_t)(C + h * D) * C;
  int ldwB = C;
  if (stage_w) {
    bf16* qst = reinterpret_cast<bf16*>(smem + L.qst);
    bf16* wst = reinterpret_cast<bf16*>(smem + L.wst);
    stage(qst, L.ldq, qB, J, C, I);
    stage(wst, L.ldw, wB, C, D, C);
    qB = qst;
    ldqB = L.ldq;
    wB = wst;
    ldwB = L.ldw;
  }
  for (int t = threadIdx.x; t < I * D; t += kThreads) P[t] = 0.0f;
  for (int t = threadIdx.x; t < I; t += kThreads) {
    m[t] = -3.0e38f;
    l[t] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += kTile) {
    load_prenorm(y, L.ldy, x + ((size_t)b * N + n0) * C, se + (size_t)b * C, be + (size_t)b * C,
                 kTile, C);
    __syncthreads();
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, L.ldy, qB, ldqB, s, L.lds, kTile, I, C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, L.ldy, wB, ldwB, vt, L.ldv, kTile, D, C);
    __syncthreads();
    // column max over the tile: 4 lanes per column, shuffle-reduced
    for (int i = threadIdx.x / 4; i < I; i += kThreads / 4) {
      float tmax = -3.0e38f;
      for (int r = threadIdx.x % 4; r < kTile; r += 4) tmax = fmaxf(tmax, s[r * L.lds + i]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      if (threadIdx.x % 4 == 0) {
        const float mn = fmaxf(m[i], tmax);
        corr[i] = expf(fmaxf(m[i] - mn, -80.0f));
        m[i] = mn;
      }
    }
    for (int t = threadIdx.x; t < kTile * D; t += kThreads) {
      vb[(t / D) * L.ldvb + t % D] = __float2bfloat16(vt[(t / D) * L.ldv + t % D]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kTile * I; t += kThreads) {
      const int r = t / I, i = t % I;
      const float ev = expf(fmaxf(s[r * L.lds + i] - m[i], -80.0f));
      s[r * L.lds + i] = ev;
      e[r * L.lde + i] = __float2bfloat16(ev);
    }
    __syncthreads();
    for (int i = threadIdx.x / 4; i < I; i += kThreads / 4) {
      float sum = 0.0f;
      for (int r = threadIdx.x % 4; r < kTile; r += 4) sum += s[r * L.lds + i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (threadIdx.x % 4 == 0) l[i] = l[i] * corr[i] + sum;
    }
    // e^T is e [kTile, I] read as a column-major [I, kTile] operand
    gemm_to_smem<wmma::col_major, wmma::row_major>(e, L.lde, vb, L.ldvb, tmp, L.ldv, I, D, kTile);
    __syncthreads();
    for (int t = threadIdx.x; t < I * D; t += kThreads) {
      P[t] = P[t] * corr[t / D] + tmp[(t / D) * L.ldv + t % D];
    }
    __syncthreads();
  }

  bf16* out = pooled + (size_t)b * I * C + h * D;
  for (int t = threadIdx.x; t < I * D; t += kThreads) {
    const int i = t / D, d = t % D;
    out[(size_t)i * C + d] = __float2bfloat16(P[t] * (1.0f / l[i]));
  }
  if (macc != nullptr) {
    for (int i = threadIdx.x; i < I; i += kThreads) {
      macc[(size_t)b * J + h * I + i] = m[i];
      sacc[(size_t)b * J + h * I + i] = l[i];
    }
  }
}

// out[M, Nout] = bf16(A[M, K] @ W[Nout, K]^T), one 64 x 64 output tile per
// block; W read as a column-major [K, Nout] operand.
__global__ void __launch_bounds__(kThreads)
linear_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, bf16* __restrict__ out,
                 int M, int Nout, int K) {
  __shared__ __align__(128) float tile[64 * 64];
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  gemm_to_smem<wmma::row_major, wmma::col_major>(A + (size_t)m0 * K, K, W + (size_t)n0 * K, K,
                                                 tile, 64, 64, 64, K);
  __syncthreads();
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    out[(size_t)(m0 + t / 64) * Nout + n0 + t % 64] = __float2bfloat16(tile[t]);
  }
}

}  // namespace

extern "C" int pool_ext_launch(const void* x, const void* se, const void* be, const void* qf,
                               const void* kvw, const void* wo, void* pooled, void* h0,
                               void* macc, void* sacc, int B, int N, int C, int H, int I,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PoolSmem L(C, I, C / H);
  const int stage_w = L.total <= kMaxSmem;
  const size_t smem = stage_w ? L.total : L.total_unstaged;
  cudaError_t err = set_smem((const void*)pool_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pool_kernel<<<dim3(H, B), kThreads, smem, st>>>(
      (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)qf, (const bf16*)kvw,
      (bf16*)pooled, (float*)macc, (float*)sacc, N, C, H, I, stage_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  linear_nt_kernel<<<dim3(C / 64, B * I / 64), kThreads, 0, st>>>(
      (const bf16*)pooled, (const bf16*)wo, (bf16*)h0, B * I, C, C);
  return (int)cudaGetLastError();
}
