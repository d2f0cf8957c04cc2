// Tiled online-softmax attention pool onto the inducers: the WMMA body,
// for the shapes the Hopper design (csrc/pool_ext.cu: I == 64, D == 48,
// H % 8 == 0) does not take, e.g. D 32 or 128 (the wrapper's
// _pool_ext_body chooses by shape).
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
// It takes C % 64, D % 16 and I % 16 == 0 where one block's shared memory
// fits (the upsample demo's 4 x 32 heads at C 128, 3 x 128 at C 384).
// The block's layout, its weight staging and the output projection are in
// pool.cuh, shared with the resident pool (pool.cu).
#include <cmath>

#include "pool.cuh"

using namespace gecco;

namespace {

__global__ void __launch_bounds__(kThreads)
pool_kernel(const bf16* __restrict__ x, const float* __restrict__ se, const float* __restrict__ be,
            const bf16* __restrict__ qf, const bf16* __restrict__ kvw, bf16* __restrict__ pooled,
            float* __restrict__ macc, float* __restrict__ sacc, int N, int C, int H, int I,
            int stage_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const PoolSmem L(C, I, D);
  bf16* y = reinterpret_cast<bf16*>(smem + L.y);        // [kPoolTile, C]
  float* s = reinterpret_cast<float*>(smem + L.s);      // [kPoolTile, I] logits, then fp32 e
  float* vt = reinterpret_cast<float*>(smem + L.vt);    // [kPoolTile, D] fp32 v
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);  // [I, D] the tile's e^T v
  float* P = reinterpret_cast<float*>(smem + L.P);      // [I, D] accumulator
  float* m = reinterpret_cast<float*>(smem + L.stats);  // [I] running max
  float* l = m + I;                                     // [I] running sum
  float* corr = l + I;                                  // [I]
  bf16* e = reinterpret_cast<bf16*>(smem + L.e);        // [kPoolTile, I] bf16 e
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

  for (int n0 = 0; n0 < N; n0 += kPoolTile) {
    load_prenorm(y, L.ldy, x + ((size_t)b * N + n0) * C, se + (size_t)b * C, be + (size_t)b * C,
                 kPoolTile, C);
    __syncthreads();
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, L.ldy, qB, ldqB, s, L.lds, kPoolTile, I, C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, L.ldy, wB, ldwB, vt, L.ldv, kPoolTile, D, C);
    __syncthreads();
    // column max over the tile: 4 lanes per column, shuffle-reduced
    for (int i = threadIdx.x / 4; i < I; i += kThreads / 4) {
      float tmax = -3.0e38f;
      for (int r = threadIdx.x % 4; r < kPoolTile; r += 4) tmax = fmaxf(tmax, s[r * L.lds + i]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      if (threadIdx.x % 4 == 0) {
        const float mn = fmaxf(m[i], tmax);
        corr[i] = expf(fmaxf(m[i] - mn, -80.0f));
        m[i] = mn;
      }
    }
    for (int t = threadIdx.x; t < kPoolTile * D; t += kThreads) {
      vb[(t / D) * L.ldvb + t % D] = __float2bfloat16(vt[(t / D) * L.ldv + t % D]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kPoolTile * I; t += kThreads) {
      const int r = t / I, i = t % I;
      const float ev = expf(fmaxf(s[r * L.lds + i] - m[i], -80.0f));
      s[r * L.lds + i] = ev;
      e[r * L.lde + i] = __float2bfloat16(ev);
    }
    __syncthreads();
    for (int i = threadIdx.x / 4; i < I; i += kThreads / 4) {
      float sum = 0.0f;
      for (int r = threadIdx.x % 4; r < kPoolTile; r += 4) sum += s[r * L.lds + i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (threadIdx.x % 4 == 0) l[i] = l[i] * corr[i] + sum;
    }
    // e^T is e [kPoolTile, I] read as a column-major [I, kPoolTile] operand
    gemm_to_smem<wmma::col_major, wmma::row_major>(e, L.lde, vb, L.ldvb, tmp, L.ldv, I, D,
                                                   kPoolTile);
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

}  // namespace

extern "C" int pool_ext_wmma_launch(const void* x, const void* se, const void* be, const void* qf,
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
