// Fused h-side of a broadcasting layer, on the [I, C] inducer tokens: the
// WMMA body, for the shapes the Hopper body (csrc/hside.cu) does not take.
//
// Replaces gecco_tpu/ops/pallas/hside.py:_hside_kernel (served by
// fused_h_side). Per batch element, with set-level GroupNorm statistics in
// fp32 over the I tokens:
//   y1 = bf16(GN(h0) * s1 + b1n);  a = y1 @ w1t + b1;  g = bf16(exp(-a^2/2))
//   hh = g @ w2t + b2;  h = bf16(GN(hh) * s2 + b2n)
//   k = bf16(h @ wk^T);  v = bf16(h @ wv^T)
// (alpha and the normalized-activation affine pre-folded into w1t/b1 and
// w2t/b2 by the caller).
//
// Bound on the H100: tensor-core operations, nominally (4*I*C*W + 4*I*C*C
// FLOP per batch element: ~7 GFLOP at batch 64, ~7 us, against ~14 MB of
// tokens and weights, ~4 us). What bounds it in practice is its
// parallelism: one
// block per batch element (64 blocks for 132 SMs), each re-reading the
// weights from L2. Design: everything stays in one block's shared memory;
// the [I, W] hidden plane is walked in 64-wide chunks whose activation feeds
// the second product at once, accumulated in registers (in column chunks of
// the output where I x C exceeds one pass of the register tiles). One
// instance per inducer count I = 16 ROWS, ROWS 1 to 4 (I 16 to 64; the
// JAX kernel takes any I, the flagship's is 64).
#include "common.cuh"

using namespace gecco;

namespace {

constexpr int kChunk = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Per-channel (mean, inv) [C] of the set-level group norm of z [rows, C].
template <class T>
__device__ void group_stats(const T* z, int rows, int C, int G, float* mean_c, float* inv_c) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float v = to_f(z[(size_t)r * C + c]);
      s1 += v;
      s2 += v * v;
    }
    mean_c[c] = s1;
    inv_c[c] = s2;
  }
  __syncthreads();
  const int pg = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float g1 = 0.0f, g2 = 0.0f;
    for (int c = g * pg; c < (g + 1) * pg; ++c) {
      g1 += mean_c[c];
      g2 += inv_c[c];
    }
    const float count = (float)(rows * pg);
    const float mean = g1 / count;
    const float inv = rsqrtf(fmaxf(g2 / count - mean * mean, 0.0f) + 1e-5f);
    for (int c = g * pg; c < (g + 1) * pg; ++c) {
      mean_c[c] = mean;
      inv_c[c] = inv;
    }
  }
  __syncthreads();
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
hside_kernel(const bf16* __restrict__ h0, const float* __restrict__ s1n,
             const float* __restrict__ b1n, const float* __restrict__ s2n,
             const float* __restrict__ b2n, const bf16* __restrict__ w1t,
             const float* __restrict__ b1, const bf16* __restrict__ w2t,
             const float* __restrict__ b2, const bf16* __restrict__ wk,
             const bf16* __restrict__ wv, bf16* __restrict__ hout, bf16* __restrict__ kout,
             bf16* __restrict__ vout, int C, int W, int G, int CC) {
  constexpr int I = 16 * ROWS, COLS = kMaxFrags / ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y = reinterpret_cast<bf16*>(smem);                 // [I, C] y1, later h
  float* hh = reinterpret_cast<float*>(y + I * C);         // [I, C]
  float* hbuf = hh + I * C;                                // [I, kChunk]
  float* mean_c = hbuf + I * kChunk;                       // [C]
  float* inv_c = mean_c + C;                               // [C]
  bf16* g = reinterpret_cast<bf16*>(inv_c + C);            // [I, kChunk]

  const int b = blockIdx.x;
  const size_t base = (size_t)b * I * C;
  const float* sc1 = s1n + (size_t)b * C;
  const float* bi1 = b1n + (size_t)b * C;
  const float* sc2 = s2n + (size_t)b * C;
  const float* bi2 = b2n + (size_t)b * C;

  group_stats(h0 + base, I, C, G, mean_c, inv_c);
  for (int e = threadIdx.x; e < I * C; e += kThreads) {
    const int c = e % C;
    y[e] = __float2bfloat16((__bfloat162float(h0[base + e]) - mean_c[c]) * (inv_c[c] * sc1[c]) +
                            bi1[c]);
  }
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += CC) {
    FragC acc[ROWS][COLS];
    acc_zero(acc);
    for (int w0 = 0; w0 < W; w0 += kChunk) {
      gemm_to_smem<wmma::row_major, wmma::row_major>(y, C, w1t + w0, W, hbuf, kChunk, I, kChunk, C);
      __syncthreads();
      for (int e = threadIdx.x; e < I * kChunk; e += kThreads) {
        const float a = hbuf[e] + b1[w0 + e % kChunk];
        g[e] = __float2bfloat16(expf(-0.5f * a * a));
      }
      __syncthreads();
      gemm_acc<ROWS, COLS, wmma::row_major>(acc, g, kChunk, w2t + (size_t)w0 * C + c0, C, CC,
                                            kChunk);
    }
    acc_store(acc, hh + c0, C, CC);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < I * C; e += kThreads) hh[e] += b2[e % C];
  __syncthreads();

  group_stats(hh, I, C, G, mean_c, inv_c);
  for (int e = threadIdx.x; e < I * C; e += kThreads) {
    const int c = e % C;
    const bf16 hv = __float2bfloat16((hh[e] - mean_c[c]) * (inv_c[c] * sc2[c]) + bi2[c]);
    y[e] = hv;
    hout[base + e] = hv;
  }
  __syncthreads();

  // k and v: [I, C] = h @ w^T, w read as a column-major [C, C] operand
  const bf16* ws[2] = {wk, wv};
  bf16* outs[2] = {kout, vout};
  for (int q = 0; q < 2; ++q) {
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, C, ws[q], C, hh, C, I, C, C);
    __syncthreads();
    for (int e = threadIdx.x; e < I * C; e += kThreads) outs[q][base + e] = __float2bfloat16(hh[e]);
    __syncthreads();
  }
}

}  // namespace

extern "C" int hside_wmma_launch(const void* h0, const void* s1n, const void* b1n, const void* s2n,
                            const void* b2n, const void* w1t, const void* b1, const void* w2t,
                            const void* b2, const void* wk, const void* wv, void* h, void* k,
                            void* v, int B, int I, int C, int W, int G, int CC, void* stream) {
  // mirrored by _hside_wmma_smem in the wrapper: change both together
  const size_t smem = (size_t)I * C * 2 + ((size_t)I * C + I * kChunk + 2 * C) * 4 +
                      (size_t)I * kChunk * 2;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  decltype(&hside_kernel<4>) kernel;
  switch (I) {
    case 16: kernel = hside_kernel<1>; break;
    case 32: kernel = hside_kernel<2>; break;
    case 48: kernel = hside_kernel<3>; break;
    case 64: kernel = hside_kernel<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)h0, (const float*)s1n, (const float*)b1n, (const float*)s2n,
      (const float*)b2n, (const bf16*)w1t, (const float*)b1, (const bf16*)w2t, (const float*)b2,
      (const bf16*)wk, (const bf16*)wv, (bf16*)h, (bf16*)k, (bf16*)v, C, W, G, CC);
  return (int)cudaGetLastError();
}
