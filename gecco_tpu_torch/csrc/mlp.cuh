// Device code of the fused MLP (csrc/mlp.cu), shared with the unpool + MLP
// megakernel (csrc/unpool_mlp.cu): one point tile of pre-norm + Gaussian
// MLP + residual + output channel sums. The algebra and the design are
// described in mlp.cu.
#pragma once

#include "common.cuh"

namespace gecco {

// The block's bytes for the widest W chunk (64, else 32) whose double
// staging fits (see mlp_tile), or 0 where none does.
inline size_t mlp_smem_plan(int TN, int C, int W, int* chunk_out, size_t* region0_out) {
  for (int chunk = 64; chunk >= 32; chunk /= 2) {
    const size_t ldy = C + kPad;
    size_t region0 = ((size_t)TN * ldy + (size_t)C * (chunk + kPad) + (size_t)chunk * ldy) * 2;
    const size_t out_tile = (size_t)TN * (C + kPadF) * 4;
    if (out_tile > region0) region0 = out_tile;
    region0 = (region0 + 127) / 128 * 128;
    const size_t smem =
        region0 + (size_t)TN * (chunk + kPadF) * 4 + (size_t)TN * (chunk + kPad) * 2;
    if (smem <= kMaxSmem) {
      if (W % chunk != 0) return 0;
      *chunk_out = chunk;
      *region0_out = region0;
      return smem;
    }
  }
  return 0;
}

// Shared memory: y [TN, C], the w1 chunk [C, chunk] and the w2 chunk
// [chunk, C] (each staged asynchronously, one behind the other product),
// which the fp32 output tile [TN, C] reuses after the last product
// (region0 bytes); then the chunk's pre-activation h and activation g.
template <int ROWS>
__device__ __forceinline__ void mlp_tile(const bf16* __restrict__ x, const float* __restrict__ se,
                                         const float* __restrict__ be,
                                         const bf16* __restrict__ w1t, const float* __restrict__ b1,
                                         const bf16* __restrict__ w2t, const float* __restrict__ b2,
                                         bf16* __restrict__ out, float* __restrict__ sums, int N,
                                         int C, int W, int chunk, int region0, int b, int tile,
                                         unsigned char* smem) {
  constexpr int TN = 16 * ROWS, COLS = kMaxFrags / ROWS;
  const int ldy = C + kPad, ldw1 = chunk + kPad, ldw2 = C + kPad;
  const int ldh = chunk + kPadF, ldg = chunk + kPad, ldo = C + kPadF;
  bf16* y = reinterpret_cast<bf16*>(smem);                  // [TN, C]
  bf16* w1s = y + TN * ldy;                                 // [C, chunk]
  bf16* w2s = w1s + C * ldw1;                               // [chunk, C]
  float* obuf = reinterpret_cast<float*>(smem);             // [TN, C], after the products
  float* hbuf = reinterpret_cast<float*>(smem + region0);   // [TN, chunk]
  bf16* g = reinterpret_cast<bf16*>(hbuf + TN * ldh);       // [TN, chunk]

  const size_t base = ((size_t)b * N + (size_t)tile * TN) * C;
  stage_async(w1s, ldw1, w1t, W, C, chunk);
  load_prenorm(y, ldy, x + base, se + (size_t)b * C, be + (size_t)b * C, TN, C);

  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int w0 = 0; w0 < W; w0 += chunk) {
    const bool more = w0 + chunk < W;
    cp_async_wait<0>();
    __syncthreads();  // w1 chunk and y in place; the last product is done with w2s and g
    stage_async(w2s, ldw2, w2t + (size_t)w0 * C, C, chunk, C);
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, w1s, ldw1, hbuf, ldh, TN, chunk, C);
    __syncthreads();  // w1s free, h in place
    if (more) stage_async(w1s, ldw1, w1t + w0 + chunk, W, C, chunk);
    for (int e = threadIdx.x; e < TN * chunk; e += kThreads) {
      const int r = e / chunk, q = e % chunk;
      const float h = hbuf[r * ldh + q] + b1[w0 + q];
      g[r * ldg + q] = __float2bfloat16(expf(-0.5f * h * h));
    }
    if (more) {
      cp_async_wait<1>();  // the w2 chunk; the next w1 chunk may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, g, ldg, w2s, ldw2, C, chunk);
  }
  __syncthreads();  // obuf reuses y, w1s and w2s
  acc_store(acc, obuf, ldo, C);
  __syncthreads();
  residual_epilogue(x + base, obuf, ldo, b2, out + base, sums + (size_t)b * 2 * C, TN, C);
}

}  // namespace gecco
