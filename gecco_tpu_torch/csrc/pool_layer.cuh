// The resident pool's pre-norm (folded_pool_layer), shared by its Hopper
// body (csrc/pool.cu) and its WMMA body (csrc/pool_wmma.cu): the set-level
// GroupNorm statistics of the stream x [B, N, C] and y = bf16((x - mean_c)
// * (inv_c * scale) + bias), written once to device memory.
//   s1, s2 = channel sums of x over the points; per group g of C/G
//   contiguous channels (count = n_valid * C/G): mean_g = g1 / count,
//   var_g = g2 / count - mean_g^2, inv_g = 1 / sqrt(max(var_g, 0) + 1e-5)
// A ragged N comes zero-padded to a multiple of 128: the padding adds zero
// to the sums, and the count is n_valid's.
#pragma once

#include "pool.cuh"

namespace gecco {

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

// The three launches of the pre-norm, one block per 64-point tile
// (kPoolTile) in the sums and the norm: part [B, N / 64, 2, C] fp32 is
// scratch; mean, inv [B, C] and y [B, N, C] are written. N % 64 == 0 and
// C / 8 <= kThreads (the callers check).
inline cudaError_t pool_layer_prenorm(const bf16* x, const float* scale, const float* bias,
                                      float* part, float* mean, float* inv, bf16* y, int B,
                                      int N, int C, int G, int n_valid, cudaStream_t st) {
  cudaError_t err;
  pool_layer_sums_kernel<<<dim3(N / kPoolTile, B), kThreads, 0, st>>>(x, part, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pool_layer_stats_kernel<<<B, kThreads, 0, st>>>(part, mean, inv, N / kPoolTile, n_valid, C, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pool_layer_norm_kernel<<<dim3(N / kPoolTile, B), kThreads, 0, st>>>(x, mean, inv, scale, bias,
                                                                       y, N, C);
  return cudaGetLastError();
}

}  // namespace gecco
