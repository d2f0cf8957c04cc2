// The weight-gradient product of the Hopper backwards (csrc/pool_ext_bwd.cu's
// dqf, csrc/unpool_bwd.cu's dkf and dvf): out[b] = A_b^T B_b [M, P] fp32
// over the rows_b rows of batch element b, A [nb * rows_b, M] and
// B [nb * rows_b, P] bf16 row-major (nb = 1 and rows_b = all rows sums
// over the batch).
//
// One block per (128 columns of P, 128 rows of M, batch element, split of
// its 64-row tiles): both operands by TMA through a four-stage ring in the
// 128-byte swizzle, read MN-major by wgmma as TMA leaves them (hopper.cuh
// desc_mn); warpgroup w keeps rows 64 w .. 64 w + 64 of the tile, a [64, 128]
// fp32 accumulator. With one split a block writes its tile of out; with
// more, each split writes its partial and wgrad_sum_kernel adds them in
// split order, so out is the same bits from run to run. Element (b, m, p)
// of out lies at b sb + (m / 64) smh + (m % 64) sm + (p / 64) sph + p % 64
// (WgradLayout): row-major [nb, M, P], or a layout that puts a head's 64
// rows or columns where the caller's chain reads them.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gecco {

constexpr int kWgradRing = 4;
constexpr int kWgradPanel = 64 * 128;  // 64 rows of 64 bf16 columns

// where element (b, m, p) of a weight gradient goes (see above)
struct WgradLayout {
  long long sb, smh, sm, sph;
  __host__ __device__ long long at(long long b, int m, int p) const {
    return b * sb + (m / 64) * smh + (m % 64) * sm + (p / 64) * sph + p % 64;
  }
};

__host__ __device__ inline WgradLayout row_major(int M, int P) {
  return WgradLayout{(long long)M * P, 64LL * P, P, 64};
}

__global__ void __launch_bounds__(256, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
             float* __restrict__ out, WgradLayout lay, int M, int P, int rows_b, int splits) {
  using namespace hopper;
  constexpr int kStage = 4 * kWgradPanel;  // A panels [64, 128] then B panels [64, 128]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgradRing * kStage);
  const int p0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int tiles = rows_b / 64;
  const int k0 = (int)((long long)sp * tiles / splits);
  const int count = (int)((long long)(sp + 1) * tiles / splits) - k0;
  auto stage = [&](int s) { return smem + s * kStage; };
  auto load = [&](int u) {
    const int s = u % kWgradRing, row = b * rows_b + (k0 + u) * 64;
    bar_expect(full + s, kStage);
    tma_load(stage(s), &tm_a, full + s, row, m0);
    tma_load(stage(s) + kWgradPanel, &tm_a, full + s, row, m0 + 64);
    tma_load(stage(s) + 2 * kWgradPanel, &tm_b, full + s, row, p0);
    tma_load(stage(s) + 3 * kWgradPanel, &tm_b, full + s, row, p0 + 64);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgradRing; ++s) bar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 0; u < kWgradRing && u < count; ++u) load(u);
  }
  const int w = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4), r = wi * 16 + lane / 4;
  float acc[64];
  zero(acc);
  for (int u = 0; u < count; ++u) {
    const int s = u % kWgradRing;
    unsigned char* st = stage(s);
    bar_wait(full + s, (u / kWgradRing) & 1);
    // acc[64 rows of M (panel w), 128 columns of P] += A^T B, both MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tt<1, 1>(acc, desc_mn(st + w * kWgradPanel + kk * 2048, kWgradPanel),
                     desc_mn(st + 2 * kWgradPanel + kk * 2048, kWgradPanel), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // both warpgroups are done with the stage
    if (threadIdx.x == 0 && u + kWgradRing < count) load(u + kWgradRing);
  }
  // a split's partial row-major at slice blockIdx.z; one split's tile where
  // ``lay`` puts it
  const WgradLayout L = splits > 1 ? row_major(M, P) : lay;
  const int m = m0 + w * 64 + r;
  // a 64-column tail (P % 128 == 64): the last block's second panel lies
  // past P (TMA filled it with zeros) and is not written
  const bool whole = p0 + 128 <= P;
#pragma unroll
  for (int g = 0; g < 16; ++g) {
    const int p = p0 + 8 * g + col;
    if (g < 8 || whole) {
      *reinterpret_cast<float2*>(out + L.at(blockIdx.z, m, p)) =
          make_float2(acc[4 * g], acc[4 * g + 1]);
      *reinterpret_cast<float2*>(out + L.at(blockIdx.z, m + 8, p)) =
          make_float2(acc[4 * g + 2], acc[4 * g + 3]);
    }
  }
}

// out[b] = the splits' partials of batch element b summed in split order
__global__ void __launch_bounds__(kThreads)
wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ out, WgradLayout lay,
                 int splits, int P, int total, long long n) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const long long b = idx / total, e = idx % total;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += part[(b * splits + sp) * total + e];
  out[lay.at(b, (int)(e / P), (int)(e % P))] = s;
}

// out = A_b^T B_b per batch element, laid out by ``lay``; ``part`` holds
// nb * splits partials [M, P] where splits > 1 (unread otherwise). M a
// multiple of 128, P of 64 (a 64-column tail takes a block of its own),
// rows_b of 64, 1 <= splits <= rows_b / 64.
inline cudaError_t launch_wgrad(const void* a, const void* bm, float* part, float* out,
                                WgradLayout lay, int nb, int rows_b, int M, int P, int splits,
                                cudaStream_t st) {
  if (M % 128 || P % 64 || rows_b % 64 || splits < 1 || splits > rows_b / 64) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_a, tm_b;
  if (hopper::encode_tiled(&tm_a, a, (uint64_t)nb * rows_b, M, 64) != CUDA_SUCCESS ||
      hopper::encode_tiled(&tm_b, bm, (uint64_t)nb * rows_b, P, 64) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kWgradRing * 4 * kWgradPanel + kWgradRing * 8 + 1024;
  cudaError_t err = set_smem((const void*)wgrad_kernel, smem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<<<dim3((P + 127) / 128, M / 128, nb * splits), 256, smem, st>>>(
      tm_a, tm_b, splits > 1 ? part : out, lay, M, P, rows_b, splits);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const long long n = (long long)nb * M * P;
  wgrad_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, out, lay, splits, P, M * P, n);
  return cudaGetLastError();
}

}  // namespace gecco
