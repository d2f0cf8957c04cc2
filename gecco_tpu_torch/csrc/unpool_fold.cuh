// The Hopper unpool's per-batch fold (csrc/unpool.cu, launches 1-2),
// shared with the Hopper body of the unpool + MLP megakernel
// (csrc/unpool_mlp.cu): with y = x * se + be, per batch element b and head h
// (I == 64 inducers a head, D = C / H a multiple of 16),
//   kft[hI+i, :] = bf16(s * k_h[i] @ bf16(wq_h * se))       [B, J, C]
//   brow[hI+i]   = s * (be @ wq_h^T) . k_h[i]                [B, J] fp32
//   vft[:, hI+i] = bf16(v_h[i] @ wo_h^T)                      [B, C, J]
// vf written transposed, so that both operands of the tile kernels'
// products are K-major.
#pragma once

#include "unpool.cuh"

namespace gecco {
namespace fold {

constexpr int kInd = 64;  // inducers per head (I)

__global__ void __launch_bounds__(kThreads)
unpool_bq_kernel(const float* __restrict__ be, const bf16* __restrict__ wq, float* __restrict__ bq,
                 int C) {
  const int o = blockIdx.x * kWarps + threadIdx.x / 32;
  if (o >= C) return;
  unpool_bq_warp(be, wq, bq, C, blockIdx.y, o);
}

// kft and brow for 64 channels of head h of batch element b (I == 64; D a
// multiple of 16). Without the pre-norm (se and bq null) wq is folded as it
// is and brow is 0.
__global__ void __launch_bounds__(kThreads)
unpool_fold_k_kernel(const float* __restrict__ se, const float* __restrict__ bq,
                     const bf16* __restrict__ k, const bf16* __restrict__ wq,
                     bf16* __restrict__ kft, float* __restrict__ brow, int C, int H, float scale) {
  constexpr int ldw = 64 + kPad;
  __shared__ __align__(128) bf16 wqs[64 * ldw];  // [D <= 64, 64] bf16(wq_h * se)
  __shared__ __align__(128) float tile[64 * 64];
  const int c0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int D = C / H, J = H * kInd;
  for (int t = threadIdx.x; t < D * 64; t += kThreads) {
    const int d = t / 64, c = t % 64;
    const float sc = se ? se[(size_t)b * C + c0 + c] : 1.0f;
    wqs[d * ldw + c] =
        __float2bfloat16(__bfloat162float(wq[(size_t)(h * D + d) * C + c0 + c]) * sc);
  }
  __syncthreads();
  const bf16* kb = k + (size_t)b * kInd * C + h * D;  // [I, D], row stride C
  gemm_to_smem<wmma::row_major, wmma::row_major>(kb, C, wqs, ldw, tile, 64, 64, 64, D);
  __syncthreads();
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    kft[((size_t)b * J + h * kInd + t / 64) * C + c0 + t % 64] = __float2bfloat16(scale * tile[t]);
  }
  if (blockIdx.x == 0 && threadIdx.x < kInd) {
    const int i = threadIdx.x;
    float acc = 0.0f;
    for (int d = 0; bq != nullptr && d < D; ++d) {
      acc += bq[(size_t)b * C + h * D + d] * __bfloat162float(kb[(size_t)i * C + d]);
    }
    brow[(size_t)b * J + h * kInd + i] = scale * acc;
  }
}

// vf^T [B, C, J] for 64 channels of head h of batch element b: vf_h =
// v_h @ wo_h^T with wo[c0 + c, hD + d] read in place as a column-major
// operand; neighbouring threads write neighbouring j.
__global__ void __launch_bounds__(kThreads)
unpool_fold_v_kernel(const bf16* __restrict__ v, const bf16* __restrict__ wo,
                     bf16* __restrict__ vft, int C, int H) {
  constexpr int ldt = 64 + kPadF;
  __shared__ __align__(128) float tile[64 * ldt];
  const int c0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int D = C / H, J = H * kInd;
  gemm_to_smem<wmma::row_major, wmma::col_major>(v + (size_t)b * kInd * C + h * D, C,
                                                 wo + (size_t)c0 * C + h * D, C, tile, ldt, 64,
                                                 64, D);
  __syncthreads();
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    const int c = t / 64, i = t % 64;
    vft[((size_t)b * C + c0 + c) * J + h * kInd + i] = __float2bfloat16(tile[i * ldt + c]);
  }
}


// The fold's launches: bq = be @ wq^T (only with the pre-norm), then kft
// and brow, then vft. Without the pre-norm (se and bq unused) wq is folded
// as it is and brow is 0.
inline cudaError_t launch_unpool_fold(const float* se, const float* be, const bf16* k,
                                      const bf16* v, const bf16* wq, const bf16* wo, float* bq,
                                      bf16* kft, bf16* vft, float* brow, int B, int C, int H,
                                      bool prenorm, float scale, cudaStream_t st) {
  if (prenorm) {
    unpool_bq_kernel<<<dim3((C + kWarps - 1) / kWarps, B), kThreads, 0, st>>>(be, wq, bq, C);
  }
  unpool_fold_k_kernel<<<dim3(C / 64, H, B), kThreads, 0, st>>>(
      prenorm ? se : nullptr, prenorm ? bq : nullptr, k, wq, kft, brow, C, H, scale);
  unpool_fold_v_kernel<<<dim3(C / 64, H, B), kThreads, 0, st>>>(v, wo, vft, C, H);
  return cudaGetLastError();
}

}  // namespace fold
}  // namespace gecco
