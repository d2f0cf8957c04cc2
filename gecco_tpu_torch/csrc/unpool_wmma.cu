// Folded unpool attention + residual, with the output channel sums: the
// WMMA body, for the shapes the Hopper design (csrc/unpool.cu: I == 64, H
// even, D <= 64, C in (192, 384, 768)) does not take, e.g. C 128 or three
// heads (the wrapper's _unpool_body chooses by shape).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_kernel (served
// by folded_unpool), with its two flags: ``prenorm`` (with it off, y = x:
// no se fold into wq and no bias row) and ``residual`` (with it off, no x
// add). With y = x * se + be, per batch element b and head h:
//   kft[hI+i, :] = bf16(s * k_h[i] @ bf16(wq_h * se))       [J, C]
//   brow[hI+i]   = s * (be @ wq_h^T) . k_h[i]                [J] fp32
//   vf[hI+i, :]  = bf16(v_h[i] @ wo_h^T)                      [J, C]
// then per point: logits = x @ kft^T + brow; a softmax over each head's
// I-wide block with THAT block's own max (exp argument clamped at -80);
// attn = bf16(p) @ vf; o = x + attn; out = bf16(o); sums[b] += [o | o^2].
//
// Bound on the H100: tensor-core operations (4*N*C*J per batch element
// against 4*N*C bytes of stream: J = 512 FLOP per byte at the flagship).
// Design: the per-batch fold, which the TPU kept in scratch across its
// sequential point-tile axis, is two prologue kernels writing kft/vf
// [B, J, C] bf16 and brow [B, J] fp32 (CUDA-core FMAs: its D-long dot
// products are ~1% of the work; be @ wq^T is formed once per batch element). The main kernel takes one 64-point tile (32 at C = 768)
// per block and walks the heads: each head's kft_h and vf_h are staged in
// shared memory (asynchronously, each behind the other product where both
// buffers fit), its [TN, I] logits and softmax live there too, and
// its p @ vf_h adds into a [TN, C] fp32 accumulator held in registers. Per-head processing gives every head
// block its own max by construction. Sums as in mlp.cu (fp32 atomics).
// The device code is in unpool.cuh, shared with csrc/unpool_mlp.cu.
#include <cmath>

#include "unpool.cuh"

using namespace gecco;

namespace {

__global__ void __launch_bounds__(kThreads)
unpool_bq_kernel(const float* __restrict__ be, const bf16* __restrict__ wq, float* __restrict__ bq,
                 int C) {
  const int o = blockIdx.x * kWarps + threadIdx.x / 32;
  if (o >= C) return;
  unpool_bq_warp(be, wq, bq, C, blockIdx.y, o);
}

__global__ void __launch_bounds__(kThreads)
unpool_fold_kernel(const float* __restrict__ se, const float* __restrict__ bq,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ wq, const bf16* __restrict__ wo_t,
                   bf16* __restrict__ kft, bf16* __restrict__ vf, float* __restrict__ brow,
                   int C, int H, int I, float scale) {
  const int J = H * I;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= J * C + J) return;
  unpool_fold_elem(se, bq, k, v, wq, wo_t, kft, vf, brow, C, H, I, scale, blockIdx.y, idx);
}

// One point tile per block (shared memory: unpool_smem_plan).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
unpool_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kft,
              const float* __restrict__ brow, const bf16* __restrict__ vf, bf16* __restrict__ out,
              float* __restrict__ sums, int N, int C, int H, int I, int dbl, int region0,
              int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  unpool_tile<ROWS>(x, kft, brow, vf, out, sums, N, C, H, I, dbl, region0, blockIdx.y,
                    blockIdx.x, residual != 0, smem);
}

}  // namespace

extern "C" int unpool_wmma_launch(const void* x, const void* se, const void* be, const void* k,
                                  const void* v, const void* wq, const void* wo_t, void* bq,
                                  void* kft, void* vf, void* brow, void* out, void* sums, int B,
                                  int N, int C, int H, int I, int TN, int residual, int prenorm,
                                  void* stream) {
  const int J = H * I;
  // 1/sqrt(D) rounded once from double, as the JAX package's Python float
  const float scale = (float)(1.0 / sqrt((double)(C / H)));
  cudaStream_t st = (cudaStream_t)stream;
  if (prenorm) {
    unpool_bq_kernel<<<dim3((C + kWarps - 1) / kWarps, B), kThreads, 0, st>>>(
        (const float*)be, (const bf16*)wq, (float*)bq, C);
  }
  unpool_fold_kernel<<<dim3((J * C + J + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
      prenorm ? (const float*)se : nullptr, prenorm ? (const float*)bq : nullptr,
      (const bf16*)k, (const bf16*)v, (const bf16*)wq,
      (const bf16*)wo_t, (bf16*)kft, (bf16*)vf, (float*)brow, C, H, I, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dbl = 0;
  size_t region0 = 0;
  const size_t smem = unpool_smem_plan(TN, C, I, &dbl, &region0);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const auto kernel = TN == 64 ? unpool_kernel<4> : unpool_kernel<2>;
  err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N / TN, B), kThreads, smem, st>>>(
      (const bf16*)x, (const bf16*)kft, (const float*)brow, (const bf16*)vf, (bf16*)out,
      (float*)sums, N, C, H, I, dbl, (int)region0, residual);
  return (int)cudaGetLastError();
}
