// Fused pre-norm + Gaussian MLP + residual, with the output channel sums:
// the WMMA body, for the shapes the Hopper body (csrc/mlp.cu) does not take
// (the upsample demo's C 128).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_mlp_kernel (served by
// fused_mlp_residual):
//   y = bf16(x * se + be);  h = y @ w1t + b1;  g = bf16(exp(-h^2 / 2))
//   o = x + (g @ w2t + b2);  out = bf16(o);  sums[b] += [sum o | sum o^2]
// (alpha and the normalized-activation affine are folded into w1t/b1 and
// w2t/b2 by the caller).
//
// Bound on the H100: tensor-core operations (4*N*C*W per batch element
// against 4*N*C bytes of stream in and out: W = 768 FLOP per byte at the
// flagship, above the bf16 ridge of about 295). Design: one block per
// 64-point tile (32 at C = 768) of one batch element; the normed tile
// stays in shared memory and the [TN, W] hidden plane never leaves the SM:
// W is walked in 64-wide chunks (32 at C = 768), both weight chunks staged
// in shared memory behind the other product, each chunk's activation feeds
// the second product at once, whose
// [TN, C] fp32 output stays in registers across chunks. The TPU kernel's
// sequential point-tile
// axis carried the sums; here blocks run unordered and add them with one
// fp32 atomic per channel (the wrapper zeroes the buffer). The device code
// is in mlp.cuh, shared with csrc/unpool_mlp.cu.
#include "mlp.cuh"

using namespace gecco;

namespace {

// One point tile per block (shared memory: mlp_smem_plan).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ se, const float* __restrict__ be,
           const bf16* __restrict__ w1t, const float* __restrict__ b1,
           const bf16* __restrict__ w2t, const float* __restrict__ b2, bf16* __restrict__ out,
           float* __restrict__ sums, int N, int n_valid, int C, int W, int chunk, int region0) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_tile<ROWS>(x, se, be, w1t, b1, w2t, b2, out, sums, N, n_valid, C, W, chunk, region0,
                 blockIdx.y, blockIdx.x, smem);
}

}  // namespace

extern "C" int mlp_wmma_launch(const void* x, const void* se, const void* be, const void* w1t,
                               const void* b1, const void* w2t, const void* b2, void* out,
                               void* sums, int B, int N, int C, int W, int TN, int n_valid,
                               void* stream) {
  int chunk = 0;
  size_t region0 = 0;
  const size_t smem = mlp_smem_plan(TN, C, W, &chunk, &region0);
  if (smem == 0 || N % TN || n_valid < 1 || n_valid > N) return (int)cudaErrorInvalidValue;
  const auto kernel = TN == 64 ? mlp_kernel<4> : mlp_kernel<2>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N / TN, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)w1t, (const float*)b1,
      (const bf16*)w2t, (const float*)b2, (bf16*)out, (float*)sums, N, n_valid, C, W, chunk,
      (int)region0);
  return (int)cudaGetLastError();
}
