// Fused pre-norm + Gaussian MLP + residual, with the output channel sums:
// the Hopper body (TMA and wgmma), the sampler's.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_mlp_kernel (served by
// fused_mlp_residual), with its algebra and roundings:
//   y = bf16(x * se + be);  h = y @ w1t + b1;  g = bf16(exp(-h^2 / 2))
//   o = x + (g @ w2t + b2);  out = bf16(o);  sums[b] = [sum o | sum o^2]
// (alpha and the normalized-activation affine are folded into w1t/b1 and
// w2t/b2 by the caller).
//
// Bound on the H100: tensor-core operations (4 N C W per batch element
// against 4 N C bytes of stream in and out: W = 768 FLOP per byte at the
// flagship, above the bf16 ridge of about 295). Design (mlp_hopper.cuh):
// the first walk of the Hopper backward (csrc/mlp_bwd.cu) and the
// residual epilogue, four launches:
// 0. prenorm_kernel (backward.cuh): y = bf16(x * se + be) [B N, C] once;
// 1. mlp_act_kernel: g = bf16(exp(-(y @ w1t + b1)^2 / 2)) [B N, W], blocks
//    of 128 rows x 192 columns, w1t read MN-major as TMA leaves it;
// 2. mlp_out_kernel: o = (g @ w2t + b2) + x, out = bf16(o) and each
//    128-row block's column sums of o and o^2;
// 3. mlp_colsum_kernel: sums[b] = batch element b's row blocks added in
//    order (no atomics: the same bits from call to call).
// g makes one round trip through device memory in bf16 (0.4 GB at the
// sampler's B 64), where the WMMA body streamed both weights through
// shared memory once per 64 points (2.4 GB of L2 reads a call). Where C or
// W is not a multiple of 384 (C and W multiples of 128, e.g. C 256) the two
// passes run their 128-column instances (mlp_hopper.cuh kBnNarrow); the
// upsample demo's C 128 takes csrc/mlp_narrow.cu instead.
#include "mlp_hopper.cuh"

using namespace gecco;
using namespace gecco::mlp;

namespace {

MLP_GEMM_KERNEL(mlp_act_kernel, kBnWide, 1, kAct, kStagesWide)
MLP_GEMM_KERNEL(mlp_out_kernel, kBnWide, 1, kOut, kStagesWide)
MLP_GEMM_KERNEL_MB(mlp_act128_kernel, kBnNarrow, 1, kAct, kStagesNarrow, kBlocksNarrow)
MLP_GEMM_KERNEL_MB(mlp_out128_kernel, kBnNarrow, 1, kOut, kStagesNarrow, kBlocksNarrow)

}  // namespace

// y [B N, C] and g [B N, W] bf16 and part [B N / 128, 2, C] fp32 are the
// wrapper's scratch; the sums count each element's first n_valid points.
extern "C" int mlp_launch(const void* x, const void* se, const void* be, const void* w1t,
                          const void* b1, const void* w2t, const void* b2, void* y, void* g,
                          void* part, void* out, void* sums, int B, int N, int C, int W,
                          int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!hopper_takes(N, C, W)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * N;
  cudaError_t err =
      launch_prenorm((const bf16*)x, (const float*)se, (const float*)be, (bf16*)y, B, N, C, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_y, tm_w1, tm_g, tm_w2;
  if (!tmap(&tm_y, y, M, C, 64) || !tmap(&tm_w1, w1t, C, W, 64) || !tmap(&tm_g, g, M, W, 64) ||
      !tmap(&tm_w2, w2t, W, C, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  MlpEpi e1{};
  e1.K = C;
  e1.N = W;
  e1.rows_b = N;
  e1.bias = (const float*)b1;
  e1.out = (bf16*)g;
  const bool wide = wide_tiles(C, W);
  err = wide ? launch_gemm<kBnWide, kAct, kStagesWide>(mlp_act_kernel, tm_y, tm_w1, tm_y, tm_w1,
                                                       e1, M, st)
             : launch_gemm<kBnNarrow, kAct, kStagesNarrow>(mlp_act128_kernel, tm_y, tm_w1, tm_y,
                                                           tm_w1, e1, M, st);
  if (err != cudaSuccess) return (int)err;
  MlpEpi e2{};
  e2.K = W;
  e2.N = C;
  e2.rows_b = N;
  e2.n_valid = n_valid;
  e2.bias = (const float*)b2;
  e2.x = (const bf16*)x;
  e2.out = (bf16*)out;
  e2.part = (float*)part;
  err = wide ? launch_gemm<kBnWide, kOut, kStagesWide>(mlp_out_kernel, tm_g, tm_w2, tm_g, tm_w2,
                                                       e2, M, st)
             : launch_gemm<kBnNarrow, kOut, kStagesNarrow>(mlp_out128_kernel, tm_g, tm_w2, tm_g,
                                                           tm_w2, e2, M, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_colsum((const float*)part, (float*)sums, B, N / kRows, 2, C, st);
}
