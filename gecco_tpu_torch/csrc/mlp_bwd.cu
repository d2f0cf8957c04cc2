// Backward of the fused pre-norm + Gaussian MLP + residual
// (fused_mlp_residual): the Hopper body (TMA and wgmma), the train step's.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_mlp_bwd_kernel, with
// its algebra and roundings, y = bf16(x * se + be):
//   h = y @ w1t + b1;  a = exp(-h^2 / 2);  o = bf16(a) @ w2t + b2 + x
//   g' = g + gs1 + 2 o gs2                  (the sums outputs' cotangent)
//   da = bf16(g') @ w2t^T;  dh = da * a * (-h)   (fp32 a and h)
//   dy = bf16(dh) @ w1t^T;  dx = g' + dy * se;  dse = sum dy x, dbe = sum dy
//   dw1t = y^T bf16(dh);  db1 = sum dh;  dw2t = bf16(a)^T bf16(g');  db2 = sum g'
//
// Bound on the H100: tensor-core operations (six [N, C] x [C, W] products
// per batch element: W = 768 FLOP per byte of the stream in and out at the
// flagship). Design (mlp_hopper.cuh): each product one pass over the B N
// rows, the element-wise algebra in its epilogue, the [B N, W] planes
// through device memory in bf16 (the roundings above), nine launches:
// 0. prenorm_kernel (backward.cuh): y once, which three passes read;
// 1. mlp_bwd_act_kernel: bf16(a) [B N, W] (as the forward's g);
// 2. mlp_bwd_grad_kernel: o from bf16(a) @ w2t, then g' in fp32 [B N, C]
//    (read again for dx) and bf16(g'), and the row blocks' sums of g';
// 3. mlp_bwd_dh_kernel, the dual product: y @ w1t (h, recomputed, cheaper
//    than an fp32 round trip of h) and bf16(g') @ w2t^T (da) into two
//    [64, 128] accumulators a warpgroup, dh in registers, bf16(dh) out,
//    and the row blocks' sums of dh;
// 4. mlp_bwd_dx_kernel: dy = bf16(dh) @ w1t^T (w1t read K-major), dx, and
//    the row blocks' sums of dy x and dy;
// 5. mlp_colsum_kernel after passes 2, 3 and 4: db2, db1 and, per batch
//    element, dse and dbe, each the row blocks added in order;
// 6. wgrad_kernel (wgrad.cuh) twice: dw1t = y^T bf16(dh), dw2t =
//    bf16(a)^T bf16(g'), split over the rows, the partials summed in split
//    order by wgrad_sum_kernel.
// No atomics: every gradient is the same bits from call to call. Where C or
// W is not a multiple of 384 (C and W multiples of 128: the upsample demo's
// C 128, W 256) passes 1, 2 and 4 run their 128-column instances
// (mlp_hopper.cuh kBnNarrow: two ring stages, two blocks a SM); pass 3's
// dual product is 128 columns wide at every width.
#include "mlp_hopper.cuh"
#include "wgrad.cuh"

using namespace gecco;
using namespace gecco::mlp;

namespace {

MLP_GEMM_KERNEL(mlp_bwd_act_kernel, kBnWide, 1, kAct, kStagesWide)
MLP_GEMM_KERNEL(mlp_bwd_grad_kernel, kBnWide, 1, kGrad, kStagesWide)
MLP_GEMM_KERNEL(mlp_bwd_dh_kernel, kBnDual, 1, kDh, kStagesDual)
MLP_GEMM_KERNEL(mlp_bwd_dx_kernel, kBnWide, 0, kDx, kStagesWide)
MLP_GEMM_KERNEL_MB(mlp_bwd_act128_kernel, kBnNarrow, 1, kAct, kStagesNarrow, kBlocksNarrow)
MLP_GEMM_KERNEL_MB(mlp_bwd_grad128_kernel, kBnNarrow, 1, kGrad, kStagesNarrow, kBlocksNarrow)
MLP_GEMM_KERNEL_MB(mlp_bwd_dx128_kernel, kBnNarrow, 0, kDx, kStagesNarrow, kBlocksNarrow)

}  // namespace

// Scratch from the wrapper: y [B N, C], a [B N, W], gb [B N, C] and dh
// [B N, W] bf16; gp [B N, C] and part [B N / 128, max(W, 2 C)] fp32; wpart
// [splits, C, W] fp32 where splits > 1. Outputs: dx [B N, C] bf16, dsb
// [B, 2, C] (dse, dbe), dw1t [C, W], db1 [W], dw2t [W, C], db2 [C] fp32.
// Points from n_valid on are a ragged tail's zero padding (g zero there).
extern "C" int mlp_bwd_launch(const void* x, const void* se, const void* be, const void* w1t,
                              const void* b1, const void* w2t, const void* b2, const void* g,
                              const void* gsums, void* y, void* a, void* gb, void* gp, void* dh,
                              void* part, void* wpart, void* dx, void* dsb, void* dw1t, void* db1,
                              void* dw2t, void* db2, int B, int N, int C, int W, int splits,
                              int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!hopper_takes(N, C, W)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * N;
  const int blocks = (int)(M / kRows);
  const bool wide = wide_tiles(C, W);
  cudaError_t err =
      launch_prenorm((const bf16*)x, (const float*)se, (const float*)be, (bf16*)y, B, N, C, st);
  if (err != cudaSuccess) return (int)err;
  // A operands in 64 x 64 boxes; B operands MN-major in 64 x 64 boxes, or
  // K-major in boxes of the tile's columns (w2t for da, w1t for dy: the
  // dx pass's own column tile, 192 or 128)
  CUtensorMap tm_y, tm_a, tm_gb, tm_dh, tm_w1, tm_w2, tm_w2k, tm_w1k;
  if (!tmap(&tm_y, y, M, C, 64) || !tmap(&tm_a, a, M, W, 64) || !tmap(&tm_gb, gb, M, C, 64) ||
      !tmap(&tm_dh, dh, M, W, 64) || !tmap(&tm_w1, w1t, C, W, 64) ||
      !tmap(&tm_w2, w2t, W, C, 64) || !tmap(&tm_w2k, w2t, W, C, kBnDual) ||
      !tmap(&tm_w1k, w1t, C, W, wide ? kBnWide : kBnNarrow)) {
    return (int)cudaErrorInvalidValue;
  }
  // 1. bf16(a)
  MlpEpi e{};
  e.K = C;
  e.N = W;
  e.rows_b = N;
  e.bias = (const float*)b1;
  e.out = (bf16*)a;
  err = wide ? launch_gemm<kBnWide, kAct, kStagesWide>(mlp_bwd_act_kernel, tm_y, tm_w1, tm_y,
                                                       tm_w1, e, M, st)
             : launch_gemm<kBnNarrow, kAct, kStagesNarrow>(mlp_bwd_act128_kernel, tm_y, tm_w1,
                                                           tm_y, tm_w1, e, M, st);
  if (err != cudaSuccess) return (int)err;
  // 2. g', bf16(g'), db2
  e = MlpEpi{};
  e.K = W;
  e.N = C;
  e.rows_b = N;
  e.n_valid = n_valid;
  e.bias = (const float*)b2;
  e.x = (const bf16*)x;
  e.g = (const bf16*)g;
  e.gs = (const float*)gsums;
  e.gp = (float*)gp;
  e.out = (bf16*)gb;
  e.part = (float*)part;
  err = wide ? launch_gemm<kBnWide, kGrad, kStagesWide>(mlp_bwd_grad_kernel, tm_a, tm_w2, tm_a,
                                                        tm_w2, e, M, st)
             : launch_gemm<kBnNarrow, kGrad, kStagesNarrow>(mlp_bwd_grad128_kernel, tm_a, tm_w2,
                                                            tm_a, tm_w2, e, M, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_colsum((const float*)part, (float*)db2, 1, blocks, 1, C, st)) != cudaSuccess) {
    return (int)err;
  }
  // 3. h and da, bf16(dh), db1
  e = MlpEpi{};
  e.K = C;
  e.N = W;
  e.rows_b = N;
  e.bias = (const float*)b1;
  e.out = (bf16*)dh;
  e.part = (float*)part;
  err = launch_gemm<kBnDual, kDh, kStagesDual>(mlp_bwd_dh_kernel, tm_y, tm_w1, tm_gb, tm_w2k, e,
                                               M, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_colsum((const float*)part, (float*)db1, 1, blocks, 1, W, st)) != cudaSuccess) {
    return (int)err;
  }
  // 4. dy, dx, dse and dbe
  e = MlpEpi{};
  e.K = W;
  e.N = C;
  e.rows_b = N;
  e.x = (const bf16*)x;
  e.se = (const float*)se;
  e.gp = (float*)gp;
  e.out = (bf16*)dx;
  e.part = (float*)part;
  err = wide ? launch_gemm<kBnWide, kDx, kStagesWide>(mlp_bwd_dx_kernel, tm_dh, tm_w1k, tm_dh,
                                                      tm_w1k, e, M, st)
             : launch_gemm<kBnNarrow, kDx, kStagesNarrow>(mlp_bwd_dx128_kernel, tm_dh, tm_w1k,
                                                          tm_dh, tm_w1k, e, M, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_colsum((const float*)part, (float*)dsb, B, N / kRows, 2, C, st)) !=
      cudaSuccess) {
    return (int)err;
  }
  // 5. the weight gradients over all rows, fixed-order split-K
  err = launch_wgrad(y, dh, (float*)wpart, (float*)dw1t, row_major(C, W), 1, (int)M, C, W, splits,
                     st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad(a, gb, (float*)wpart, (float*)dw2t, row_major(W, C), 1, (int)M, W, C,
                           splits, st);
}
