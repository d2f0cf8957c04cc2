// Backward of the fused pre-norm + Gaussian MLP + residual
// (fused_mlp_residual): the WMMA body, for the shapes the Hopper body
// (csrc/mlp_bwd.cu) does not take (the upsample demo's C 128).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_mlp_bwd_kernel. Per
// point tile, recomputing the forward (y = bf16(x * se + be)):
//   h = y @ w1t + b1;  a = exp(-h^2 / 2);  o = bf16(a) @ w2t + b2 + x
//   g' = g + gs1 + 2 o gs2                  (the sums outputs' cotangent)
//   da = bf16(g') @ w2t^T;  dh = da * a * (-h)
//   dy = bf16(dh) @ w1t^T;  dx = g' + dy * se;  dse += sum dy x, dbe += sum dy
//   dw1t += y^T bf16(dh);  db1 += sum dh;  dw2t += bf16(a)^T bf16(g');  db2 += sum g'
//
// Bound on the H100: tensor-core operations (six [N, C] x [C, W] products
// per batch element: W = 768 FLOP per byte of the stream in and out at the
// flagship). Design: the TPU kept the [TN, W] planes in VMEM and
// accumulated the four weight gradients in output blocks carried across its
// sequential grid. Here one block takes a 64-point tile (32 above C = 384;
// C a multiple of 128 up to 768) and
// walks W in 32-wide chunks twice: first for o (the fp32 [TN, C] sum in
// registers), then, with g' formed, for da, dh and dy (registers again).
// It writes bf16(a), bf16(dh) [B, N, W] and bf16(g') [B, N, C] to device
// memory, and adds db1, db2, dse and dbe with fp32 atomics; dw1t and dw2t
// are then the shared weight-gradient product (backward.cuh atb_kernel) over
// all B x N rows, its per-batch tiles summed with fp32 atomics (no fixed
// order). The fp32 g' of the tile stays in shared memory for dx.
#include <cmath>

#include "backward.cuh"

using namespace gecco;

namespace {

constexpr int kChunk = 32;

// Shared memory: region0 = y [TN, C] and bf16(g') [TN, C], later the fp32
// dy tile; g' fp32 [TN, C] (first the product sum for o); the chunk's h and
// da [TN, 32] fp32 and one bf16 chunk operand [TN, 32] (a, then dh).
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
               const float* __restrict__ be, const bf16* __restrict__ w1t,
               const float* __restrict__ b1, const bf16* __restrict__ w2t,
               const float* __restrict__ b2, const bf16* __restrict__ g,
               const float* __restrict__ gsums, bf16* __restrict__ a_out, bf16* __restrict__ dh_out,
               bf16* __restrict__ gb_out, bf16* __restrict__ dx, float* __restrict__ dse,
               float* __restrict__ dbe, float* __restrict__ db1, float* __restrict__ db2, int N,
               int n_valid, int C, int W) {
  constexpr int TN = 16 * ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad, ldf = C + kPadF;
  constexpr int ldh = kChunk + kPadF, ldc = kChunk + kPad;
  bf16* y = reinterpret_cast<bf16*>(smem);
  bf16* gb = y + (size_t)TN * ldy;
  float* dyb = reinterpret_cast<float*>(smem);
  float* gp = reinterpret_cast<float*>(gb + (size_t)TN * ldy);
  float* hb = gp + (size_t)TN * ldf;
  float* dab = hb + TN * ldh;
  bf16* cb = reinterpret_cast<bf16*>(dab + TN * ldh);

  const int b = blockIdx.y, n0 = blockIdx.x * TN;
  const size_t row0 = (size_t)b * N + n0;
  const size_t base = row0 * C;
  load_prenorm(y, ldy, x + base, se + (size_t)b * C, be + (size_t)b * C, TN, C);
  __syncthreads();

  // first walk over W: o = bf16(a) @ w2t
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, w1t + w0, W, hb, ldh, TN, kChunk, C);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * kChunk; t += kThreads) {
      const int r = t / kChunk, q = t % kChunk;
      const float h = hb[r * ldh + q] + b1[w0 + q];
      const bf16 ab = __float2bfloat16(expf(-0.5f * h * h));
      cb[r * ldc + q] = ab;
      a_out[(row0 + r) * W + w0 + q] = ab;
    }
    __syncthreads();
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, cb, ldc, w2t + (size_t)w0 * C, C, C, kChunk);
  }
  acc_store(acc, gp, ldf, C);
  __syncthreads();
  // g' = g + gs1 + 2 o gs2, o = (sum + b2) + x; db2 += sum g'
  const float* gs1 = gsums + (size_t)b * 2 * C;
  const float* gs2 = gs1 + C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sg = 0.0f;
    for (int r = 0; r < TN; ++r) {
      const size_t e = (size_t)r * C + c;
      const float o = (gp[r * ldf + c] + b2[c]) + __bfloat162float(x[base + e]);
      // the sums' cotangent reaches the first n_valid points only (the rest
      // are a ragged tail's zero padding)
      const float g0 = __bfloat162float(g[base + e]);
      const float gv = n0 + r < n_valid ? g0 + gs1[c] + 2.0f * o * gs2[c] : g0;
      const bf16 gbv = __float2bfloat16(gv);
      gp[r * ldf + c] = gv;
      gb[r * ldy + c] = gbv;
      gb_out[base + e] = gbv;
      sg += gv;
    }
    atomicAdd(db2 + c, sg);
  }
  __syncthreads();

  // second walk over W: da, dh, dy = bf16(dh) @ w1t^T
  acc_zero(acc);
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, w1t + w0, W, hb, ldh, TN, kChunk, C);
    // da = bf16(g') @ w2t_chunk^T, the chunk's w2t rows read column-major as [C, 32]
    gemm_to_smem<wmma::row_major, wmma::col_major>(gb, ldy, w2t + (size_t)w0 * C, C, dab, ldh, TN,
                                                   kChunk, C);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * kChunk; t += kThreads) {
      const int r = t / kChunk, q = t % kChunk;
      const float h = hb[r * ldh + q] + b1[w0 + q];
      const float a = expf(-0.5f * h * h);
      const float dh = dab[r * ldh + q] * a * (-h);
      const bf16 dhb = __float2bfloat16(dh);
      hb[r * ldh + q] = dh;
      cb[r * ldc + q] = dhb;
      dh_out[(row0 + r) * W + w0 + q] = dhb;
    }
    __syncthreads();
    if (threadIdx.x < kChunk) {
      float sd = 0.0f;
      for (int r = 0; r < TN; ++r) sd += hb[r * ldh + threadIdx.x];
      atomicAdd(db1 + w0 + threadIdx.x, sd);
    }
    // dy += bf16(dh) @ w1t_chunk^T, the chunk's w1t columns read column-major as [32, C]
    gemm_acc<ROWS, COLS, wmma::col_major>(acc, cb, ldc, w1t + w0, W, C, kChunk);
    __syncthreads();  // hb/cb are rewritten by the next chunk
  }
  acc_store(acc, dyb, ldf, C);  // over y and bf16(g'), both read for the last time above
  __syncthreads();
  prenorm_grad_epilogue(dyb, ldf, gp, ldf, x + base, se + (size_t)b * C, dx + base,
                        dse + (size_t)b * C, dbe + (size_t)b * C, TN, C);
}

}  // namespace

extern "C" int mlp_bwd_wmma_launch(const void* x, const void* se, const void* be,
                                   const void* w1t, const void* b1, const void* w2t,
                                   const void* b2, const void* g, const void* gsums, void* a,
                                   void* dh, void* gb, void* dx, void* dse, void* dbe, void* dw1t,
                                   void* db1, void* dw2t, void* db2, int B, int N, int C, int W,
                                   int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 128 || C > 768 || W % 64 || N % 64 || n_valid < 1 || n_valid > N) {
    return (int)cudaErrorInvalidValue;
  }
  // 64-point tiles while the [64, C] accumulator fits a warp's 12 tiles
  // (C <= 384), else 32
  const int TN = C <= 384 ? 64 : 32;
  const size_t smem = (size_t)2 * TN * (C + kPad) * 2 + (size_t)TN * (C + kPadF) * 4 +
                      (size_t)2 * TN * (kChunk + kPadF) * 4 + (size_t)TN * (kChunk + kPad) * 2;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  decltype(&mlp_bwd_kernel<4, 1>) kernel;
  switch (C / 128) {
    case 1: kernel = mlp_bwd_kernel<4, 1>; break;
    case 2: kernel = mlp_bwd_kernel<4, 2>; break;
    case 3: kernel = mlp_bwd_kernel<4, 3>; break;
    case 4: kernel = mlp_bwd_kernel<2, 4>; break;
    case 5: kernel = mlp_bwd_kernel<2, 5>; break;
    default: kernel = mlp_bwd_kernel<2, 6>; break;
  }
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N / TN, B), kThreads, smem, st>>>(
      (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)w1t, (const float*)b1,
      (const bf16*)w2t, (const float*)b2, (const bf16*)g, (const float*)gsums, (bf16*)a,
      (bf16*)dh, (bf16*)gb, (bf16*)dx, (float*)dse, (float*)dbe, (float*)db1, (float*)db2, N,
      n_valid, C, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dw1t = sum over all rows of y^T bf16(dh) [C, W];  dw2t = bf16(a)^T bf16(g') [W, C]
  err = launch_atb((const bf16*)x, C, (size_t)N * C, (const float*)se, (const float*)be,
                   (const bf16*)dh, W, (size_t)N * W, (float*)dw1t, W, 0, B, C, W, N, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_atb((const bf16*)a, W, (size_t)N * W, nullptr, nullptr, (const bf16*)gb, C,
                         (size_t)N * C, (float*)dw2t, C, 0, B, W, C, N, st);
}
