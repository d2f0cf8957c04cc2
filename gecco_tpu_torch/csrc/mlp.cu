// Fused pre-norm + Gaussian MLP + residual, with the output channel sums.
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
// fp32 atomic per channel (the wrapper zeroes the buffer).
#include "common.cuh"

using namespace gecco;

namespace {

// Shared memory: y [TN, C], the w1 chunk [C, chunk] and the w2 chunk
// [chunk, C] (each staged asynchronously, one behind the other product),
// which the fp32 output tile [TN, C] reuses after the last product
// (region0 bytes); then the chunk's pre-activation h and activation g.
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ se, const float* __restrict__ be,
           const bf16* __restrict__ w1t, const float* __restrict__ b1,
           const bf16* __restrict__ w2t, const float* __restrict__ b2, bf16* __restrict__ out,
           float* __restrict__ sums, int N, int C, int W, int chunk, int region0) {
  constexpr int TN = 16 * ROWS, COLS = kMaxFrags / ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad, ldw1 = chunk + kPad, ldw2 = C + kPad;
  const int ldh = chunk + kPadF, ldg = chunk + kPad, ldo = C + kPadF;
  bf16* y = reinterpret_cast<bf16*>(smem);                  // [TN, C]
  bf16* w1s = y + TN * ldy;                                 // [C, chunk]
  bf16* w2s = w1s + C * ldw1;                               // [chunk, C]
  float* obuf = reinterpret_cast<float*>(smem);             // [TN, C], after the products
  float* hbuf = reinterpret_cast<float*>(smem + region0);   // [TN, chunk]
  bf16* g = reinterpret_cast<bf16*>(hbuf + TN * ldh);       // [TN, chunk]

  const int b = blockIdx.y;
  const size_t base = ((size_t)b * N + (size_t)blockIdx.x * TN) * C;
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

}  // namespace

extern "C" int mlp_launch(const void* x, const void* se, const void* be, const void* w1t,
                          const void* b1, const void* w2t, const void* b2, void* out, void* sums,
                          int B, int N, int C, int W, int TN, void* stream) {
  // the widest W chunk (64, else 32) whose double staging fits a block
  int chunk = 64;
  size_t region0 = 0, smem = 0;
  for (; chunk >= 32; chunk /= 2) {
    const size_t ldy = C + kPad;
    region0 = ((size_t)TN * ldy + (size_t)C * (chunk + kPad) + (size_t)chunk * ldy) * 2;
    const size_t out_tile = (size_t)TN * (C + kPadF) * 4;
    if (out_tile > region0) region0 = out_tile;
    region0 = (region0 + 127) / 128 * 128;
    smem = region0 + (size_t)TN * (chunk + kPadF) * 4 + (size_t)TN * (chunk + kPad) * 2;
    if (smem <= kMaxSmem) break;
  }
  if (chunk < 32 || W % chunk != 0) return (int)cudaErrorInvalidValue;
  const auto kernel = TN == 64 ? mlp_kernel<4> : mlp_kernel<2>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N / TN, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)w1t, (const float*)b1,
      (const bf16*)w2t, (const float*)b2, (bf16*)out, (float*)sums, N, C, W, chunk,
      (int)region0);
  return (int)cudaGetLastError();
}
