// Backward of the tiled online-softmax attention pool (folded_pool_ext).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel_v3
// (the "fold everything" body that _pool_bwd_mode picks at the flagship and
// the 8k width), with the same algebra. With y = bf16(x * se + be),
// s = y @ qf [N, J], the forward's column max macc and sum sacc [J],
// e = exp(max(s - macc, -80)) and the cotangent g_h0 [I, C], per batch
// element b:
//   DMs[hI+i, hD:(h+1)D] = bf16((g_h0 @ Wo)[i, hD:(h+1)D] / sacc)  (zero
//                           outside its head's D columns; kept as [J, D])
//   eTy  = bf16(e)^T y                                   [J, C]  pass 0
//   pacc = bf16(eTy) @ Wv^T (head-diagonal blocks only)  [J, D]
//   tacc = rowsum(DMs * pacc) / sacc;  merged = pacc / sacc  (the pooled
//          values, [I, C] by head)
//   dWo += g_h0^T bf16(merged);  dWv += DMs^T bf16(eTy)
//   W2 = bf16(Wv^T DMs^T) [C, J];  W3 = bf16(DMs Wv) [J, C]
//   ds = e * (y @ W2 - tacc) * [s - macc > -80]           pass 1
//   dy = bf16(ds) @ qf^T + bf16(e) @ W3;  dx = bf16(dy * se)
//   dse += sum dy * x;  dbe += sum dy;  dqf += y^T bf16(ds)
// The caller chains dqf to the inducers and Wk (plain PyTorch).
//
// Bound on the H100: tensor-core operations (six [N, C] x [C, J]-sized
// products per batch element that the gradient needs, hundreds of FLOP per
// byte moved; the kernels run a seventh, pass 1's recompute of s).
// Design: the TPU ran the two passes of one batch element in order with
// eTy, W2, W3 and tacc in scratch between them and the weight gradients in
// output blocks carried across the whole sequential grid; Hopper blocks run
// in no order, so the passes are separate launches with [B, J, C]
// intermediates in device memory:
//   1. pass 0: one block per (64 columns of J (32 at C = 768), b) walks all
//      N, its [Jc, C] fp32 eTy accumulator in registers;
//   2. fold: one block per (head, b) forms DMs, pacc, tacc, W2, W3 and adds
//      its dWo/dWv blocks with fp32 atomics (WMMA from L2; the products are
//      per head, since DMs is zero off its head's columns);
//   3. pass 1: one block per (64-point tile (32 at C = 768), b) walks J in
//      64-column chunks, dy [TN, C] fp32 in registers; it writes bf16(ds)
//      [B, N, J] to device memory, and dse/dbe with fp32 atomics;
//   4. dqf = sum_b y_b^T ds_b: the shared weight-gradient product
//      (backward.cuh atb_kernel), whose 48-way fp32 atomics make the sum's
//      order vary from run to run.
#include <cmath>

#include "backward.cuh"

using namespace gecco;

namespace {

// Pass 0. Shared memory: region0 holds the stream tile y [TN, C] and the
// block's qf columns [C, Jc] (staged once), later the fp32 eTy tile
// [Jc, C]; then the logits s [TN, Jc] fp32 and e^T [Jc, TN] bf16.
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
pool_bwd_pass0_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
                      const float* __restrict__ be, const bf16* __restrict__ qf,
                      const float* __restrict__ macc, bf16* __restrict__ ety, int N, int C, int J,
                      int TN, int region0) {
  constexpr int Jc = 16 * ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad, ldq = Jc + kPad, lds = Jc + kPadF, lde = TN + kPad, ldo = C + kPadF;
  bf16* y = reinterpret_cast<bf16*>(smem);
  bf16* qs = y + (size_t)TN * ldy;
  float* obuf = reinterpret_cast<float*>(smem);
  float* s = reinterpret_cast<float*>(smem + region0);
  bf16* eT = reinterpret_cast<bf16*>(s + (size_t)TN * lds);

  const int jc0 = blockIdx.x * Jc, b = blockIdx.y;
  const float* mb = macc + (size_t)b * J + jc0;
  stage(qs, ldq, qf + jc0, J, C, Jc);
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int n0 = 0; n0 < N; n0 += TN) {
    load_prenorm(y, ldy, x + ((size_t)b * N + n0) * C, se + (size_t)b * C, be + (size_t)b * C,
                 TN, C);
    __syncthreads();
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, qs, ldq, s, lds, TN, Jc, C);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * Jc; t += kThreads) {
      const int r = t / Jc, jj = t % Jc;
      eT[jj * lde + r] = __float2bfloat16(expf(fmaxf(s[r * lds + jj] - mb[jj], -80.0f)));
    }
    __syncthreads();
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, eT, lde, y, ldy, C, TN);
    __syncthreads();
  }
  acc_store(acc, obuf, ldo, C);
  __syncthreads();
  bf16* out = ety + ((size_t)b * J + jc0) * C;
  for (int t = threadIdx.x; t < Jc * C; t += kThreads) {
    out[t] = __float2bfloat16(obuf[(t / C) * ldo + t % C]);
  }
}

// Per-batch fold, one block per (head h, batch element b). Shared memory:
// the product buffer, DMs_h [I, D] and merged_h [I, D] bf16, pacc_h
// [I, D] fp32.
__global__ void __launch_bounds__(kThreads)
pool_bwd_fold_kernel(const bf16* __restrict__ gh, const bf16* __restrict__ wo,
                     const bf16* __restrict__ kvw, const float* __restrict__ sacc,
                     const bf16* __restrict__ ety, float* __restrict__ tacc, bf16* __restrict__ w2,
                     bf16* __restrict__ w3, float* __restrict__ dwv, float* __restrict__ dwo, int C,
                     int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const int ldd = D + kPad, ldp = D + kPadF;
  float* buf = reinterpret_cast<float*>(smem);
  bf16* dms = reinterpret_cast<bf16*>(smem + kBlockProductSmem);
  bf16* mrg = dms + (size_t)I * ldd;
  float* pacc = reinterpret_cast<float*>(mrg + (size_t)I * ldd);

  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* ghb = gh + (size_t)b * I * C;
  const bf16* wv = kvw + (size_t)(C + h * D) * C;  // Wv_h [D, C]
  const bf16* etyh = ety + ((size_t)b * J + h * I) * C;
  const float* sb = sacc + (size_t)b * J + h * I;

  // DMs_h = bf16((g_h0 @ Wo[:, hD:(h+1)D]) / sacc)
  block_product<wmma::row_major, wmma::row_major>(
      ghb, C, wo + h * D, C, I, D, C, buf,
      [&](int r, int c, float v) { dms[r * ldd + c] = __float2bfloat16(v * (1.0f / sb[r])); });
  // pacc_h = bf16(eTy_h) @ Wv_h^T
  block_product<wmma::row_major, wmma::col_major>(
      etyh, C, wv, C, I, D, C, buf, [&](int r, int c, float v) { pacc[r * ldp + c] = v; });
  // tacc and the merged pooled values: one warp per row
  for (int r = threadIdx.x / 32; r < I; r += kWarps) {
    const float inv = 1.0f / sb[r];
    float acc = 0.0f;
    for (int c = threadIdx.x % 32; c < D; c += 32) {
      const float p = pacc[r * ldp + c];
      acc += __bfloat162float(dms[r * ldd + c]) * p;
      mrg[r * ldd + c] = __float2bfloat16(p * inv);
    }
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) tacc[(size_t)b * J + h * I + r] = acc * inv;
  }
  __syncthreads();
  // dWo[:, hD:(h+1)D] += g_h0^T merged_h
  block_product<wmma::col_major, wmma::row_major>(
      ghb, C, mrg, ldd, C, D, I, buf,
      [&](int r, int c, float v) { atomicAdd(dwo + (size_t)r * C + h * D + c, v); });
  // W2[:, hI:(h+1)I] = Wv_h^T DMs_h^T
  block_product<wmma::col_major, wmma::col_major>(
      wv, C, dms, ldd, C, I, D, buf,
      [&](int r, int c, float v) {
        w2[((size_t)b * C + r) * J + h * I + c] = __float2bfloat16(v);
      });
  // W3[hI:(h+1)I, :] = DMs_h Wv_h
  block_product<wmma::row_major, wmma::row_major>(
      dms, ldd, wv, C, I, C, D, buf,
      [&](int r, int c, float v) {
        w3[((size_t)b * J + h * I + r) * C + c] = __float2bfloat16(v);
      });
  // dWv[hD:(h+1)D, :] += DMs_h^T eTy_h
  block_product<wmma::col_major, wmma::row_major>(
      dms, ldd, etyh, C, D, C, I, buf,
      [&](int r, int c, float v) { atomicAdd(dwv + (size_t)(h * D + r) * C + c, v); });
}

// Pass 1. Shared memory: region0 holds y [TN, C], later the fp32 dy tile;
// then s and y @ W2 for the chunk [TN, 64] fp32, bf16(e) and bf16(ds)
// [TN, 64].
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
pool_bwd_pass1_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
                      const float* __restrict__ be, const bf16* __restrict__ qf,
                      const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                      const float* __restrict__ macc, const float* __restrict__ tacc,
                      bf16* __restrict__ ds_out, bf16* __restrict__ dx, float* __restrict__ dse,
                      float* __restrict__ dbe, int N, int C, int J, int region0) {
  constexpr int TN = 16 * ROWS, JC = 64;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad, ldo = C + kPadF, lds = JC + kPadF, lde = JC + kPad;
  bf16* y = reinterpret_cast<bf16*>(smem);
  float* obuf = reinterpret_cast<float*>(smem);
  float* s = reinterpret_cast<float*>(smem + region0);
  float* dp = s + TN * lds;
  bf16* eb = reinterpret_cast<bf16*>(dp + TN * lds);
  bf16* dsb = eb + TN * lde;

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const size_t base = ((size_t)b * N + n0) * C;
  const bf16* w2b = w2 + (size_t)b * C * J;
  const bf16* w3b = w3 + (size_t)b * J * C;
  const float* mb = macc + (size_t)b * J;
  const float* tb = tacc + (size_t)b * J;
  load_prenorm(y, ldy, x + base, se + (size_t)b * C, be + (size_t)b * C, TN, C);
  __syncthreads();
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int j0 = 0; j0 < J; j0 += JC) {
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, qf + j0, J, s, lds, TN, JC, C);
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, w2b + j0, J, dp, lds, TN, JC, C);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * JC; t += kThreads) {
      const int r = t / JC, jj = t % JC;
      const float z = s[r * lds + jj] - mb[j0 + jj];
      const float e = expf(fmaxf(z, -80.0f));
      const float d = z > -80.0f ? e * (dp[r * lds + jj] - tb[j0 + jj]) : 0.0f;
      const bf16 db = __float2bfloat16(d);
      eb[r * lde + jj] = __float2bfloat16(e);
      dsb[r * lde + jj] = db;
      ds_out[((size_t)b * N + n0 + r) * J + j0 + jj] = db;
    }
    __syncthreads();
    // dy += bf16(ds) @ qf_chunk^T + bf16(e) @ W3_chunk
    gemm_acc<ROWS, COLS, wmma::col_major>(acc, dsb, lde, qf + j0, J, C, JC);
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, eb, lde, w3b + (size_t)j0 * C, C, C, JC);
  }
  __syncthreads();  // obuf reuses y
  acc_store(acc, obuf, ldo, C);
  __syncthreads();
  prenorm_grad_epilogue(obuf, ldo, nullptr, 0, x + base, se + (size_t)b * C, dx + base,
                        dse + (size_t)b * C, dbe + (size_t)b * C, TN, C);
}

}  // namespace

extern "C" int pool_ext_bwd_launch(const void* x, const void* se, const void* be, const void* qf,
                                   const void* kvw, const void* wo, const void* gh,
                                   const void* macc, const void* sacc, void* ety, void* w2,
                                   void* w3, void* tacc, void* ds, void* dx, void* dse, void* dbe,
                                   void* dqf, void* dwv, void* dwo, int B, int N, int C, int H,
                                   int I, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I, D = C / H;
  if ((C != 384 && C != 768) || I > 64 || D > 64 || D % 16 || N % 64 || J % 64) {
    return (int)cudaErrorInvalidValue;
  }
  const bool narrow = C == 384;  // Jc 64 / TN 64 at the flagship, 32 at C = 768
  const int TN0 = narrow ? 64 : 32, Jc = narrow ? 64 : 32;
  cudaError_t err;

  // pass 0
  {
    size_t region0 = (size_t)TN0 * (C + kPad) * 2 + (size_t)C * (Jc + kPad) * 2;
    const size_t out_tile = (size_t)Jc * (C + kPadF) * 4;
    if (out_tile > region0) region0 = out_tile;
    region0 = (region0 + 127) / 128 * 128;
    const size_t smem = region0 + (size_t)TN0 * (Jc + kPadF) * 4 + (size_t)Jc * (TN0 + kPad) * 2;
    const auto kernel = narrow ? pool_bwd_pass0_kernel<4, 3> : pool_bwd_pass0_kernel<2, 6>;
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<dim3(J / Jc, B), kThreads, smem, st>>>(
        (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)qf, (const float*)macc,
        (bf16*)ety, N, C, J, TN0, (int)region0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // per-batch fold
  {
    const size_t smem = kBlockProductSmem + (size_t)2 * I * (D + kPad) * 2 +
                        (size_t)I * (D + kPadF) * 4;
    if ((err = set_smem((const void*)pool_bwd_fold_kernel, smem)) != cudaSuccess) return (int)err;
    pool_bwd_fold_kernel<<<dim3(H, B), kThreads, smem, st>>>(
        (const bf16*)gh, (const bf16*)wo, (const bf16*)kvw, (const float*)sacc,
        (const bf16*)ety, (float*)tacc, (bf16*)w2, (bf16*)w3, (float*)dwv, (float*)dwo, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // pass 1
  {
    constexpr int JC = 64;
    const int TN = narrow ? 64 : 32;
    size_t region0 = (size_t)TN * (C + kPad) * 2;
    const size_t out_tile = (size_t)TN * (C + kPadF) * 4;
    if (out_tile > region0) region0 = out_tile;
    region0 = (region0 + 127) / 128 * 128;
    const size_t smem = region0 + (size_t)2 * TN * (JC + kPadF) * 4 +
                        (size_t)2 * TN * (JC + kPad) * 2;
    const auto kernel = narrow ? pool_bwd_pass1_kernel<4, 3> : pool_bwd_pass1_kernel<2, 6>;
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<dim3(N / TN, B), kThreads, smem, st>>>(
        (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)qf, (const bf16*)w2,
        (const bf16*)w3, (const float*)macc, (const float*)tacc, (bf16*)ds, (bf16*)dx,
        (float*)dse, (float*)dbe, N, C, J, (int)region0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // dqf = sum_b y_b^T bf16(ds_b)
  return (int)launch_atb((const bf16*)x, C, (size_t)N * C, (const float*)se, (const float*)be,
                         (const bf16*)ds, J, (size_t)N * J, (float*)dqf, J, 0, B, C, J, N, st);
}
