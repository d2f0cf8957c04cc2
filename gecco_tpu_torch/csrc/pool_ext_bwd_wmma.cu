// Backward of the tiled online-softmax attention pool (folded_pool_ext):
// the WMMA body, for the shapes the Hopper body (csrc/pool_ext_bwd.cu) does
// not take (C other than 384 and 768, D > 64, J not a multiple of 128: the
// upsample demo's 3 x 128 model with 4 heads, the flagship width with 3).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel_v3
// with the Hopper body's algebra and bf16 roundings (see pool_ext_bwd.cu):
// with y = bf16(x * se + be), s = y @ qf, e = exp(max(s - macc, -80)),
//   eTy = bf16(bf16(e)^T y);  the fold (tacc, W3, dWv, dWo);
//   ds = e * (y @ W3^T - tacc) * [s - macc > -80]
//   dy = bf16(ds) @ qf^T + bf16(e) @ W3;  dx = bf16(dy * se)
//   dse += sum dy * x;  dbe += sum dy;  dqf = sum over b and points of y^T bf16(ds)
//
// Bound on the H100: tensor-core operations, as the Hopper body. Design
// (a simple body: WMMA tiles staged in shared memory, six launches):
// 1. pool_bwd_e_kernel, one block per (32-point tile, b): the pre-normed
//    tile in shared memory, the logits in 64-column chunks of J (qf^T read
//    in place as a column-major operand), bf16(e) [B, N, J] to device memory;
// 2. eTy^T = y^T bf16(e) [B, C, J] by the shared weight-gradient product
//    (backward.cuh atb_kernel, which pre-norms its A operand), fp32;
// 3. pool_bwd_ety_cast_kernel: eTy = bf16 of its transpose [B, J, C];
// 4. the fold (backward.cuh pool_bwd_fold_kernel, as the Hopper body's);
// 5. pool_bwd_dy_wmma_kernel, one block per (32-point tile, b): per
//    64-column chunk of J the logits and y @ W3^T (WMMA, fp32 in shared
//    memory), e and ds there (bf16, ds also to device memory), then
//    dy += bf16(ds) @ qf^T + bf16(e) @ W3 in registers (C / 128 column
//    tiles a warp); the pre-norm gradient epilogue for dx, dse, dbe;
// 6. dqf = the batch sum of y^T bf16(ds) by atb_kernel (fp32 atomics: the
//    batch sum comes in no fixed order).
#include <cmath>

#include "backward.cuh"

using namespace gecco;

namespace {

constexpr int kTN = 32;  // points per tile
constexpr int kJC = 64;  // columns of J per chunk

// bf16(e) [B, N, J] for one 32-point tile of batch element b.
__global__ void __launch_bounds__(kThreads)
pool_bwd_e_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
                  const float* __restrict__ be, const bf16* __restrict__ qft,
                  const float* __restrict__ macc, bf16* __restrict__ e_out, int N, int C, int J) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad;
  constexpr int lds = kJC + kPadF;
  bf16* y = reinterpret_cast<bf16*>(smem);
  float* s = reinterpret_cast<float*>(y + (size_t)kTN * ldy);
  const int b = blockIdx.y, n0 = blockIdx.x * kTN;
  const size_t row0 = (size_t)b * N + n0;
  load_prenorm(y, ldy, x + row0 * C, se + (size_t)b * C, be + (size_t)b * C, kTN, C);
  __syncthreads();
  const float* mb = macc + (size_t)b * J;
  for (int j0 = 0; j0 < J; j0 += kJC) {
    // s = y @ qf[:, j0 .. j0 + 64], qf^T's rows read column-major as [C, 64]
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, ldy, qft + (size_t)j0 * C, C, s, lds, kTN,
                                                   kJC, C);
    __syncthreads();
    for (int t = threadIdx.x; t < kTN * kJC; t += kThreads) {
      const int r = t / kJC, q = t % kJC;
      e_out[(row0 + r) * J + j0 + q] =
          __float2bfloat16(expf(fmaxf(s[r * lds + q] - mb[j0 + q], -80.0f)));
    }
    __syncthreads();  // s is rewritten by the next chunk
  }
}

// eTy[b, j, c] = bf16(eTy^T[b, c, j])
__global__ void __launch_bounds__(kThreads)
pool_bwd_ety_cast_kernel(const float* __restrict__ etyt, bf16* __restrict__ ety, int C, int J,
                         long long n) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const long long b = idx / ((long long)J * C), jc = idx % ((long long)J * C);
  const int j = (int)(jc / C), c = (int)(jc % C);
  ety[idx] = __float2bfloat16(etyt[(b * C + c) * J + j]);
}

// Shared memory of pool_bwd_dy_wmma_kernel: y [TN, C] bf16, the fp32 dy
// tile [TN, C], the chunk's logits and y @ W3^T [TN, 64] fp32, bf16 ds and
// e [TN, 64].
template <int COLS>
__global__ void __launch_bounds__(kThreads)
pool_bwd_dy_wmma_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
                        const float* __restrict__ be, const bf16* __restrict__ qft,
                        const bf16* __restrict__ w3, const float* __restrict__ macc,
                        const float* __restrict__ tacc, bf16* __restrict__ ds_out,
                        bf16* __restrict__ dx, float* __restrict__ dse, float* __restrict__ dbe,
                        int N, int C, int J) {
  constexpr int ROWS = kTN / 16;
  constexpr int lds = kJC + kPadF, ldp = kJC + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad, ldf = C + kPadF;
  bf16* y = reinterpret_cast<bf16*>(smem);
  float* dyb = reinterpret_cast<float*>(y + (size_t)kTN * ldy);
  float* s = dyb + (size_t)kTN * ldf;
  float* pa = s + kTN * lds;
  bf16* dsb = reinterpret_cast<bf16*>(pa + kTN * lds);
  bf16* eb = dsb + kTN * ldp;

  const int b = blockIdx.y, n0 = blockIdx.x * kTN;
  const size_t row0 = (size_t)b * N + n0;
  const float* seb = se + (size_t)b * C;
  load_prenorm(y, ldy, x + row0 * C, seb, be + (size_t)b * C, kTN, C);
  __syncthreads();
  const bf16* w3b = w3 + (size_t)b * J * C;
  const float* mb = macc + (size_t)b * J;
  const float* tb = tacc + (size_t)b * J;
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int j0 = 0; j0 < J; j0 += kJC) {
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, ldy, qft + (size_t)j0 * C, C, s, lds, kTN,
                                                   kJC, C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, ldy, w3b + (size_t)j0 * C, C, pa, lds, kTN,
                                                   kJC, C);
    __syncthreads();
    for (int t = threadIdx.x; t < kTN * kJC; t += kThreads) {
      const int r = t / kJC, q = t % kJC;
      const float z = s[r * lds + q] - mb[j0 + q];
      const float e = expf(fmaxf(z, -80.0f));
      const bf16 d = __float2bfloat16(z > -80.0f ? e * (pa[r * lds + q] - tb[j0 + q]) : 0.0f);
      eb[r * ldp + q] = __float2bfloat16(e);
      dsb[r * ldp + q] = d;
      ds_out[(row0 + r) * J + j0 + q] = d;
    }
    __syncthreads();
    // dy += bf16(ds) @ qf^T[j0 .. j0 + 64] + bf16(e) @ W3[j0 .. j0 + 64]
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, dsb, ldp, qft + (size_t)j0 * C, C, C, kJC);
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, eb, ldp, w3b + (size_t)j0 * C, C, C, kJC);
    __syncthreads();  // s, pa, ds and e are rewritten by the next chunk
  }
  acc_store(acc, dyb, ldf, C);
  __syncthreads();
  prenorm_grad_epilogue(dyb, ldf, nullptr, 0, x + row0 * C, seb, dx + row0 * C,
                        dse + (size_t)b * C, dbe + (size_t)b * C, kTN, C);
}

}  // namespace

extern "C" int pool_ext_bwd_wmma_launch(const void* x, const void* se, const void* be,
                                        const void* qft, const void* kvw, const void* wo,
                                        const void* gh, const void* macc, const void* sacc,
                                        void* e, void* etyt, void* ety, void* w3, void* tacc,
                                        void* ds, void* dx, void* dse, void* dbe, void* dqf,
                                        void* dwv, void* dwo, int B, int N, int C, int H, int I,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I, D = C / H;
  if (C % 128 || C > 768 || I % 16 || D % 16 || J % kJC || N % 64) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  // 1. bf16(e)
  {
    const size_t smem = (size_t)kTN * (C + kPad) * 2 + (size_t)kTN * (kJC + kPadF) * 4;
    if ((err = set_smem((const void*)pool_bwd_e_kernel, smem)) != cudaSuccess) return (int)err;
    pool_bwd_e_kernel<<<dim3(N / kTN, B), kThreads, smem, st>>>(
        (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)qft, (const float*)macc,
        (bf16*)e, N, C, J);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 2-3. eTy = bf16((y^T bf16(e))^T)
  err = launch_atb((const bf16*)x, C, (size_t)N * C, (const float*)se, (const float*)be,
                   (const bf16*)e, J, (size_t)N * J, (float*)etyt, J, (size_t)C * J, B, C, J, N,
                   st);
  if (err != cudaSuccess) return (int)err;
  {
    const long long n = (long long)B * J * C;
    pool_bwd_ety_cast_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const float*)etyt, (bf16*)ety, C, J, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 4. the fold
  if ((err = launch_pool_bwd_fold((const bf16*)gh, (const bf16*)wo, (const bf16*)kvw,
                                  (const float*)sacc, (const bf16*)ety, (float*)tacc, (bf16*)w3,
                                  (float*)dwv, (float*)dwo, B, C, H, I, st)) != cudaSuccess) {
    return (int)err;
  }
  // 5. ds, dx, dse, dbe
  {
    const size_t smem = (size_t)kTN * (C + kPad) * 2 + (size_t)kTN * (C + kPadF) * 4 +
                        (size_t)2 * kTN * (kJC + kPadF) * 4 + (size_t)2 * kTN * (kJC + kPad) * 2;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    decltype(&pool_bwd_dy_wmma_kernel<1>) kernel;
    switch (C / 128) {
      case 1: kernel = pool_bwd_dy_wmma_kernel<1>; break;
      case 2: kernel = pool_bwd_dy_wmma_kernel<2>; break;
      case 3: kernel = pool_bwd_dy_wmma_kernel<3>; break;
      case 4: kernel = pool_bwd_dy_wmma_kernel<4>; break;
      case 5: kernel = pool_bwd_dy_wmma_kernel<5>; break;
      default: kernel = pool_bwd_dy_wmma_kernel<6>; break;
    }
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<dim3(N / kTN, B), kThreads, smem, st>>>(
        (const bf16*)x, (const float*)se, (const float*)be, (const bf16*)qft, (const bf16*)w3,
        (const float*)macc, (const float*)tacc, (bf16*)ds, (bf16*)dx, (float*)dse, (float*)dbe, N,
        C, J);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 6. dqf = sum over the batch of y_b^T bf16(ds_b) [C, J]
  return (int)launch_atb((const bf16*)x, C, (size_t)N * C, (const float*)se, (const float*)be,
                         (const bf16*)ds, J, (size_t)N * J, (float*)dqf, J, 0, B, C, J, N, st);
}
