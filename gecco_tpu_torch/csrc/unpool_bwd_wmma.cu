// Backward of the folded unpool attention + residual (folded_unpool): the
// WMMA body, for the shapes the Hopper body (csrc/unpool_bwd.cu) does not
// take (an odd head count, I != 64).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_bwd_kernel, in
// all four variants of its flags: with ``prenorm`` off y = x (no dse, dbe;
// dx = dy + ...), with ``residual`` off the x term of attn and the d_attn
// term of dx drop out.
// Per batch element b and head h, with the fold WITHOUT se (the backward
// needs y explicitly; unlike the forward kernel unpool.cu):
//   kft[hI+i, :] = bf16(s * k_h[i] @ wq_h)    vf[hI+i, :] = bf16(v_h[i] @ wo_h^T)
// and per point, y = bf16(x * se + be):
//   logits = y @ kft^T; per head block: its own max m, e = exp(max(. - m,
//   -80)), p = e / sum e, act = [logit - m > -80]
//   attn = x + bf16(p) @ vf;  d_attn = g + gs1 + 2 attn gs2
//   dp = bf16(d_attn) @ vf^T;  ds = p (dp - blocksum(dp p)) act
//   dy = bf16(ds) @ kft;  dx = dy * se + d_attn;  dse += sum dy x, dbe += sum dy
//   dkf[b] += y^T bf16(ds) [C, J];  dvf[b] += bf16(p)^T bf16(d_attn) [J, C]
// The caller chains dkf/dvf to dk, dv, dWq and dWo (plain PyTorch).
//
// Bound on the H100: tensor-core operations (six [N, C] x [C, J]-sized
// products per batch element). Design: the TPU kept the fold in scratch and
// accumulated dkf/dvf in output blocks across one batch element's
// sequential point tiles. Here (1) a fold kernel (backward.cuh), one block
// per (head, b), writes kft/vf [B, J, C] bf16 with WMMA products from L2;
// (2) the main
// kernel takes a 32-point tile per block and walks the heads twice: first
// for attn (to form d_attn, which needs every head), then for dp, ds and
// dy, recomputing the head's logits and softmax rather than keeping the
// fp32 [TN, J] probabilities (each head block keeps its own max by
// construction); it writes bf16(p), bf16(ds) [B, N, J] and bf16(d_attn)
// [B, N, C] to device memory; (3) dkf and dvf are the shared weight-gradient
// product (backward.cuh atb_kernel), one output tile per block over all N of
// one batch element. The fp32 d_attn of the tile stays in shared memory for
// dx; the tile is 32 points so that it, y, bf16(d_attn) and the head's
// buffers fit one block's 227 KB. C a multiple of 128 up to 768: the 8
// warps keep C / 128 column tiles each.
#include <cmath>

#include "backward.cuh"

using namespace gecco;

namespace {

// The head's softmax over its I columns of the logits s [TN, I] (row
// stride lds, ldp for the bf16 outputs), LANES threads per row,
// shuffle-reduced: its own max m, e = exp(max(s - m, -80)), p = e / sum e,
// and bf16(p) to pb. With dp != nullptr it continues into the softmax
// backward: ds = p (dp - sum dp p) [s - m > -80], bf16 to dsb.
template <int TN>
__device__ __forceinline__ void head_softmax(float* s, int lds, bf16* pb, int ldp,
                                             const float* dp, bf16* dsb, int I) {
  constexpr int LANES = kThreads / TN;
  const int r = threadIdx.x / LANES, part = threadIdx.x % LANES;
  float* row = s + r * lds;
  float m = -3.0e38f;
  for (int q = part; q < I; q += LANES) m = fmaxf(m, row[q]);
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.0f;
  for (int q = part; q < I; q += LANES) sum += expf(fmaxf(row[q] - m, -80.0f));
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (dp == nullptr) {
    for (int q = part; q < I; q += LANES) {
      pb[r * ldp + q] = __float2bfloat16(expf(fmaxf(row[q] - m, -80.0f)) / sum);
    }
    return;
  }
  const float* dprow = dp + r * lds;
  float t = 0.0f;
  for (int q = part; q < I; q += LANES) {
    const float z = row[q] - m;
    const float p = expf(fmaxf(z, -80.0f)) / sum;
    t += dprow[q] * p;
  }
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) t += __shfl_xor_sync(0xffffffffu, t, off);
  for (int q = part; q < I; q += LANES) {
    const float z = row[q] - m;
    const float p = expf(fmaxf(z, -80.0f)) / sum;
    pb[r * ldp + q] = __float2bfloat16(p);
    dsb[r * ldp + q] = __float2bfloat16(z > -80.0f ? p * (dprow[q] - t) : 0.0f);
  }
}

// Main kernel. Shared memory: region0 = y [TN, C] and bf16(d_attn) [TN, C],
// later the fp32 dy tile; the fp32 attn, then d_attn, [TN, C]; then the
// head's logits and dp [TN, I] fp32 and bf16(p), bf16(ds) [TN, I].
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
unpool_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
                  const float* __restrict__ be, const bf16* __restrict__ kft,
                  const bf16* __restrict__ vf, const bf16* __restrict__ g,
                  const float* __restrict__ gsums, bf16* __restrict__ p_out,
                  bf16* __restrict__ ds_out, bf16* __restrict__ da_out, bf16* __restrict__ dx,
                  float* __restrict__ dse, float* __restrict__ dbe, int N, int C, int H, int I,
                  int residual) {
  constexpr int TN = 16 * ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kPad, ldf = C + kPadF, lds = I + kPadF, ldp = I + kPad;
  const int J = H * I;
  bf16* y = reinterpret_cast<bf16*>(smem);
  bf16* dab = y + (size_t)TN * ldy;
  float* dyb = reinterpret_cast<float*>(smem);
  float* da = reinterpret_cast<float*>(dab + (size_t)TN * ldy);
  float* s = da + (size_t)TN * ldf;
  float* dp = s + TN * lds;
  bf16* pb = reinterpret_cast<bf16*>(dp + TN * lds);
  bf16* dsb = pb + TN * ldp;

  const int b = blockIdx.y, n0 = blockIdx.x * TN;
  const size_t base = ((size_t)b * N + n0) * C;
  const bf16* kb = kft + (size_t)b * J * C;
  const bf16* vb = vf + (size_t)b * J * C;
  const float* seb = se ? se + (size_t)b * C : nullptr;
  load_prenorm(y, ldy, x + base, seb, be ? be + (size_t)b * C : nullptr, TN, C);
  __syncthreads();

  // heads, first walk: attn = sum_h bf16(p_h) @ vf_h
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int h = 0; h < H; ++h) {
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, ldy, kb + (size_t)h * I * C, C, s, lds, TN,
                                                   I, C);
    __syncthreads();
    head_softmax<TN>(s, lds, pb, ldp, nullptr, nullptr, I);
    __syncthreads();
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, pb, ldp, vb + (size_t)h * I * C, C, C, I);
  }
  acc_store(acc, da, ldf, C);
  __syncthreads();
  const float* gs1 = gsums + (size_t)b * 2 * C;
  const float* gs2 = gs1 + C;
  for (int t = threadIdx.x; t < TN * C; t += kThreads) {
    const int r = t / C, c = t % C;
    const float attn = (residual ? __bfloat162float(x[base + t]) : 0.0f) + da[r * ldf + c];
    const float d = __bfloat162float(g[base + t]) + gs1[c] + 2.0f * attn * gs2[c];
    const bf16 db = __float2bfloat16(d);
    da[r * ldf + c] = d;
    dab[r * ldy + c] = db;
    da_out[base + t] = db;
  }
  __syncthreads();

  // heads, second walk: dp, ds, dy += bf16(ds_h) @ kft_h
  acc_zero(acc);
  for (int h = 0; h < H; ++h) {
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, ldy, kb + (size_t)h * I * C, C, s, lds, TN,
                                                   I, C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(dab, ldy, vb + (size_t)h * I * C, C, dp, lds,
                                                   TN, I, C);
    __syncthreads();
    head_softmax<TN>(s, lds, pb, ldp, dp, dsb, I);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * I; t += kThreads) {
      const int r = t / I, q = t % I;
      const size_t o = ((size_t)b * N + n0 + r) * J + h * I + q;
      p_out[o] = pb[r * ldp + q];
      ds_out[o] = dsb[r * ldp + q];
    }
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, dsb, ldp, kb + (size_t)h * I * C, C, C, I);
    __syncthreads();  // pb/dsb are rewritten by the next head
  }
  acc_store(acc, dyb, ldf, C);  // over y and bf16(d_attn), both read for the last time above
  __syncthreads();
  prenorm_grad_epilogue(dyb, ldf, residual ? da : nullptr, ldf, x + base, seb, dx + base,
                        dse + (size_t)b * C, dbe + (size_t)b * C, TN, C);
}

}  // namespace

extern "C" int unpool_bwd_wmma_launch(const void* x, const void* se, const void* be,
                                      const void* k, const void* v, const void* wq,
                                      const void* wo, const void* g, const void* gsums, void* kft,
                                      void* vf, void* p, void* ds, void* da, void* dx, void* dse,
                                      void* dbe, void* dkf, void* dvf, int B, int N, int C, int H,
                                      int I, int residual, int prenorm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I, D = C / H;
  if (C % 128 || C > 768 || I > 64 || I % 16 || D % 16 || N % 64 || J % 64) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = launch_unpool_bwd_fold((const bf16*)k, (const bf16*)v, (const bf16*)wq,
                                           (const bf16*)wo, (bf16*)kft, (bf16*)vf, B, C, H, I, st);
  if (err != cudaSuccess) return (int)err;

  constexpr int TN = 32;
  const size_t smem = (size_t)2 * TN * (C + kPad) * 2 + (size_t)TN * (C + kPadF) * 4 +
                      (size_t)2 * TN * (I + kPadF) * 4 + (size_t)2 * TN * (I + kPad) * 2;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  decltype(&unpool_bwd_kernel<2, 1>) kernel;
  switch (C / 128) {
    case 1: kernel = unpool_bwd_kernel<2, 1>; break;
    case 2: kernel = unpool_bwd_kernel<2, 2>; break;
    case 3: kernel = unpool_bwd_kernel<2, 3>; break;
    case 4: kernel = unpool_bwd_kernel<2, 4>; break;
    case 5: kernel = unpool_bwd_kernel<2, 5>; break;
    default: kernel = unpool_bwd_kernel<2, 6>; break;
  }
  if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return (int)err;
  const float* se_p = prenorm ? (const float*)se : nullptr;
  const float* be_p = prenorm ? (const float*)be : nullptr;
  kernel<<<dim3(N / TN, B), kThreads, smem, st>>>(
      (const bf16*)x, se_p, be_p, (const bf16*)kft, (const bf16*)vf, (const bf16*)g,
      (const float*)gsums, (bf16*)p, (bf16*)ds, (bf16*)da, (bf16*)dx, (float*)dse, (float*)dbe, N,
      C, H, I, residual);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dkf[b] = y_b^T bf16(ds_b) [C, J];  dvf[b] = bf16(p_b)^T bf16(d_attn_b) [J, C]
  err = launch_atb((const bf16*)x, C, (size_t)N * C, se_p, be_p, (const bf16*)ds, J,
                   (size_t)N * J, (float*)dkf, J, (size_t)C * J, B, C, J, N, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_atb((const bf16*)p, J, (size_t)N * J, nullptr, nullptr, (const bf16*)da, C,
                         (size_t)N * C, (float*)dvf, C, (size_t)J * C, B, J, C, N, st);
}
