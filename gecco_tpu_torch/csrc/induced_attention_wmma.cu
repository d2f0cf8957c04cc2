// Per-head rectangular attention forward, with the logsumexp: the WMMA
// body, kept beside the Hopper body (csrc/induced_attention.cu) for the
// head widths and layouts that one does not take (induced_attention.py
// _rect_fwd_body).
//
// Replaces gecco_tpu/ops/pallas/induced_attention.py:_attn_kernel (heads
// unrolled in one grid step) and _attn_kernel_1h (heads on the grid), both
// served by rect_attention_pallas through _forward_impl; the TPU's choice
// between the two is a VMEM budget with no meaning here, so one kernel
// serves both. Per (batch b, head h), with s = q k^T / sqrt(D) in fp32:
//   m = max_n s;  l = sum_n exp(s - m);  p = bf16(exp(s - m) / l)
//   o = bf16(p @ v);  lse = m + log l  (fp32; no exp clamp)
//
// Bound on the H100: the set transformer's two shapes are thin (D = 48,
// one side I = 64): 4*M*N*D tensor-core operations against the bytes of
// q, k, v and o, about 4*64*48 / (2*48*2) = 64 FLOP per byte of the long
// side, so device memory bounds both directions.
// Design: one block per 64-query tile of one (b, h); the keys in 64-row
// tiles. A block's shared memory cannot hold a row of the pool's logits
// (2048 keys x 64 queries x fp32 = 512 KB; the TPU kept it whole in VMEM),
// so where there is more than one key tile the block makes two passes: the
// first keeps each row's running max and sum (rescaled as the max moves),
// the second recomputes the logits and normalises p before rounding it, as
// the TPU kernel does (a flash-style end normalisation would round p
// elsewhere); with one key tile (the unpool) the logits are computed once.
// The 64 x D output is accumulated in registers: warp w keeps the 16-row
// strip w % 4 over half w / 4 of each key tile, and the halves are summed
// at the end. q, k and v are read through their strides (the [B, N, C]
// projections seen as [B, H, N, D], the pool's inducers with a zero batch
// stride); o is written through its own. The rows of 4 lanes each do the
// softmax of one query row, shuffle-reduced. One instance per head width
// D = 16 DT, DT 1 to 8 (the JAX kernel takes any D; the flagship's is 48,
// three heads at C 384 give 128), D 192 and D 256 (three heads at C 768)
// for the widths above: the wrapper zero-pads a head width to the next
// instance's and passes the real one for the softmax scale.
#include <cmath>

#include "attention.cuh"

using namespace gecco;

namespace {

// Shared memory: q tile [64, D], k and v tiles [64, D] (bf16, row stride
// D + 8), the probabilities p [64, 64] (bf16, row stride 72), the logits s
// [64, 64] (fp32, row stride 68), which the output's halves [64, D] (row
// stride D + 4) reuse at the end: the last region, as wide as the wider.
template <int DT>
__global__ void __launch_bounds__(kThreads)
rect_attn_fwd_kernel(Operand q, Operand k, Operand v, bf16* __restrict__ o, Strides os,
                     float* __restrict__ lse, int H, int M, int N, float scale) {
  constexpr int D = 16 * DT, T = kAttnTile;
  constexpr int ld = D + kPad, lds = T + kPadF, ldp = T + kPad, ldo = D + kPadF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + T * ld;
  bf16* vs = ks + T * ld;
  bf16* ps = vs + T * ld;
  float* ss = reinterpret_cast<float*>(ps + T * ldp);

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * T;
  const int mv = min(T, M - m0);
  const int nkt = (N + T - 1) / T;
  const int warp = threadIdx.x / 32;
  // the softmax row of this thread and its part of the row
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;

  stage_rows(qs, ld, q.at(b, h, m0), q.s.sr, T, mv, D);
  float m_run = -INFINITY, l_run = 0.0f;

  // the logits of key tile kt into ss (k tile, and the v tile if asked)
  auto logits = [&](int kt, bool with_v) {
    const int nv = min(T, N - kt * T);
    __syncthreads();  // the last tile's readers of ks, vs and ss are done
    stage_rows(ks, ld, k.at(b, h, kt * T), k.s.sr, T, nv, D);
    if (with_v) stage_rows(vs, ld, v.at(b, h, kt * T), v.s.sr, T, nv, D);
    __syncthreads();  // q, k (and v) in place
    gemm_to_smem<wmma::row_major, wmma::col_major>(qs, ld, ks, ld, ss, lds, T, T, D);
    __syncthreads();
    return nv;
  };
  // fold key tile's logits (nv valid keys) into the row's running max and sum
  auto update = [&](int nv) {
    const float* row = ss + r * lds;
    float cm = -INFINITY;
    for (int c = part; c < nv; c += 4) cm = fmaxf(cm, row[c] * scale);
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
    const float mn = fmaxf(m_run, cm);
    float sum = 0.0f;
    for (int c = part; c < nv; c += 4) sum += expf(row[c] * scale - mn);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * expf(m_run - mn) + sum;
    m_run = mn;
  };

  if (nkt > 1) {
    for (int kt = 0; kt < nkt; ++kt) update(logits(kt, false));
  }
  FragC acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) wmma::fill_fragment(acc[t], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {
    const int nv = logits(kt, true);
    if (nkt == 1) update(nv);
    const float* row = ss + r * lds;
    for (int c = part; c < T; c += 4) {
      const float p = c < nv ? expf(row[c] * scale - m_run) / l_run : 0.0f;
      ps[r * ldp + c] = __float2bfloat16(p);
    }
    __syncthreads();
    warp_rows_acc<DT, wmma::row_major, wmma::row_major>(acc, ps, ldp, vs, ld, (warp % 4) * 16,
                                                         (warp / 4) * 32, (warp / 4) * 32 + 32);
  }
  if (part == 0 && r < mv) {
    lse[((long long)b * H + h) * M + m0 + r] = m_run + logf(l_run);
  }
  __syncthreads();  // every warp is done with ss and ps
  sum_halves<DT>(acc, ss, ldo);
  for (int e = threadIdx.x; e < mv * D; e += kThreads) {
    const int rr = e / D, d = e % D;
    o[os.at(b, h, m0 + rr) + d] = __float2bfloat16(ss[rr * ldo + d]);
  }
}

template <int DT>
cudaError_t launch_fwd(Operand q, Operand k, Operand v, void* o, Strides os, void* lse, int B,
                       int H, int M, int N, int d_real, cudaStream_t st) {
  constexpr int D = 16 * DT, T = kAttnTile;
  const size_t smem = ((size_t)3 * T * (D + kPad) + (size_t)T * (T + kPad)) * 2 +
                      (size_t)T * (D > T ? D + kPadF : T + kPadF) * 4;
  const auto kernel = rect_attn_fwd_kernel<DT>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  // 1/sqrt(D) of the real head width (the operands may carry zero columns
  // up to the instance's), rounded once from double, as the JAX package's
  // Python float
  const float scale = (float)(1.0 / sqrt((double)d_real));
  kernel<<<dim3((M + T - 1) / T, H, B), kThreads, smem, st>>>(
      q, k, v, (bf16*)o, os, (float*)lse, H, M, N, scale);
  return cudaGetLastError();
}

}  // namespace

// D: the operands' head width, one of the instances' (16 to 128 in steps of
// 16, 192 and 256); d_real <= D: the real head width, whose zero-padded
// columns add nothing to q k^T and give zero output columns.
extern "C" int rect_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int qsb, int qsh, int qsr, int ksb, int ksh,
                                         int ksr, int vsb, int vsh, int vsr, int osb, int osh,
                                         int osr, int B, int H, int M, int N, int D, int d_real,
                                         void* stream) {
  const Operand qo{(const bf16*)q, qsb, qsh, qsr}, ko{(const bf16*)k, ksb, ksh, ksr},
      vo{(const bf16*)v, vsb, vsh, vsr};
  const Strides os{osb, osh, osr};
  cudaStream_t st = (cudaStream_t)stream;
  if (d_real < 1 || d_real > D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch_fwd<1>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 32: return (int)launch_fwd<2>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 48: return (int)launch_fwd<3>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 64: return (int)launch_fwd<4>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 80: return (int)launch_fwd<5>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 96: return (int)launch_fwd<6>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 112: return (int)launch_fwd<7>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 128: return (int)launch_fwd<8>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 192: return (int)launch_fwd<12>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    case 256: return (int)launch_fwd<16>(qo, ko, vo, o, os, lse, B, H, M, N, d_real, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
