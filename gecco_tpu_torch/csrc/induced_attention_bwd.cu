// Per-head rectangular attention backward.
//
// Replaces gecco_tpu/ops/pallas/induced_attention.py:_bwd_kernel (served by
// rect_attention_pallas's custom_vjp through _backward_impl). Per (batch b,
// head h), from the forward's lse [M] and delta = sum_d g o [M] (fp32,
// formed by the wrapper, as the JAX package forms it outside its kernel),
// with s = q k^T / sqrt(D) and g the cotangent of o in bf16:
//   p = exp(s - lse);  dp = g v^T;  ds = p (dp - delta)        (fp32)
//   dq = bf16(ds) k / sqrt(D);  dk = bf16(ds)^T q / sqrt(D);  dv = bf16(p)^T g
//
// Bound on the H100: as the forward, device memory (6*M*N*D tensor-core
// operations, about 64 FLOP per byte of the long side at D = 48).
// Design: one block per 64-key tile of one (b, h), walking all query tiles:
// each block keeps its tile's dk and dv in registers across the query
// tiles (warp w: the 16-row strip w % 4 of the key tile over half w / 4 of
// each query tile, the halves summed at the end) and writes them once,
// where the TPU kernel wrote per-query-tile fp32 partials and summed them
// outside. The pool direction (64 queries, 2048 keys) gives a query tile 32
// key-tile blocks, whose dq parts meet through fp32 atomics in a buffer
// the wrapper zeroes and rounds (the order, and so the last bit, changes
// from run to run); the unpool direction (2048 queries, 64 keys) has one
// key tile, whose block writes each dq row whole, in bf16. Per query tile:
// s and dp as two products into shared memory, p and ds elementwise
// (rounded to bf16), then dv, dk (register strips) and dq (to shared
// memory, then out). Operands are read, and outputs written, through their
// strides. One instance per head width D = 16 DT, DT 1 to 8, 12 and 16, as
// the forward; at D 256 a grid dimension over two 128-column slices of dk,
// dv and dq (each block forms s and dp at full D again).
#include <cmath>

#include "attention.cuh"

using namespace gecco;

namespace {

// Shared memory: the k and v tiles [64, D] of the block, the q and g tiles
// [64, D] of the query tile (bf16, row stride D + 8); s and dp [64, 64]
// (fp32, row stride 68), the dq part [64, DS] (row stride DS + 4) reusing
// s, whose region is as wide as the wider; p and ds [64, 64] (bf16, row
// stride 72); the query tile's lse and delta [64]. A block keeps dk, dv
// and dq for one slice of DS = 16 ST of the D columns (blockIdx.x % the
// D / DS slices): s and dp take every column, so each slice's block forms
// them at full D again; one slice (ST = DT) up to D 192.
template <int DT, int ST>
__global__ void __launch_bounds__(kThreads)
rect_attn_bwd_kernel(Operand q, Operand k, Operand v, Operand g, const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dq, Strides dqs,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dkvs, int H, int M,
                     int N, float scale, int dq_atomic) {
  constexpr int D = 16 * DT, DS = 16 * ST, T = kAttnTile;
  constexpr int ld = D + kPad, lds = T + kPadF, ldp = T + kPad, ldo = DS + kPadF;
  constexpr int lss = lds > ldo ? lds : ldo;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T * ld;
  bf16* qs = vs + T * ld;
  bf16* gs = qs + T * ld;
  bf16* ps = gs + T * ld;
  bf16* dss = ps + T * ldp;
  float* ss = reinterpret_cast<float*>(dss + T * ldp);
  float* dps = ss + T * lss;
  float* lse_s = dps + T * lds;
  float* delta_s = lse_s + T;

  constexpr int kSlices = DT / ST;
  const int b = blockIdx.z, h = blockIdx.y, n0 = (blockIdx.x / kSlices) * T;
  const int c0 = (blockIdx.x % kSlices) * DS;  // the block's first column of dq, dk, dv
  const int nv = min(T, N - n0);
  const int warp = threadIdx.x / 32;
  const int strip = (warp % 4) * 16, k0 = (warp / 4) * 32;
  const float* lse_bh = lse + ((long long)b * H + h) * M;
  const float* delta_bh = delta + ((long long)b * H + h) * M;

  stage_rows(ks, ld, k.at(b, h, n0), k.s.sr, T, nv, D);
  stage_rows(vs, ld, v.at(b, h, n0), v.s.sr, T, nv, D);
  FragC dk_acc[ST], dv_acc[ST];
#pragma unroll
  for (int t = 0; t < ST; ++t) {
    wmma::fill_fragment(dk_acc[t], 0.0f);
    wmma::fill_fragment(dv_acc[t], 0.0f);
  }

  for (int m0 = 0; m0 < M; m0 += T) {
    const int mv = min(T, M - m0);
    __syncthreads();  // the last query tile's readers of qs, gs, ps, dss and ss are done
    stage_rows(qs, ld, q.at(b, h, m0), q.s.sr, T, mv, D);
    stage_rows(gs, ld, g.at(b, h, m0), g.s.sr, T, mv, D);
    for (int r = threadIdx.x; r < T; r += kThreads) {
      lse_s[r] = r < mv ? lse_bh[m0 + r] : 0.0f;
      delta_s[r] = r < mv ? delta_bh[m0 + r] : 0.0f;
    }
    __syncthreads();
    // s = q k^T and dp = g v^T, the k and v tiles read as column-major [D, 64]
    gemm_to_smem<wmma::row_major, wmma::col_major>(qs, ld, ks, ld, ss, lds, T, T, D);
    gemm_to_smem<wmma::row_major, wmma::col_major>(gs, ld, vs, ld, dps, lds, T, T, D);
    __syncthreads();
    for (int e = threadIdx.x; e < T * T; e += kThreads) {
      const int r = e / T, c = e % T;
      const float p = (r < mv && c < nv) ? expf(ss[r * lds + c] * scale - lse_s[r]) : 0.0f;
      const float ds = p * (dps[r * lds + c] - delta_s[r]);
      ps[r * ldp + c] = __float2bfloat16(p);
      dss[r * ldp + c] = __float2bfloat16(ds);
    }
    __syncthreads();
    // dv += p^T g and dk += ds^T q over this query tile, the slice's
    // columns (p, ds read as column-major [64 keys, 64 queries] operands)
    warp_rows_acc<ST, wmma::col_major, wmma::row_major>(dv_acc, ps, ldp, gs + c0, ld, strip, k0,
                                                         k0 + 32);
    warp_rows_acc<ST, wmma::col_major, wmma::row_major>(dk_acc, dss, ldp, qs + c0, ld, strip,
                                                         k0, k0 + 32);
    // this key tile's part of dq = ds k in the slice, into the logits' buffer
    gemm_to_smem<wmma::row_major, wmma::row_major>(dss, ldp, ks + c0, ld, ss, ldo, T, DS, T);
    __syncthreads();
    for (int e = threadIdx.x; e < mv * DS; e += kThreads) {
      const int r = e / DS, d = e % DS;
      const float val = scale * ss[r * ldo + d];
      const long long at = dqs.at(b, h, m0 + r) + c0 + d;
      if (dq_atomic) {
        atomicAdd(reinterpret_cast<float*>(dq) + at, val);
      } else {
        reinterpret_cast<bf16*>(dq)[at] = __float2bfloat16(val);
      }
    }
  }
  __syncthreads();  // every warp is done with ss
  sum_halves<ST>(dk_acc, ss, ldo);
  for (int e = threadIdx.x; e < nv * DS; e += kThreads) {
    const int r = e / DS, d = e % DS;
    dk[dkvs.at(b, h, n0 + r) + c0 + d] = __float2bfloat16(scale * ss[r * ldo + d]);
  }
  __syncthreads();  // ss is read
  sum_halves<ST>(dv_acc, ss, ldo);
  for (int e = threadIdx.x; e < nv * DS; e += kThreads) {
    const int r = e / DS, d = e % DS;
    dv[dkvs.at(b, h, n0 + r) + c0 + d] = __float2bfloat16(ss[r * ldo + d]);
  }
}

// ST = DT (one slice) up to D 192; D 256 in two slices of 128 (two [64,
// 256] fp32 register strips, dk and dv, would take 256 registers a thread,
// and the block 238 KB of shared memory)
template <int DT, int ST = DT>
cudaError_t launch_bwd(Operand q, Operand k, Operand v, Operand g, const void* lse,
                       const void* delta, void* dq, Strides dqs, void* dk, void* dv, Strides dkvs,
                       int B, int H, int M, int N, int dq_atomic, int d_real, cudaStream_t st) {
  constexpr int D = 16 * DT, DS = 16 * ST, T = kAttnTile;
  static_assert(DT % ST == 0, "rect_attn_bwd_kernel: slices of equal width");
  const size_t smem = ((size_t)4 * T * (D + kPad) + (size_t)2 * T * (T + kPad)) * 2 +
                      ((size_t)T * (DS > T ? DS + kPadF : T + kPadF) + T * (T + kPadF) + 2 * T) * 4;
  const auto kernel = rect_attn_bwd_kernel<DT, ST>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)d_real));
  kernel<<<dim3((N + T - 1) / T * (DT / ST), H, B), kThreads, smem, st>>>(
      q, k, v, g, (const float*)lse, (const float*)delta, dq, dqs, (bf16*)dk, (bf16*)dv, dkvs,
      H, M, N, scale, dq_atomic);
  return cudaGetLastError();
}

}  // namespace

// dq: fp32 (atomics; zeroed by the caller) when dq_atomic, else bf16; dq's
// strides serve both; dk and dv share theirs. D and d_real as the forward's.
extern "C" int rect_attention_bwd_launch(const void* q, const void* k, const void* v,
                                         const void* g, const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int qsb, int qsh, int qsr,
                                         int ksb, int ksh, int ksr, int vsb, int vsh, int vsr,
                                         int gsb, int gsh, int gsr, int dqsb, int dqsh, int dqsr,
                                         int dksb, int dksh, int dksr, int B, int H, int M, int N,
                                         int D, int d_real, int dq_atomic, void* stream) {
  const Operand qo{(const bf16*)q, qsb, qsh, qsr}, ko{(const bf16*)k, ksb, ksh, ksr},
      vo{(const bf16*)v, vsb, vsh, vsr}, go{(const bf16*)g, gsb, gsh, gsr};
  const Strides dqs{dqsb, dqsh, dqsr}, dkvs{dksb, dksh, dksr};
  cudaStream_t st = (cudaStream_t)stream;
  if (d_real < 1 || d_real > D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return (int)launch_bwd<1>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 32:
      return (int)launch_bwd<2>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 48:
      return (int)launch_bwd<3>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 64:
      return (int)launch_bwd<4>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 80:
      return (int)launch_bwd<5>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 96:
      return (int)launch_bwd<6>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 112:
      return (int)launch_bwd<7>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 128:
      return (int)launch_bwd<8>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                dq_atomic, d_real, st);
    case 192:
      return (int)launch_bwd<12>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M, N,
                                 dq_atomic, d_real, st);
    case 256:
      return (int)launch_bwd<16, 8>(qo, ko, vo, go, lse, delta, dq, dqs, dk, dv, dkvs, B, H, M,
                                    N, dq_atomic, d_real, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
