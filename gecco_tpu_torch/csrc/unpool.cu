// Folded unpool attention + residual, with the output channel sums.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_kernel (served
// by folded_unpool). With y = x * se + be, per batch element b and head h:
//   kft[hI+i, :] = bf16(s * k_h[i] @ bf16(wq_h * se))       [J, C]
//   brow[hI+i]   = s * (be @ wq_h^T) . k_h[i]                [J] fp32
//   vf[hI+i, :]  = bf16(v_h[i] @ wo_h^T)                      [J, C]
// then per point: logits = x @ kft^T + brow; a softmax over each head's
// I-wide block with THAT block's own max (exp argument clamped at -80);
// attn = bf16(p) @ vf; o = x + attn; out = bf16(o); sums[b] += [o | o^2].
//
// Bound on the H100: tensor-core operations (4*N*C*J per batch element
// against 4*N*C bytes of stream: J = 512 FLOP per byte at the flagship).
// Design: the per-batch fold, which the TPU kept in scratch across its
// sequential point-tile axis, is two prologue kernels writing kft/vf
// [B, J, C] bf16 and brow [B, J] fp32 (CUDA-core FMAs: its D-long dot
// products are ~1% of the work; be @ wq^T is formed once per batch element). The main kernel takes one 64-point tile (32 at C = 768)
// per block and walks the heads: each head's kft_h and vf_h are staged in
// shared memory (asynchronously, each behind the other product where both
// buffers fit), its [TN, I] logits and softmax live there too, and
// its p @ vf_h adds into a [TN, C] fp32 accumulator held in registers. Per-head processing gives every head
// block its own max by construction. Sums as in mlp.cu (fp32 atomics).
#include <cmath>

#include "common.cuh"

using namespace gecco;

namespace {

// bq[b, o] = sum_c be[b, c] * wq[o, c]: one warp per output, coalesced
// over c, shuffle-reduced.
__global__ void __launch_bounds__(kThreads)
unpool_bq_kernel(const float* __restrict__ be, const bf16* __restrict__ wq, float* __restrict__ bq,
                 int C) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (o >= C) return;
  const float* beb = be + (size_t)b * C;
  float acc = 0.0f;
  for (int c = lane; c < C; c += 32) acc += beb[c] * __bfloat162float(wq[(size_t)o * C + c]);
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) bq[(size_t)b * C + o] = acc;
}

// One thread per (j, c) output of kft and vf (wo passed transposed, so
// that neighbouring threads read neighbouring channels); one per j for brow.
__global__ void __launch_bounds__(kThreads)
unpool_fold_kernel(const float* __restrict__ se, const float* __restrict__ bq,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ wq, const bf16* __restrict__ wo_t,
                   bf16* __restrict__ kft, bf16* __restrict__ vf, float* __restrict__ brow,
                   int C, int H, int I, float scale) {
  const int b = blockIdx.y;
  const int D = C / H, J = H * I;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= J * C + J) return;
  const bf16* kb = k + (size_t)b * I * C;
  const bf16* vb = v + (size_t)b * I * C;
  if (idx < J * C) {
    const int j = idx / C, c = idx % C;
    const int h = j / I, i = j % I;
    const float sc = se[(size_t)b * C + c];
    float kacc = 0.0f, vacc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const int hd = h * D + d;
      const float wqs = __bfloat162float(
          __float2bfloat16(__bfloat162float(wq[(size_t)hd * C + c]) * sc));
      kacc += __bfloat162float(kb[(size_t)i * C + hd]) * wqs;
      vacc += __bfloat162float(vb[(size_t)i * C + hd]) * __bfloat162float(wo_t[(size_t)hd * C + c]);
    }
    kft[(size_t)b * J * C + idx] = __float2bfloat16(scale * kacc);
    vf[(size_t)b * J * C + idx] = __float2bfloat16(vacc);
  } else {
    const int j = idx - J * C;
    const int h = j / I, i = j % I;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) {
      acc += bq[(size_t)b * C + h * D + d] * __bfloat162float(kb[(size_t)i * C + h * D + d]);
    }
    brow[(size_t)b * J + j] = scale * acc;
  }
}

// Shared memory: the stream tile xs [TN, C] and the staged head operands
// kft_h and vf_h [I, C] (two buffers, each staged behind the other product,
// where they fit: dbl; else one buffer in turn), which the fp32 output tile
// [TN, C] reuses after the last head (region0 bytes); then the head's
// logits s and probabilities p [TN, I].
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
unpool_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kft,
              const float* __restrict__ brow, const bf16* __restrict__ vf, bf16* __restrict__ out,
              float* __restrict__ sums, int N, int C, int H, int I, int dbl, int region0) {
  constexpr int TN = 16 * ROWS, COLS = kMaxFrags / ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = C + kPad, lds = I + kPadF, ldp = I + kPad, ldo = C + kPadF;
  bf16* xs = reinterpret_cast<bf16*>(smem);                // [TN, C]
  bf16* kst = xs + TN * ldx;                               // [I, C] kft_h
  bf16* vst = dbl ? kst + I * ldx : kst;                   // [I, C] vf_h
  float* obuf = reinterpret_cast<float*>(smem);            // [TN, C], after the heads
  float* s = reinterpret_cast<float*>(smem + region0);     // [TN, I]
  bf16* p = reinterpret_cast<bf16*>(s + TN * lds);         // [TN, I]

  const int b = blockIdx.y;
  const int J = H * I;
  const size_t base = ((size_t)b * N + (size_t)blockIdx.x * TN) * C;
  const bf16* kb = kft + (size_t)b * J * C;
  const bf16* vb = vf + (size_t)b * J * C;
  const float* bb = brow + (size_t)b * J;
  stage_async(kst, ldx, kb, C, I, C);
  load_prenorm(xs, ldx, x + base, nullptr, nullptr, TN, C);

  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int h = 0; h < H; ++h) {
    const bool more = h + 1 < H;
    cp_async_wait<0>();
    __syncthreads();  // kft_h in kst; the last head's product is done with vst and p
    if (dbl) stage_async(vst, ldx, vb + (size_t)h * I * C, C, I, C);
    // logits of head h: x @ kft_h^T, kft_h [I, C] read as a column-major
    // [C, I] operand
    gemm_to_smem<wmma::row_major, wmma::col_major>(xs, ldx, kst, ldx, s, lds, TN, I, C);
    __syncthreads();  // kst free
    if (!dbl) {
      stage_async(vst, ldx, vb + (size_t)h * I * C, C, I, C);
    } else if (more) {
      stage_async(kst, ldx, kb + (size_t)(h + 1) * I * C, C, I, C);
    }
    // softmax over the head's I columns: 4 lanes per row, shuffle-reduced
    for (int r = threadIdx.x / 4; r < TN; r += kThreads / 4) {
      const int part = threadIdx.x % 4;
      float* row = s + r * lds;
      float m = -3.0e38f;
      for (int q = part; q < I; q += 4) {
        row[q] += bb[h * I + q];
        m = fmaxf(m, row[q]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.0f;
      for (int q = part; q < I; q += 4) {
        const float e = expf(fmaxf(row[q] - m, -80.0f));
        row[q] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      for (int q = part; q < I; q += 4) p[r * ldp + q] = __float2bfloat16(row[q] / sum);
    }
    if (dbl && more) {
      cp_async_wait<1>();  // vf_h; the next kft may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, p, ldp, vst, ldx, C, I);
    if (!dbl && more) {
      __syncthreads();  // one buffer: the product is done with it
      stage_async(kst, ldx, kb + (size_t)(h + 1) * I * C, C, I, C);
    }
  }
  __syncthreads();  // obuf reuses xs and the staging buffers
  acc_store(acc, obuf, ldo, C);
  __syncthreads();
  residual_epilogue(x + base, obuf, ldo, nullptr, out + base, sums + (size_t)b * 2 * C, TN, C);
}

}  // namespace

extern "C" int unpool_launch(const void* x, const void* se, const void* be, const void* k,
                             const void* v, const void* wq, const void* wo_t, void* bq, void* kft,
                             void* vf, void* brow, void* out, void* sums, int B, int N, int C,
                             int H, int I, int TN, void* stream) {
  const int J = H * I;
  // 1/sqrt(D) rounded once from double, as the JAX package's Python float
  const float scale = (float)(1.0 / sqrt((double)(C / H)));
  cudaStream_t st = (cudaStream_t)stream;
  unpool_bq_kernel<<<dim3((C + kWarps - 1) / kWarps, B), kThreads, 0, st>>>(
      (const float*)be, (const bf16*)wq, (float*)bq, C);
  unpool_fold_kernel<<<dim3((J * C + J + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
      (const float*)se, (const float*)bq, (const bf16*)k, (const bf16*)v, (const bf16*)wq,
      (const bf16*)wo_t, (bf16*)kft, (bf16*)vf, (float*)brow, C, H, I, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t ldx = C + kPad;
  size_t region0 = 0, smem = 0;
  int dbl = 1;
  for (; dbl >= 0; --dbl) {
    region0 = (size_t)(TN + (1 + dbl) * I) * ldx * 2;
    const size_t out_tile = (size_t)TN * (C + kPadF) * 4;
    if (out_tile > region0) region0 = out_tile;
    region0 = (region0 + 127) / 128 * 128;
    smem = region0 + (size_t)TN * (I + kPadF) * 4 + (size_t)TN * (I + kPad) * 2;
    if (smem <= kMaxSmem) break;
  }
  if (dbl < 0) return (int)cudaErrorInvalidValue;
  const auto kernel = TN == 64 ? unpool_kernel<4> : unpool_kernel<2>;
  err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N / TN, B), kThreads, smem, st>>>(
      (const bf16*)x, (const bf16*)kft, (const float*)brow, (const bf16*)vf, (bf16*)out,
      (float*)sums, N, C, H, I, dbl, (int)region0);
  return (int)cudaGetLastError();
}
