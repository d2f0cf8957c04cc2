// WMMA device code of the folded unpool, for the unpool's WMMA body
// (csrc/unpool_wmma.cu) and the unpool + MLP megakernel
// (csrc/unpool_mlp.cu): the per-batch fold of the q/out projections against
// the inducer-token k/v, and one point tile of the attention + residual +
// output channel sums. csrc/unpool.cu (the Hopper design of the same
// function) shares only unpool_bq_warp. The algebra is described in
// unpool.cu.
#pragma once

#include <cmath>

#include "common.cuh"

namespace gecco {

// bq[b, o] = sum_c be[b, c] * wq[o, c] for one (b, o), by one warp:
// coalesced over c, shuffle-reduced.
__device__ __forceinline__ void unpool_bq_warp(const float* __restrict__ be,
                                               const bf16* __restrict__ wq, float* __restrict__ bq,
                                               int C, int b, int o) {
  const int lane = threadIdx.x % 32;
  const float* beb = be + (size_t)b * C;
  float acc = 0.0f;
  for (int c = lane; c < C; c += 32) acc += beb[c] * __bfloat162float(wq[(size_t)o * C + c]);
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) bq[(size_t)b * C + o] = acc;
}

// One (j, c) output of kft and vf (wo passed transposed, so that
// neighbouring threads read neighbouring channels) for idx < J * C; one j
// of brow for idx - J * C < J. Without the pre-norm (se and bq null) wq is
// folded as it is and brow is 0. The inducers of a head from iv on are a
// ragged I's zero padding: their brow is -inf, which takes them out of the
// softmax (their e is exp(-80) against the row max's 1, below an fp32 step
// of the sum, and their vf rows are 0).
__device__ __forceinline__ void unpool_fold_elem(
    const float* __restrict__ se, const float* __restrict__ bq, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ wq, const bf16* __restrict__ wo_t,
    bf16* __restrict__ kft, bf16* __restrict__ vf, float* __restrict__ brow, int C, int H, int I,
    int iv, float scale, int b, int idx) {
  const int D = C / H, J = H * I;
  const bf16* kb = k + (size_t)b * I * C;
  const bf16* vb = v + (size_t)b * I * C;
  if (idx < J * C) {
    const int j = idx / C, c = idx % C;
    const int h = j / I, i = j % I;
    const float sc = se ? se[(size_t)b * C + c] : 1.0f;
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
    for (int d = 0; bq != nullptr && d < D; ++d) {
      acc += bq[(size_t)b * C + h * D + d] * __bfloat162float(kb[(size_t)i * C + h * D + d]);
    }
    brow[(size_t)b * J + j] = i < iv ? scale * acc : -INFINITY;
  }
}

// Shared memory of one point tile: the stream tile xs [TN, C] and the
// staged head operands kft_h and vf_h [I, C] (two buffers, each staged
// behind the other product, where they fit: dbl 1; else one buffer in
// turn: dbl 0; else none, the products reading them from device memory,
// mostly L2: dbl -1, which takes any I), which the fp32 output tile
// [TN, C] reuses after the last head (region0 bytes); then the head's
// logits s and probabilities p [TN, I]. Returns the block's bytes, or 0
// where no plan fits. folded_attention.py's _unpool_wmma_smem repeats this
// plan for its shape switch: change both together.
inline size_t unpool_smem_plan(int TN, int C, int I, int* dbl_out, size_t* region0_out) {
  const size_t ldx = C + kPad;
  for (int dbl = 1; dbl >= -1; --dbl) {
    size_t region0 = (size_t)(TN + (1 + dbl) * I) * ldx * 2;
    const size_t out_tile = (size_t)TN * (C + kPadF) * 4;
    if (out_tile > region0) region0 = out_tile;
    region0 = (region0 + 127) / 128 * 128;
    const size_t smem = region0 + (size_t)TN * (I + kPadF) * 4 + (size_t)TN * (I + kPad) * 2;
    if (smem <= kMaxSmem) {
      *dbl_out = dbl;
      *region0_out = region0;
      return smem;
    }
  }
  return 0;
}

// One point tile (rows tile * TN ...) of batch element b: logits, per-head
// softmax, p @ vf, the residual (where ``residual``), out and the channel
// sums over the rows before n_valid (the rest are a ragged tail's padding).
template <int ROWS>
__device__ __forceinline__ void unpool_tile(const bf16* __restrict__ x,
                                            const bf16* __restrict__ kft,
                                            const float* __restrict__ brow,
                                            const bf16* __restrict__ vf, bf16* __restrict__ out,
                                            float* __restrict__ sums, int N, int n_valid,
                                            int C, int H, int I, int dbl, int region0, int b,
                                            int tile, bool residual, unsigned char* smem) {
  constexpr int TN = 16 * ROWS, COLS = kMaxFrags / ROWS;
  const int ldx = C + kPad, lds = I + kPadF, ldp = I + kPad, ldo = C + kPadF;
  bf16* xs = reinterpret_cast<bf16*>(smem);                // [TN, C]
  bf16* kst = xs + TN * ldx;                               // [I, C] kft_h
  bf16* vst = dbl == 1 ? kst + I * ldx : kst;              // [I, C] vf_h
  float* obuf = reinterpret_cast<float*>(smem);            // [TN, C], after the heads
  float* s = reinterpret_cast<float*>(smem + region0);     // [TN, I]
  bf16* p = reinterpret_cast<bf16*>(s + TN * lds);         // [TN, I]

  const int J = H * I;
  const size_t base = ((size_t)b * N + (size_t)tile * TN) * C;
  const bf16* kb = kft + (size_t)b * J * C;
  const bf16* vb = vf + (size_t)b * J * C;
  const float* bb = brow + (size_t)b * J;
  // the row stride of the head operands: staged, or in device memory
  const int ldw = dbl >= 0 ? ldx : C;
  if (dbl >= 0) stage_async(kst, ldx, kb, C, I, C);
  load_prenorm(xs, ldx, x + base, nullptr, nullptr, TN, C);

  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int h = 0; h < H; ++h) {
    const bool more = h + 1 < H;
    const bf16* kop = dbl >= 0 ? kst : kb + (size_t)h * I * C;
    const bf16* vop = dbl >= 0 ? vst : vb + (size_t)h * I * C;
    cp_async_wait<0>();
    __syncthreads();  // kft_h in kst; the last head's product is done with vst and p
    if (dbl == 1) stage_async(vst, ldx, vb + (size_t)h * I * C, C, I, C);
    // logits of head h: x @ kft_h^T, kft_h [I, C] read as a column-major
    // [C, I] operand
    gemm_to_smem<wmma::row_major, wmma::col_major>(xs, ldx, kop, ldw, s, lds, TN, I, C);
    __syncthreads();  // kst free
    if (dbl == 0) {
      stage_async(vst, ldx, vb + (size_t)h * I * C, C, I, C);
    } else if (dbl == 1 && more) {
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
    if (dbl == 1 && more) {
      cp_async_wait<1>();  // vf_h; the next kft may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, p, ldp, vop, ldw, C, I);
    if (dbl == 0 && more) {
      __syncthreads();  // one buffer: the product is done with it
      stage_async(kst, ldx, kb + (size_t)(h + 1) * I * C, C, I, C);
    }
  }
  __syncthreads();  // obuf reuses xs and the staging buffers
  acc_store(acc, obuf, ldo, C);
  __syncthreads();
  residual_epilogue(residual ? x + base : nullptr, obuf, ldo, nullptr, out + base,
                    sums + (size_t)b * 2 * C, TN, C, n_valid - tile * TN);
}

}  // namespace gecco
