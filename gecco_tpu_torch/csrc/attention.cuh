// Pieces shared by the per-head rectangular attention kernels
// (csrc/induced_attention.cu, csrc/induced_attention_bwd.cu): a strided
// operand tile staged into shared memory, and a warp's register-resident
// product over a slice of the contraction.
#pragma once

#include "common.cuh"

namespace gecco {

// query and key tile of both kernels (rows of a [64, D] operand tile)
constexpr int kAttnTile = 64;

// Element offsets of a [B, H, rows, D] tensor with the last stride 1.
struct Strides {
  int sb, sh, sr;  // batch, head and row strides in elements
  __device__ long long at(int b, int h, int r) const {
    return (long long)b * sb + (long long)h * sh + (long long)r * sr;
  }
};

// A strided bf16 operand [B, H, rows, D].
struct Operand {
  const bf16* ptr;
  Strides s;
  __device__ const bf16* at(int b, int h, int r) const { return ptr + s.at(b, h, r); }
};

// Copy ``rows`` rows of D bf16 values (row stride ``ld_src`` elements, a
// multiple of 8) into shared memory (row stride ``ld``) with 16-byte
// loads; rows at or beyond ``valid`` are zero-filled, so that a ragged
// edge adds nothing to the products.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, long long ld_src,
                                           int rows, int valid, int D) {
  const int vecs = D / 8;
  for (int t = threadIdx.x; t < rows * vecs; t += kThreads) {
    const int r = t / vecs, c = (t % vecs) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid) val = __ldg(reinterpret_cast<const int4*>(src + r * ld_src + c));
    *reinterpret_cast<int4*>(dst + (size_t)r * ld + c) = val;
  }
}

// acc[t] += A[r0 : r0 + 16, k0 : k1] @ B[k0 : k1, 16 t : 16 t + 16] for
// t < DT, both operands in shared memory: one warp's 16-row strip of a
// [*, 16 DT] product over a slice of the contraction.
template <int DT, class LA, class LB>
__device__ __forceinline__ void warp_rows_acc(FragC (&acc)[DT], const bf16* A, int lda,
                                              const bf16* B, int ldb, int r0, int k0, int k1) {
  for (int k = k0; k < k1; k += 16) {
    FragA<LA> a;
    wmma::load_matrix_sync(a, A + offset<LA>(r0, k, lda), lda);
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      FragB<LB> b;
      wmma::load_matrix_sync(b, B + offset<LB>(k, 16 * t, ldb), ldb);
      wmma::mma_sync(acc[t], a, b, acc[t]);
    }
  }
}

// The warps split a [64, 16 DT] product as 4 row strips x 2 halves of the
// contraction (warp w: strip w % 4, half w / 4). Sum the two halves of
// ``acc`` into ``buf`` (fp32, row stride ldb): on return (after a block
// barrier) buf holds the [64, 16 DT] product.
template <int DT>
__device__ __forceinline__ void sum_halves(FragC (&acc)[DT], float* buf, int ldb) {
  const int warp = threadIdx.x / 32;
  float* strip = buf + (size_t)(warp % 4) * 16 * ldb;
  if (warp >= 4) {
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      wmma::store_matrix_sync(strip + 16 * t, acc[t], ldb, wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      FragC other;
      wmma::load_matrix_sync(other, strip + 16 * t, ldb, wmma::mem_row_major);
#pragma unroll
      for (int e = 0; e < other.num_elements; ++e) other.x[e] += acc[t].x[e];
      wmma::store_matrix_sync(strip + 16 * t, other, ldb, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

}  // namespace gecco
