// Shared pieces of the hand-written Hopper kernels: bf16 tensor-core tiles
// through WMMA (16x16x16, fp32 accumulate), the block-wide product helpers
// built on them, and the [B, 2, C] channel-sums epilogue.
//
// Every kernel runs 256 threads (8 warps). Both operands of a tensor-core
// product are read from shared memory where they fit: the block first
// copies them in with 16-byte loads (``stage``, or ``stage_async`` to run
// the copy behind the products), rows padded by 16 bytes against bank
// conflicts. The simple form of a first port: WMMA, no TMA, no wgmma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <type_traits>

namespace gecco {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// fp32 accumulator tiles one warp keeps in registers across a chunked
// product (8 floats per thread each): ROWS x COLS = 12, so 8 warps cover a
// 64 x 384 (4 x 3) or 32 x 768 (2 x 6) output.
constexpr int kMaxFrags = 12;
// row padding of bf16 (8 elements) and fp32 (4) tiles in shared memory
constexpr int kPad = 8;
constexpr int kPadF = 4;
// a block's shared-memory limit on sm_90 (227 KB)
constexpr size_t kMaxSmem = 232448;

using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <class Layout>
__device__ __forceinline__ size_t offset(int row, int col, int ld) {
  if constexpr (std::is_same<Layout, wmma::row_major>::value) {
    return (size_t)row * ld + col;
  } else {
    return row + (size_t)col * ld;
  }
}

template <class L>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, L>;
template <class L>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, L>;

// out[M, Nn] (fp32, shared, row-major, ld ldo) = A[M, K] @ B[K, Nn].
// Work unit: two vertically adjacent 16x16 output tiles sharing each B
// fragment; units are dealt round-robin to the warps.
template <class LA, class LB>
__device__ void gemm_to_smem(const bf16* A, int lda, const bf16* B, int ldb, float* out,
                             int ldo, int M, int Nn, int K) {
  const int warp = threadIdx.x / 32;
  const int tn = Nn / 16;
  const int units = ((M / 16 + 1) / 2) * tn;
  for (int u = warp; u < units; u += kWarps) {
    const int m0 = (u / tn) * 32, n0 = (u % tn) * 16;
    const bool two = m0 + 16 < M;
    FragC c0, c1;
    wmma::fill_fragment(c0, 0.0f);
    wmma::fill_fragment(c1, 0.0f);
    FragA<LA> a;
    FragB<LB> b;
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::load_matrix_sync(b, B + offset<LB>(k0, n0, ldb), ldb);
      wmma::load_matrix_sync(a, A + offset<LA>(m0, k0, lda), lda);
      wmma::mma_sync(c0, a, b, c0);
      if (two) {
        wmma::load_matrix_sync(a, A + offset<LA>(m0 + 16, k0, lda), lda);
        wmma::mma_sync(c1, a, b, c1);
      }
    }
    wmma::store_matrix_sync(out + (size_t)m0 * ldo + n0, c0, ldo, wmma::mem_row_major);
    if (two) {
      wmma::store_matrix_sync(out + (size_t)(m0 + 16) * ldo + n0, c1, ldo, wmma::mem_row_major);
    }
  }
}

// Register-resident accumulation of an [16*ROWS, Nn] output over chunks of
// the contraction: acc[r][c] += A @ B for the tile in row r and tile column
// warp + kWarps * c (row-major A in shared memory). Each k step loads the
// warp's A and B fragments once and reuses them across its tiles.
// Requires Nn / 16 <= kWarps * COLS.
template <int ROWS, int COLS, class LB>
__device__ __forceinline__ void gemm_acc(FragC (&acc)[ROWS][COLS], const bf16* A, int lda,
                                         const bf16* B, int ldb, int Nn, int K) {
  const int warp = threadIdx.x / 32;
  const int tn = Nn / 16;
  for (int k0 = 0; k0 < K; k0 += 16) {
    FragB<LB> b[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      if (warp + kWarps * c < tn) {
        wmma::load_matrix_sync(b[c], B + offset<LB>(k0, (warp + kWarps * c) * 16, ldb), ldb);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      FragA<wmma::row_major> a;
      wmma::load_matrix_sync(a, A + (size_t)r * 16 * lda + k0, lda);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        if (warp + kWarps * c < tn) wmma::mma_sync(acc[r][c], a, b[c], acc[r][c]);
      }
    }
  }
}

template <int ROWS, int COLS>
__device__ __forceinline__ void acc_zero(FragC (&acc)[ROWS][COLS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
  }
}

template <int ROWS, int COLS>
__device__ __forceinline__ void acc_store(FragC (&acc)[ROWS][COLS], float* out, int ldo, int Nn) {
  const int warp = threadIdx.x / 32;
  const int tn = Nn / 16;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      if (warp + kWarps * c < tn) {
        wmma::store_matrix_sync(out + (size_t)r * 16 * ldo + (warp + kWarps * c) * 16, acc[r][c],
                                ldo, wmma::mem_row_major);
      }
    }
  }
}

// Cooperative copy of a [rows, cols] bf16 block into shared memory with
// 16-byte loads; strides in elements, cols and both strides multiples of 8.
__device__ __forceinline__ void stage(bf16* dst, int ld_dst, const bf16* src, size_t ld_src,
                                     int rows, int cols) {
  const int vecs = cols / 8;
  for (int t = threadIdx.x; t < rows * vecs; t += kThreads) {
    const int r = t / vecs, v = (t % vecs) * 8;
    *reinterpret_cast<int4*>(dst + (size_t)r * ld_dst + v) =
        __ldg(reinterpret_cast<const int4*>(src + (size_t)r * ld_src + v));
  }
}

// The asynchronous form of ``stage``: cp.async 16-byte copies committed as
// one group, so the copy runs behind the products that follow. Wait with
// ``cp_async_wait<n>()`` (at most n newer groups still pending), then
// ``__syncthreads()``, before reading the block.
__device__ __forceinline__ void stage_async(bf16* dst, int ld_dst, const bf16* src, size_t ld_src,
                                           int rows, int cols) {
  const int vecs = cols / 8;
  for (int t = threadIdx.x; t < rows * vecs; t += kThreads) {
    const int r = t / vecs, v = (t % vecs) * 8;
    const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst + (size_t)r * ld_dst + v);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src + (size_t)r * ld_src + v));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// y[r, c] = bf16(x[r, c] * se[c] + be[c]) for a [rows, C] tile of the
// stream (row stride C) into shared memory (row stride ld), 8 channels per
// 16-byte load; a plain copy where se is null.
__device__ __forceinline__ void load_prenorm(bf16* y, int ld, const bf16* x, const float* se,
                                             const float* be, int rows, int C) {
  const int vecs = C / 8;
  for (int t = threadIdx.x; t < rows * vecs; t += kThreads) {
    const int r = t / vecs, c0 = (t % vecs) * 8;
    int4 raw = __ldg(reinterpret_cast<const int4*>(x + (size_t)r * C + c0));
    if (se != nullptr) {
      bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = __float2bfloat16(__bfloat162float(v[q]) * se[c0 + q] + be[c0 + q]);
      }
    }
    *reinterpret_cast<int4*>(y + (size_t)r * ld + c0) = raw;
  }
}

// Residual epilogue shared by the unpool and MLP kernels:
// o = x + (acc + bias) in fp32 (acc row stride lda), stored as bf16, and
// the channel sums of the fp32 o (before the cast) added into
// sums[b] = [s1 | s2] with one atomic per channel and block. Blocks land in
// no fixed order, so the fp32 sums vary from run to run at the level of
// their rounding.
__device__ __forceinline__ void residual_epilogue(const bf16* x, const float* acc, int lda,
                                                  const float* bias, bf16* out, float* sums,
                                                  int rows, int C) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float bc = bias ? bias[c] : 0.0f;
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const size_t e = (size_t)r * C + c;
      const float o = __bfloat162float(x[e]) + (acc[(size_t)r * lda + c] + bc);
      out[e] = __float2bfloat16(o);
      s1 += o;
      s2 += o * o;
    }
    atomicAdd(sums + c, s1);
    atomicAdd(sums + C + c, s2);
  }
}

inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace gecco
