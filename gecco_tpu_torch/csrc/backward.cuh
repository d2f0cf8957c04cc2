// Shared pieces of the hand-written backward kernels (pool_ext_bwd.cu,
// unpool_bwd.cu, mlp_bwd.cu): the small per-head products of their folds,
// the weight-gradient product A^T B with its fp32-atomic epilogue, and the
// pre-norm affine's gradient epilogue.
#pragma once

#include "common.cuh"

namespace gecco {

// C[M, N] = A[M, K] @ B[K, N] in 64 x 64 output tiles through the fp32
// shared buffer ``buf`` (64 x (64 + kPadF)); epi(row, col, value) is called
// once per element, spread over the block's threads. M, N and K multiples
// of 16; the operands may sit in shared or device memory (WMMA fragment
// loads). Used for the small per-batch folds of the backwards. Ends on a
// barrier.
template <class LA, class LB, class Epi>
__device__ void block_product(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K,
                              float* buf, Epi epi) {
  constexpr int ldbuf = 64 + kPadF;
  for (int m0 = 0; m0 < M; m0 += 64) {
    for (int n0 = 0; n0 < N; n0 += 64) {
      const int mm = min(64, M - m0), nn = min(64, N - n0);
      gemm_to_smem<LA, LB>(A + offset<LA>(m0, 0, lda), lda, B + offset<LB>(0, n0, ldb), ldb, buf,
                           ldbuf, mm, nn, K);
      __syncthreads();
      for (int t = threadIdx.x; t < mm * nn; t += kThreads) {
        const int r = t / nn, c = t % nn;
        epi(m0 + r, n0 + c, buf[r * ldbuf + c]);
      }
      __syncthreads();
    }
  }
}

constexpr size_t kBlockProductSmem = (size_t)64 * (64 + kPadF) * 4;

// Weight-gradient product of the backwards: out[b][m, p] += sum_n A_b[n, m]
// * B_b[n, p] over the N rows of batch element b, one 64 x 64 output tile
// per block (grid P/64, M/64, B). A is a bf16 matrix, or with se != nullptr
// the pre-normed stream bf16(x * se[b] + be[b]) (se/be [B, M]). Both
// operands are staged 64 rows at a time in shared memory, A read as A^T.
// The tile adds into ``out`` with fp32 atomics (batch stride o_bstride; 0
// sums the batch elements into one matrix, which the wrapper zeroes), so
// the sum over the batch comes in no fixed order.
__global__ void __launch_bounds__(kThreads)
atb_kernel(const bf16* __restrict__ A, int lda, size_t a_bstride, const float* __restrict__ se,
           const float* __restrict__ be, const bf16* __restrict__ Bm, int ldb, size_t b_bstride,
           float* __restrict__ out, int ldo, size_t o_bstride, int M, int N) {
  __shared__ __align__(128) bf16 as[64 * (64 + kPad)];
  __shared__ __align__(128) bf16 bs[64 * (64 + kPad)];
  __shared__ __align__(128) float cs[64 * (64 + kPadF)];
  constexpr int ld = 64 + kPad, ldc = 64 + kPadF;
  const int p0 = blockIdx.x * 64, m0 = blockIdx.y * 64, b = blockIdx.z;
  const bf16* Ab = A + b * a_bstride + m0;
  const bf16* Bb = Bm + b * b_bstride + p0;
  const float* seb = se ? se + (size_t)b * M + m0 : nullptr;
  const float* beb = be ? be + (size_t)b * M + m0 : nullptr;
  const int warp = threadIdx.x / 32;
  // the warp's two 16 x 16 tiles of the 64 x 64 output: rows 16 * (warp / 2),
  // columns 32 * (warp % 2) and 16 more
  const int tr = (warp / 2) * 16, tc = (warp % 2) * 32;
  FragC acc0, acc1;
  wmma::fill_fragment(acc0, 0.0f);
  wmma::fill_fragment(acc1, 0.0f);
  for (int n0 = 0; n0 < N; n0 += 64) {
    for (int t = threadIdx.x; t < 64 * 8; t += kThreads) {
      const int r = t / 8, v = (t % 8) * 8;
      int4 raw = __ldg(reinterpret_cast<const int4*>(Ab + (size_t)(n0 + r) * lda + v));
      if (seb != nullptr) {
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          e[q] = __float2bfloat16(__bfloat162float(e[q]) * seb[v + q] + beb[v + q]);
        }
      }
      *reinterpret_cast<int4*>(as + r * ld + v) = raw;
      *reinterpret_cast<int4*>(bs + r * ld + v) =
          __ldg(reinterpret_cast<const int4*>(Bb + (size_t)(n0 + r) * ldb + v));
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < 64; k0 += 16) {
      // A^T [m, n]: the staged [n, m] block read column-major
      FragA<wmma::col_major> a;
      FragB<wmma::row_major> b0, b1;
      wmma::load_matrix_sync(a, as + k0 * ld + tr, ld);
      wmma::load_matrix_sync(b0, bs + k0 * ld + tc, ld);
      wmma::load_matrix_sync(b1, bs + k0 * ld + tc + 16, ld);
      wmma::mma_sync(acc0, a, b0, acc0);
      wmma::mma_sync(acc1, a, b1, acc1);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(cs + tr * ldc + tc, acc0, ldc, wmma::mem_row_major);
  wmma::store_matrix_sync(cs + tr * ldc + tc + 16, acc1, ldc, wmma::mem_row_major);
  __syncthreads();
  float* ob = out + b * o_bstride + (size_t)m0 * ldo + p0;
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    atomicAdd(ob + (size_t)(t / 64) * ldo + t % 64, cs[(t / 64) * ldc + t % 64]);
  }
}

// Launch atb_kernel for out[b] (+)= A_b^T B_b, A_b [N, M], B_b [N, P];
// M, P and N multiples of 64.
inline cudaError_t launch_atb(const bf16* A, int lda, size_t a_bstride, const float* se,
                              const float* be, const bf16* Bm, int ldb, size_t b_bstride,
                              float* out, int ldo, size_t o_bstride, int B, int M, int P, int N,
                              cudaStream_t st) {
  if (M % 64 || P % 64 || N % 64) return cudaErrorInvalidValue;
  atb_kernel<<<dim3(P / 64, M / 64, B), kThreads, 0, st>>>(A, lda, a_bstride, se, be, Bm, ldb,
                                                           b_bstride, out, ldo, o_bstride, M, N);
  return cudaGetLastError();
}

// Column epilogue of the backwards: for the [rows, C] tile of dy (fp32,
// shared, row stride ldy) at stream offset ``base`` of batch element b,
// dx = bf16(dy * se + (res ? res : 0)) (res fp32 shared, row stride ldr),
// and the pre-norm affine's gradients dse[b] += sum dy * x, dbe[b] += sum
// dy, one fp32 atomic per channel and block; without a pre-norm (se null)
// dx = bf16(dy + res) and no affine gradient.
__device__ __forceinline__ void prenorm_grad_epilogue(const float* dy, int ldy, const float* res,
                                                      int ldr, const bf16* x, const float* se,
                                                      bf16* dx, float* dse, float* dbe, int rows,
                                                      int C) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s_se = 0.0f, s_be = 0.0f;
    const float sc = se ? se[c] : 1.0f;
    for (int r = 0; r < rows; ++r) {
      const float d = dy[(size_t)r * ldy + c];
      const size_t e = (size_t)r * C + c;
      const float v = res ? d * sc + res[(size_t)r * ldr + c] : d * sc;
      dx[e] = __float2bfloat16(v);
      s_se += d * __bfloat162float(x[e]);
      s_be += d;
    }
    if (se != nullptr) {
      atomicAdd(dse + c, s_se);
      atomicAdd(dbe + c, s_be);
    }
  }
}

}  // namespace gecco
