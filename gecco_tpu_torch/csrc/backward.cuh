// Shared pieces of the hand-written backward kernels (pool_ext_bwd*.cu,
// unpool_bwd*.cu, mlp_bwd.cu): the small per-head products of their folds
// and the two bodies' fold kernels of the pool and unpool backwards, the
// pre-normed stream, the weight-gradient product A^T B with its
// fp32-atomic epilogue, and the pre-norm affine's gradient epilogue.
#pragma once

#include <cmath>

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

// y = bf16(x * se + be) [B * N, C], 8 channels a thread: the stream the
// Hopper backwards' products read by TMA, formed once.
__global__ void __launch_bounds__(kThreads)
prenorm_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
               const float* __restrict__ be, bf16* __restrict__ y, int N, int C, long long vecs) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= vecs) return;
  const long long e0 = idx * 8;
  const int c = (int)(e0 % C);
  const size_t bc = (size_t)(e0 / ((long long)N * C)) * C + c;
  int4 raw = __ldg(reinterpret_cast<const int4*>(x + e0));
  bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = __float2bfloat16(__bfloat162float(v[e]) * __ldg(se + bc + e) + __ldg(be + bc + e));
  }
  *reinterpret_cast<int4*>(y + e0) = raw;
}

inline cudaError_t launch_prenorm(const bf16* x, const float* se, const float* be, bf16* y, int B,
                                  int N, int C, cudaStream_t st) {
  const long long vecs = (long long)B * N * C / 8;
  prenorm_kernel<<<(unsigned)((vecs + kThreads - 1) / kThreads), kThreads, 0, st>>>(x, se, be, y,
                                                                                  N, C, vecs);
  return cudaGetLastError();
}

// The pool backward's per-batch fold (both bodies), one block per (head h,
// batch element b, block of up to 64 of the head's inducer rows), from eTy
// [B, J, C] bf16, the cotangent g_h0 [B, I, C] and the forward's column
// sums sacc [B, J]:
//   DMs_h = bf16((g_h0 @ Wo[:, hD:(h+1)D]) / sacc)         [I, D]
//   pacc_h = eTy_h @ Wv_h^T;  tacc = rowsum(DMs_h * pacc_h) / sacc
//   dWo[:, hD:(h+1)D] += g_h0^T bf16(pacc_h / sacc);  dWv[hD:(h+1)D] += DMs_h^T eTy_h
//   W3[hI:(h+1)I] = bf16(DMs_h Wv_h)                        [I, C]
// (the v3 algebra's W2 = bf16(Wv^T DMs^T) is W3^T: the same fp32 sums, so
// the dy pass reads W3 for both). Every row of DMs, pacc, tacc, merged and
// W3 is its own, so a block forms those of its rows only, and adds its
// rows' share of dWo and dWv through the atomics; at I <= 64 one block
// takes a head's rows, and its bytes do not grow with I beyond. Shared
// memory: the product buffer, the rows' DMs_h and merged_h [min(I, 64), D]
// bf16 and pacc_h [min(I, 64), D] fp32.
constexpr int kFoldRows = 64;

__global__ void __launch_bounds__(kThreads)
pool_bwd_fold_kernel(const bf16* __restrict__ gh, const bf16* __restrict__ wo,
                     const bf16* __restrict__ kvw, const float* __restrict__ sacc,
                     const bf16* __restrict__ ety, float* __restrict__ tacc, bf16* __restrict__ w3,
                     float* __restrict__ dwv, float* __restrict__ dwo, int C, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const int ldd = D + kPad, ldp = D + kPadF;
  const int cap = min(I, kFoldRows);  // rows a block's buffers hold
  float* buf = reinterpret_cast<float*>(smem);
  bf16* dms = reinterpret_cast<bf16*>(smem + kBlockProductSmem);
  bf16* mrg = dms + (size_t)cap * ldd;
  float* pacc = reinterpret_cast<float*>(mrg + (size_t)cap * ldd);

  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * kFoldRows;
  const int rows = min(kFoldRows, I - r0);  // a multiple of 16
  const bf16* ghb = gh + ((size_t)b * I + r0) * C;
  const bf16* wv = kvw + (size_t)(C + h * D) * C;  // Wv_h [D, C]
  const bf16* etyh = ety + ((size_t)b * J + h * I + r0) * C;
  const float* sb = sacc + (size_t)b * J + h * I + r0;

  // DMs_h = bf16((g_h0 @ Wo[:, hD:(h+1)D]) / sacc)
  block_product<wmma::row_major, wmma::row_major>(
      ghb, C, wo + h * D, C, rows, D, C, buf,
      [&](int r, int c, float v) { dms[r * ldd + c] = __float2bfloat16(v * (1.0f / sb[r])); });
  // pacc_h = bf16(eTy_h) @ Wv_h^T
  block_product<wmma::row_major, wmma::col_major>(
      etyh, C, wv, C, rows, D, C, buf, [&](int r, int c, float v) { pacc[r * ldp + c] = v; });
  // tacc and the merged pooled values: one warp per row
  for (int r = threadIdx.x / 32; r < rows; r += kWarps) {
    const float inv = 1.0f / sb[r];
    float acc = 0.0f;
    for (int c = threadIdx.x % 32; c < D; c += 32) {
      const float p = pacc[r * ldp + c];
      acc += __bfloat162float(dms[r * ldd + c]) * p;
      mrg[r * ldd + c] = __float2bfloat16(p * inv);
    }
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) tacc[(size_t)b * J + h * I + r0 + r] = acc * inv;
  }
  __syncthreads();
  // dWo[:, hD:(h+1)D] += g_h0^T merged_h over the block's rows
  block_product<wmma::col_major, wmma::row_major>(
      ghb, C, mrg, ldd, C, D, rows, buf,
      [&](int r, int c, float v) { atomicAdd(dwo + (size_t)r * C + h * D + c, v); });
  // W3[hI + r0 + r, :] = DMs_h Wv_h
  block_product<wmma::row_major, wmma::row_major>(
      dms, ldd, wv, C, rows, C, D, buf,
      [&](int r, int c, float v) {
        w3[((size_t)b * J + h * I + r0 + r) * C + c] = __float2bfloat16(v);
      });
  // dWv[hD:(h+1)D, :] += DMs_h^T eTy_h over the block's rows
  block_product<wmma::col_major, wmma::row_major>(
      dms, ldd, etyh, C, D, C, rows, buf,
      [&](int r, int c, float v) { atomicAdd(dwv + (size_t)(h * D + r) * C + c, v); });
}

// the fold's block bytes (folded_attention.py _pool_bwd_fold_smem: change
// both together)
inline size_t pool_bwd_fold_smem(int D, int I) {
  const size_t rows = I < kFoldRows ? I : kFoldRows;
  return kBlockProductSmem + 2 * rows * (D + kPad) * 2 + rows * (D + kPadF) * 4;
}

inline cudaError_t launch_pool_bwd_fold(const bf16* gh, const bf16* wo, const bf16* kvw,
                                        const float* sacc, const bf16* ety, float* tacc, bf16* w3,
                                        float* dwv, float* dwo, int B, int C, int H, int I,
                                        cudaStream_t st) {
  const size_t smem = pool_bwd_fold_smem(C / H, I);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)pool_bwd_fold_kernel, smem);
  if (err != cudaSuccess) return err;
  pool_bwd_fold_kernel<<<dim3(H, B, (I + kFoldRows - 1) / kFoldRows), kThreads, smem, st>>>(
      gh, wo, kvw, sacc, ety, tacc, w3, dwv, dwo, C, H, I);
  return cudaGetLastError();
}

// The unpool backward's fold (both bodies), one block per (head h, batch
// element b), without se (the backward reads y explicitly):
//   kft[hI+i, :] = bf16(s * k_h[i] @ wq_h)    vf[hI+i, :] = bf16(v_h[i] @ wo_h^T)
// as [B, J, C] bf16, WMMA products from L2.
__global__ void __launch_bounds__(kThreads)
unpool_bwd_fold_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ wq, const bf16* __restrict__ wo,
                       bf16* __restrict__ kft, bf16* __restrict__ vf, int C, int H, int I,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int D = C / H, J = H * I;
  const int h = blockIdx.x, b = blockIdx.y;
  bf16* kfb = kft + ((size_t)b * J + h * I) * C;
  bf16* vfb = vf + ((size_t)b * J + h * I) * C;
  // kft_h = s * k_h [I, D] @ wq_h [D, C]
  block_product<wmma::row_major, wmma::row_major>(
      k + (size_t)b * I * C + h * D, C, wq + (size_t)h * D * C, C, I, C, D, buf,
      [&](int r, int c, float x) { kfb[(size_t)r * C + c] = __float2bfloat16(scale * x); });
  // vf_h = v_h [I, D] @ wo_h^T, wo_h = wo[:, hD:(h+1)D] read column-major as [D, C]
  block_product<wmma::row_major, wmma::col_major>(
      v + (size_t)b * I * C + h * D, C, wo + h * D, C, I, C, D, buf,
      [&](int r, int c, float x) { vfb[(size_t)r * C + c] = __float2bfloat16(x); });
}

inline cudaError_t launch_unpool_bwd_fold(const bf16* k, const bf16* v, const bf16* wq,
                                          const bf16* wo, bf16* kft, bf16* vf, int B, int C,
                                          int H, int I, cudaStream_t st) {
  // 1/sqrt(D) rounded once from double, as the JAX package's Python float
  const float scale = (float)(1.0 / sqrt((double)(C / H)));
  cudaError_t err = set_smem((const void*)unpool_bwd_fold_kernel, kBlockProductSmem);
  if (err != cudaSuccess) return err;
  unpool_bwd_fold_kernel<<<dim3(H, B), kThreads, kBlockProductSmem, st>>>(k, v, wq, wo, kft, vf,
                                                                         C, H, I, scale);
  return cudaGetLastError();
}

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
