// Device code of the resident pool (csrc/pool.cu) and of the pool
// forward's WMMA body (csrc/pool_ext_wmma.cu): the per-(head, batch)
// block's shared-memory layout and weight staging; and the output
// projection linear_nt_kernel, which the chunked pool (csrc/pool_ext.cu)
// shares.
#pragma once

#include "common.cuh"

namespace gecco {

constexpr int kPoolTile = 64;

// Shared-memory layout of a pool block (one head h of one batch element),
// in bytes from the start; the head's weight operands qf_h [C, I] and Wv_h
// [D, C] are staged at the end where they fit (stage_w), else read from
// device memory. folded_attention.py's _pool_wmma_smem repeats
// total_unstaged for its shape switch: change both together.
struct PoolSmem {
  int ldy, lds, ldv, lde, ldvb, ldq, ldw;
  size_t y, s, vt, tmp, P, stats, e, vb, qst, wst, total_unstaged, total;
  __host__ __device__ PoolSmem(int C, int I, int D) {
    ldy = C + kPad; lds = I + kPadF; ldv = D + kPadF; lde = I + kPad; ldvb = D + kPad;
    ldq = I + kPad; ldw = C + kPad;
    y = 0;
    s = y + (size_t)kPoolTile * ldy * 2;
    vt = s + (size_t)kPoolTile * lds * 4;
    tmp = vt + (size_t)kPoolTile * ldv * 4;
    P = tmp + (size_t)I * ldv * 4;
    stats = P + (size_t)I * D * 4;
    e = stats + (size_t)3 * I * 4;
    vb = e + (size_t)kPoolTile * lde * 2;
    qst = vb + (size_t)kPoolTile * ldvb * 2;
    total_unstaged = qst;
    wst = qst + (size_t)C * ldq * 2;
    total = wst + (size_t)D * ldw * 2;
  }
};

// The operands of head h: qf_h (columns hI.. of qf [C, J]) and Wv_h =
// kvw[C + hD : C + (h+1)D, :], read as a column-major [C, D] operand; staged
// in the block's shared memory where stage_w, else pointers into device
// memory. Ends with the staging copies issued (the caller's next barrier
// makes them visible).
__device__ __forceinline__ void pool_head_operands(unsigned char* smem, const PoolSmem& L,
                                                   const bf16* qf, const bf16* kvw, int C, int H,
                                                   int I, int h, int stage_w, const bf16** qB,
                                                   int* ldqB, const bf16** wB, int* ldwB) {
  const int D = C / H, J = H * I;
  *qB = qf + h * I;
  *ldqB = J;
  *wB = kvw + (size_t)(C + h * D) * C;
  *ldwB = C;
  if (stage_w) {
    bf16* qst = reinterpret_cast<bf16*>(smem + L.qst);
    bf16* wst = reinterpret_cast<bf16*>(smem + L.wst);
    stage(qst, L.ldq, *qB, J, C, I);
    stage(wst, L.ldw, *wB, C, D, C);
    *qB = qst;
    *ldqB = L.ldq;
    *wB = wst;
    *ldwB = L.ldw;
  }
}

// out[M, Nout] = bf16(A[M, K] @ W[Nout, K]^T), one 64 x 64 output tile per
// block; W read as a column-major [K, Nout] operand (the pools' output
// projection h0 = pooled @ Wo^T).
__global__ void __launch_bounds__(kThreads)
linear_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, bf16* __restrict__ out,
                 int M, int Nout, int K) {
  __shared__ __align__(128) float tile[64 * 64];
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  gemm_to_smem<wmma::row_major, wmma::col_major>(A + (size_t)m0 * K, K, W + (size_t)n0 * K, K,
                                                 tile, 64, 64, 64, K);
  __syncthreads();
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    out[(size_t)(m0 + t / 64) * Nout + n0 + t % 64] = __float2bfloat16(tile[t]);
  }
}

}  // namespace gecco
