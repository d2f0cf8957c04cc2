// Per-head rectangular attention forward, with the logsumexp: the Hopper
// body (TMA, wgmma with register accumulators).
//
// Replaces gecco_tpu/ops/pallas/induced_attention.py:_attn_kernel (heads
// unrolled in one grid step) and _attn_kernel_1h (heads on the grid), both
// served by rect_attention_pallas through _forward_impl. Per (batch b,
// head h), with s = q k^T / sqrt(D) in fp32:
//   m = max_n s;  l = sum_n exp(s - m);  p = bf16(exp(s - m) / l)
//   o = bf16(p @ v);  lse = m + log l  (fp32; no exp clamp)
//
// Bound on the H100: device memory. The set transformer's two shapes are
// thin (one side I = 64 rows): 4 M N D tensor-core operations against the
// bytes of q, k, v and o, about 64 operations per byte of the long side.
//
// Design: one side has at most 64 rows (one tile, "the short side"), kept
// in shared memory; the long side comes by 64-row tiles of one head
// through a TMA ring (csrc/rect_hopper.cuh: a head's D columns as a box of
// 64, the columns past D and the rows past the end zero-filled). One
// warpgroup a block, one head of one batch element, a range of the long
// side's tiles; the logits of a tile (m64n64, K = D) and the softmax stay
// in registers (row max and sum by quad shuffles), p goes to the value
// product as the register operand (wgmma_rs_t against v MN-major, N = D),
// and o and lse are written from the registers.
// - The unpool direction (N <= 64 keys, the points as queries): k and v
//   resident, the q tiles streamed; each tile's softmax is the whole row's,
//   in one pass.
// - The pool direction (M <= 64 queries, the inducers, against N > 64
//   keys): p is normalised by the row's global max and sum before its bf16
//   rounding (the TPU kernel's rounding point), so each block walks its
//   key tiles twice: pass A keeps the rows' running max and sum over its
//   range (rescaled as the max moves); the blocks of one (b, h), a cluster
//   (up to 8), merge their (m, l) through distributed shared memory in rank
//   order; pass B recomputes the logits and accumulates the normalised p @
//   v over its range in registers; the ranges' fp32 parts are summed in
//   rank order through distributed shared memory (rect_hopper.cuh
//   cluster_sum). Pass B reads the k tiles again, mostly from L2: keeping
//   them resident between the passes took more shared memory than it
//   saved (fewer blocks a SM, PERF.md). The ring holds two stages of a k
//   and a v tile (~43 KB a block at D <= 64: four blocks a SM).
// Every sum runs in a fixed order: the outputs are the same bits from call
// to call. One instance per head width D = 32, 48, 64 and 128; the WMMA
// body (csrc/induced_attention_wmma.cu) takes the others, and operands
// whose heads are not adjacent in memory (induced_attention.py
// _rect_fwd_body).
#include <cmath>

#include "rect_hopper.cuh"

using namespace gecco::hopper;
using namespace gecco::rect;

namespace {

constexpr int kUnpoolStages = 4;
constexpr int kPoolStages = 2;

// Shared memory of a forward block, in bytes from a 1024-aligned base:
// the short side's tiles (the unpool: k and v; the pool: q), the ring's
// stages (the unpool: a q tile; the pool: a k and a v tile), the pool's
// (m, l) [2][64] and the ring's barriers. The pool's cluster sum reuses
// the ring. induced_attention.py _rect_fwd_smem repeats this: change both
// together.
template <int D, bool kPool>
struct FwdSmem {
  static constexpr int TB = panels<D>() * kPanel;
  static constexpr int kStages = kPool ? kPoolStages : kUnpoolStages;
  static constexpr int kStage = kPool ? 2 * TB : TB;
  static constexpr int ring = (kPool ? 1 : 2) * TB;
  static constexpr int ml = ring + kStages * kStage;
  static constexpr int bars = ml + 2 * kT * 4;
  static constexpr int total = bars + kStages * 8 + 1024;  // + alignment slack
};

// The pool's logits of one k tile (keys k0 ... k0 + 63) against the
// resident q tile, scaled, the keys from N on at -inf.
template <int D>
__device__ __forceinline__ void pool_logits(float (&sacc)[32], const unsigned char* qs,
                                            const unsigned char* kt, int k0, int N, float scale) {
  const int col = 2 * (threadIdx.x % 4);
  wgmma_fence();
  tile_logits<D>(sacc, qs, kt);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = k0 + 8 * g + col + e < N;
      sacc[4 * g + e] = ok ? sacc[4 * g + e] * scale : -INFINITY;
      sacc[4 * g + 2 + e] = ok ? sacc[4 * g + 2 + e] * scale : -INFINITY;
    }
  }
}

template <int D, bool kPool>
__global__ void __launch_bounds__(kBlock)
rect_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b, Op res, Op res2,
                       bf16* __restrict__ o, int osb, int osh, int osr, float* __restrict__ lse,
                       int H, int M, int N, int tpb, float scale) {
  using L = FwdSmem<D, kPool>;
  constexpr int TB = L::TB, S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * tpb;
  const int nt = max(0, min(((kPool ? N : M) + kT - 1) / kT, t0 + tpb) - t0);
  const int items = kPool ? 2 * nt : nt;  // the pool's passes A and B
  auto stage = [&](int s) { return smem + L::ring + s * L::kStage; };
  // item it into its stage: the unpool's q tile t0 + it; the pool's k tile
  // (pass A), or k and v tiles (pass B), t0 + it % nt
  auto load = [&](int it) {
    const int s = it % S;
    if constexpr (kPool) {
      const bool with_v = it >= nt;
      const int row0 = (t0 + it % nt) * kT;
      bar_expect(full + s, with_v ? 2 * TB : TB);
      load_head_tile<D>(stage(s), &tm_a, full + s, b, h, row0);
      if (with_v) load_head_tile<D>(stage(s) + TB, &tm_b, full + s, b, h, row0);
    } else {
      bar_expect(full + s, TB);
      load_head_tile<D>(stage(s), &tm_a, full + s, b, h, (t0 + it) * kT);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int it = 0; it < S && it < items; ++it) load(it);
  }
  // the short side, staged once (the pool's q may have a zero batch stride)
  if constexpr (kPool) {
    stage_head_tile<D>(smem, res.at(b, h), res.sr, M);
  } else {
    stage_head_tile<D>(smem, res.at(b, h), res.sr, N);
    stage_head_tile<D>(smem + TB, res2.at(b, h), res2.sr, N);
  }
  fence_async_smem();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4;  // the thread's rows r and r + 8
  const int col = 2 * (lane % 4);                    // its first column of each 8
  bf16* o_bh = o + (long long)b * osb + (long long)h * osh;
  float* lse_bh = lse + ((long long)b * H + h) * M;
  if constexpr (!kPool) {
    const unsigned char* ks = smem;
    const unsigned char* vs = smem + TB;
    for (int it = 0; it < nt; ++it) {
      const int s = it % S;
      bar_wait(full + s, (it / S) & 1);
      float sacc[32];
      wgmma_fence();
      tile_logits<D>(sacc, stage(s), ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      named_sync(1, kBlock);  // every warp is done with stage s
      if (threadIdx.x == 0 && it + S < nt) load(it + S);
      // the softmax of rows r and r + 8 over the N <= 64 keys
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = 8 * g + col + e < N;
          sacc[4 * g + e] = ok ? sacc[4 * g + e] * scale : -INFINITY;
          sacc[4 * g + 2 + e] = ok ? sacc[4 * g + 2 + e] * scale : -INFINITY;
          m0 = fmaxf(m0, sacc[4 * g + e]);
          m1 = fmaxf(m1, sacc[4 * g + 2 + e]);
        }
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * g + e] = expf(sacc[4 * g + e] - m0);
          sacc[4 * g + 2 + e] = expf(sacc[4 * g + 2 + e] - m1);
          l0 += sacc[4 * g + e];
          l1 += sacc[4 * g + 2 + e];
        }
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * g + e] /= l0;
          sacc[4 * g + 2 + e] /= l1;
        }
      }
      uint32_t pa[16];
      pack_bf16(sacc, pa);
      float oacc[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_t(oacc, kstep(pa, kk), desc_mn(vs + kk * 2048, kPanel), kk != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      const int row0 = (t0 + it) * kT;
      store_rows<D>(o_bh, osr, oacc, 0, row0, M, 1.0f);
      if (lane % 4 == 0) {
        if (row0 + r < M) lse_bh[row0 + r] = m0 + logf(l0);
        if (row0 + r + 8 < M) lse_bh[row0 + r + 8] = m1 + logf(l1);
      }
    }
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const unsigned char* qs = smem;
    // pass A: the rows' running max and sum over the block's key tiles
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int it = 0; it < nt; ++it) {
      const int s = it % S;
      bar_wait(full + s, (it / S) & 1);
      float sacc[32];
      pool_logits<D>(sacc, qs, stage(s), (t0 + it) * kT, N, scale);
      named_sync(1, kBlock);
      if (threadIdx.x == 0 && it + S < items) load(it + S);
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          c0 = fmaxf(c0, sacc[4 * q + e]);
          c1 = fmaxf(c1, sacc[4 * q + 2 + e]);
        }
      }
      const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s0 += expf(sacc[4 * q + e] - n0);
          s1 += expf(sacc[4 * q + 2 + e] - n1);
        }
      }
      // a tile holds a key below N: n0 and n1 are finite
      l0 = l0 * expf(m0 - n0) + quad_sum(s0);
      l1 = l1 * expf(m1 - n1) + quad_sum(s1);
      m0 = n0;
      m1 = n1;
    }
    // the cluster's ranges merged in rank order (a range without tiles
    // adds exp(-inf) * 0)
    float* ml = reinterpret_cast<float*>(smem + L::ml);
    if (lane % 4 == 0) {
      ml[r] = m0;
      ml[r + 8] = m1;
      ml[kT + r] = l0;
      ml[kT + r + 8] = l1;
    }
    cl.sync();
    const int nb = (int)cl.num_blocks();
    float M0 = -INFINITY, M1 = -INFINITY;
    for (int j = 0; j < nb; ++j) {
      const float* other = cl.map_shared_rank(ml, j);
      M0 = fmaxf(M0, other[r]);
      M1 = fmaxf(M1, other[r + 8]);
    }
    float L0 = 0.0f, L1 = 0.0f;
    for (int j = 0; j < nb; ++j) {
      const float* other = cl.map_shared_rank(ml, j);
      L0 += other[kT + r] * expf(other[r] - M0);
      L1 += other[kT + r + 8] * expf(other[r + 8] - M1);
    }
    // pass B: p = bf16(exp(s - M) / L), o += p @ v over the block's tiles
    float oacc[D / 2];
    zero(oacc);
    for (int it = nt; it < items; ++it) {
      const int s = it % S;
      bar_wait(full + s, (it / S) & 1);
      const unsigned char* vt = stage(s) + TB;
      float sacc[32];
      pool_logits<D>(sacc, qs, stage(s), (t0 + it - nt) * kT, N, scale);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * q + e] = expf(sacc[4 * q + e] - M0) / L0;
          sacc[4 * q + 2 + e] = expf(sacc[4 * q + 2 + e] - M1) / L1;
        }
      }
      uint32_t pa[16];
      pack_bf16(sacc, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_t(oacc, kstep(pa, kk), desc_mn(vt + kk * 2048, kPanel), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      named_sync(1, kBlock);  // every warp is done with stage s
      if (threadIdx.x == 0 && it + S < items) load(it + S);
    }
    // o: the ranges' parts summed in rank order (the ring's bytes reused:
    // every item is consumed); lse from the first block
    cluster_sum(oacc, reinterpret_cast<float*>(smem + L::ring),
                [&](int row, int c, float v0, float v1) {
                  if (row < M) {
                    *reinterpret_cast<__nv_bfloat162*>(o_bh + (long long)row * osr + c) =
                        __floats2bfloat162_rn(v0, v1);
                  }
                });
    if (blockIdx.x == 0 && lane % 4 == 0) {
      if (r < M) lse_bh[r] = M0 + logf(L0);
      if (r + 8 < M) lse_bh[r + 8] = M1 + logf(L1);
    }
  }
}

template <int D, bool kPool>
cudaError_t launch_fwd(const CUtensorMap& ta, const CUtensorMap& tb, Op res, Op res2, void* o,
                       int osb, int osh, int osr, void* lse, int B, int H, int M, int N,
                       cudaStream_t st) {
  using L = FwdSmem<D, kPool>;
  const auto kernel = rect_fwd_hopper_kernel<D, kPool>;
  cudaError_t err = allow_smem((const void*)kernel, L::total);
  if (err != cudaSuccess) return err;
  const Plan plan(((kPool ? N : M) + kT - 1) / kT, kPool);
  // 1/sqrt(D), rounded once from double, as the JAX package's Python float
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.r, H, B);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = L::total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kPool ? plan.r : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ta, tb, res, res2, (bf16*)o, osb, osh, osr,
                            (float*)lse, H, M, N, plan.tpb, scale);
}

template <int D>
cudaError_t launch_width(const Op& q, const Op& k, const Op& v, void* o, int osb, int osh,
                         int osr, void* lse, int B, int H, int M, int N, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (N > kT) {
    if (encode_heads(&ta, k, B, H, N, D) != CUDA_SUCCESS ||
        encode_heads(&tb, v, B, H, N, D) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
    return launch_fwd<D, true>(ta, tb, q, q, o, osb, osh, osr, lse, B, H, M, N, st);
  }
  if (encode_heads(&ta, q, B, H, M, D) != CUDA_SUCCESS) return cudaErrorInvalidValue;
  return launch_fwd<D, false>(ta, ta, k, v, o, osb, osh, osr, lse, B, H, M, N, st);
}

}  // namespace

// q [B, H, M, D], k/v [B, H, N, D] through their strides, M <= 64 (the
// pool direction, N > 64) or N <= 64 (the unpool direction); the long
// side's operands with adjacent heads (rect_hopper.cuh tma_ok), the short
// side's staged by threads (staged_ok); o [B, H, M, D] through its
// strides, lse [B, H, M] contiguous. D one of 32, 48, 64 and 128.
extern "C" int rect_attention_fwd_hopper_launch(const void* q, const void* k, const void* v,
                                                void* o, void* lse, int qsb, int qsh, int qsr,
                                                int ksb, int ksh, int ksr, int vsb, int vsh,
                                                int vsr, int osb, int osh, int osr, int B, int H,
                                                int M, int N, int D, void* stream) {
  const Op qo{(const bf16*)q, qsb, qsh, qsr}, ko{(const bf16*)k, ksb, ksh, ksr},
      vo{(const bf16*)v, vsb, vsh, vsr};
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || H < 1 || M < 1 || N < 1 || (M > kT && N > kT)) return (int)cudaErrorInvalidValue;
  const bool pool = N > kT;
  if (pool ? !(staged_ok(qo) && tma_ok(ko, D) && tma_ok(vo, D))
           : !(tma_ok(qo, D) && staged_ok(ko) && staged_ok(vo))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
    case 32: return (int)launch_width<32>(qo, ko, vo, o, osb, osh, osr, lse, B, H, M, N, st);
    case 48: return (int)launch_width<48>(qo, ko, vo, o, osb, osh, osr, lse, B, H, M, N, st);
    case 64: return (int)launch_width<64>(qo, ko, vo, o, osb, osh, osr, lse, B, H, M, N, st);
    case 128: return (int)launch_width<128>(qo, ko, vo, o, osb, osh, osr, lse, B, H, M, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
