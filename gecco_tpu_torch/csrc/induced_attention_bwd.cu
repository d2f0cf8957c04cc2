// Per-head rectangular attention backward: the Hopper body (TMA, wgmma
// with register accumulators).
//
// Replaces gecco_tpu/ops/pallas/induced_attention.py:_bwd_kernel (served by
// rect_attention_pallas's custom_vjp through _backward_impl). Per (batch b,
// head h), from the forward's lse [M] and, with g the cotangent of o in
// bf16, s = q k^T / sqrt(D):
//   delta = sum_d f32(g) f32(o)  (formed here from the bf16 tiles; where g
//           came in another dtype the wrapper forms it from that g, as the
//           JAX package forms it outside its kernel, and passes it in)
//   p = exp(s - lse);  dp = g v^T;  ds = p (dp - delta)        (fp32)
//   dq = bf16(ds) k / sqrt(D);  dk = bf16(ds)^T q / sqrt(D);  dv = bf16(p)^T g
//
// Bound on the H100: device memory, as the forward (10 M N D tensor-core
// operations against the bytes of q, k, v, o, g and the three gradients).
//
// Design: as the forward (csrc/induced_attention.cu), the side of at most
// 64 rows resident in shared memory, the long side's 64-row tiles of one
// head through a TMA ring, one warpgroup a block over a range of tiles of
// one (b, h). Every tile pair is worked key-major: s^T = k q^T and dp^T =
// v g^T (m64n64, K = D) in registers, p^T and ds^T formed there and rounded
// to bf16; dv = p^T g and dk = ds^T q take them as the register operand
// against the query side's tiles read MN-major (N = D); dq = ds k reads ds
// from shared memory (written there transposed, K-major) against the key
// tile read MN-major.
// - The unpool direction (N <= 64 keys): k and v resident, the q, g and o
//   tiles streamed; delta and lse of each query tile staged in shared
//   memory; dq written per tile from the registers (in 64-column parts at
//   D 128); dk and dv accumulated in registers over the block's range.
// - The pool direction (M <= 64 queries): q, g and o resident (q may have
//   a zero batch stride: the inducers), delta and lse formed once; the k
//   and v tiles streamed; dk and dv written per tile from the registers;
//   dq accumulated in registers over the block's range.
// The ranges' fp32 parts of the accumulated gradients are summed in rank
// order over the blocks of one (b, h), a cluster of up to 8, through
// distributed shared memory (rect_hopper.cuh cluster_sum): no atomics, no
// zeroed buffer, no rounding pass; the outputs are the same bits from call
// to call. One instance per head width D = 32, 48, 64 and 128; the WMMA
// body (csrc/induced_attention_bwd_wmma.cu) takes the others, and operands
// whose heads are not adjacent in memory (induced_attention.py
// _rect_bwd_body).
#include <cmath>

#include "rect_hopper.cuh"

using namespace gecco::hopper;
using namespace gecco::rect;

namespace {

// Shared memory of a backward block, in bytes from a 1024-aligned base:
// the short side's tiles (the unpool: k, v; the pool: q, g, o), ds [64
// queries, 64 keys] (one panel), the ring's stages (the unpool: q, g and o
// tiles; the pool: k and v tiles), lse and delta [2][64] fp32 and the
// ring's barriers. The cluster sums reuse the ring. induced_attention.py
// _rect_bwd_smem repeats this: change both together.
template <int D, bool kPool>
struct BwdSmem {
  static constexpr int TB = panels<D>() * kPanel;
  static constexpr int kStages = panels<D>() == 1 ? 3 : 2;
  static constexpr int kStage = (kPool ? 2 : 3) * TB;
  static constexpr int dss = (kPool ? 3 : 2) * TB;
  static constexpr int ring = dss + kPanel;
  static constexpr int vec = ring + kStages * kStage;
  static constexpr int bars = vec + 2 * kT * 4;
  static constexpr int total = bars + kStages * 8 + 1024;  // + alignment slack
};

// lse and delta of queries q0 ... q0 + 63 of (b, h) (0 from M on) into
// shared memory, delta from the g and o tiles unless given (delta_in);
// then the values of the thread's sixteen query columns into registers.
template <int D>
__device__ __forceinline__ void query_vectors(float (&lse_c)[16], float (&delta_c)[16],
                                              float* lse_s, float* delta_s,
                                              const unsigned char* gt, const unsigned char* ot,
                                              const float* lse, const float* delta_in,
                                              long long bh, int q0, int M) {
  if (delta_in == nullptr) {
    tile_delta<D>(gt, ot, delta_s);
  } else if (threadIdx.x < kT) {
    delta_s[threadIdx.x] = q0 + threadIdx.x < M ? delta_in[bh * M + q0 + threadIdx.x] : 0.0f;
  }
  if (threadIdx.x < kT) {
    lse_s[threadIdx.x] = q0 + threadIdx.x < M ? lse[bh * M + q0 + threadIdx.x] : 0.0f;
  }
  named_sync(1, kBlock);
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lse_c[2 * g + e] = lse_s[8 * g + col + e];
      delta_c[2 * g + e] = delta_s[8 * g + col + e];
    }
  }
}

// One tile pair, key-major: s^T = k q^T and dp^T = v g^T; p^T = exp(s^T -
// lse) and ds^T = p^T (dp^T - delta), 0 for keys from N on (k0: the key
// tile's first) and queries from M on (q0: the query tile's); both packed
// as bf16 register operands (pa, da), and ds into dss as [queries, keys]
// (K-major). Ends with a block barrier (ds in place).
template <int D>
__device__ __forceinline__ void tile_pds(uint32_t (&pa)[16], uint32_t (&da)[16],
                                         unsigned char* dss, const unsigned char* kt,
                                         const unsigned char* vt, const unsigned char* qt,
                                         const unsigned char* gt, const float (&lse_c)[16],
                                         const float (&delta_c)[16], int k0, int N, int q0, int M,
                                         float scale) {
  const int lane = threadIdx.x % 32, r = (threadIdx.x / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  float st[32], dpt[32];
  wgmma_fence();
  tile_logits<D>(st, kt, qt);
  tile_logits<D>(dpt, vt, gt);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  const bool k0ok = k0 + r < N, k1ok = k0 + r + 8 < N;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * g + col + e;
      const bool qok = q0 + c < M;
      const float lc = lse_c[2 * g + e], dc = delta_c[2 * g + e];
      const float p0 = k0ok && qok ? expf(st[4 * g + e] * scale - lc) : 0.0f;
      const float p1 = k1ok && qok ? expf(st[4 * g + 2 + e] * scale - lc) : 0.0f;
      st[4 * g + e] = p0;
      st[4 * g + 2 + e] = p1;
      dpt[4 * g + e] = p0 * (dpt[4 * g + e] - dc);
      dpt[4 * g + 2 + e] = p1 * (dpt[4 * g + 2 + e] - dc);
      *reinterpret_cast<bf16*>(dss + swz(c, r, kPanel)) = __float2bfloat16(dpt[4 * g + e]);
      *reinterpret_cast<bf16*>(dss + swz(c, r + 8, kPanel)) = __float2bfloat16(dpt[4 * g + 2 + e]);
    }
  }
  pack_bf16(st, pa);
  pack_bf16(dpt, da);
  fence_async_smem();
  named_sync(1, kBlock);
}

template <int D, bool kPool>
__global__ void __launch_bounds__(kBlock)
rect_bwd_hopper_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c, Op ra, Op rb, Op rc,
                       const float* __restrict__ lse, const float* __restrict__ delta_in,
                       bf16* __restrict__ dq, int dqsb, int dqsh, int dqsr, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int dksb, int dksh, int dksr, int H, int M, int N,
                       int tpb, float scale) {
  using L = BwdSmem<D, kPool>;
  constexpr int TB = L::TB, S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  unsigned char* dss = smem + L::dss;
  float* lse_s = reinterpret_cast<float*>(smem + L::vec);
  float* delta_s = lse_s + kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * tpb;
  const int nt = max(0, min(((kPool ? N : M) + kT - 1) / kT, t0 + tpb) - t0);
  auto stage = [&](int s) { return smem + L::ring + s * L::kStage; };
  // tile t0 + it of the long side into its stage: the pool's k and v, the
  // unpool's q, g and o
  auto load = [&](int it) {
    const int s = it % S, row0 = (t0 + it) * kT;
    bar_expect(full + s, L::kStage);
    load_head_tile<D>(stage(s), &tm_a, full + s, b, h, row0);
    load_head_tile<D>(stage(s) + TB, &tm_b, full + s, b, h, row0);
    if constexpr (!kPool) load_head_tile<D>(stage(s) + 2 * TB, &tm_c, full + s, b, h, row0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int it = 0; it < S && it < nt; ++it) load(it);
  }
  if constexpr (kPool) {
    stage_head_tile<D>(smem, ra.at(b, h), ra.sr, M);
    stage_head_tile<D>(smem + TB, rb.at(b, h), rb.sr, M);
    stage_head_tile<D>(smem + 2 * TB, rc.at(b, h), rc.sr, M);
  } else {
    stage_head_tile<D>(smem, ra.at(b, h), ra.sr, N);
    stage_head_tile<D>(smem + TB, rb.at(b, h), rb.sr, N);
  }
  fence_async_smem();
  __syncthreads();

  const long long bh = (long long)b * H + h;
  float lse_c[16], delta_c[16];
  uint32_t pa[16], da[16];
  bf16* dq_bh = dq + (long long)b * dqsb + (long long)h * dqsh;
  bf16* dk_bh = dk + (long long)b * dksb + (long long)h * dksh;
  bf16* dv_bh = dv + (long long)b * dksb + (long long)h * dksh;
  float* red = reinterpret_cast<float*>(smem + L::ring);  // the cluster sums' buffer

  if constexpr (!kPool) {
    const unsigned char* ks = smem;
    const unsigned char* vs = smem + TB;
    constexpr int NC = D < 64 ? D : 64;  // dq's columns a product
    float dkacc[D / 2], dvacc[D / 2];
    zero(dkacc);
    zero(dvacc);
    for (int it = 0; it < nt; ++it) {
      const int s = it % S, q0 = (t0 + it) * kT;
      bar_wait(full + s, (it / S) & 1);
      const unsigned char* qt = stage(s);
      const unsigned char* gt = qt + TB;
      query_vectors<D>(lse_c, delta_c, lse_s, delta_s, gt, qt + 2 * TB, lse, delta_in, bh, q0, M);
      tile_pds<D>(pa, da, dss, ks, vs, qt, gt, lse_c, delta_c, 0, N, q0, M, scale);
      // dv += p^T g and dk += ds^T q, the query tiles MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_t(dvacc, kstep(pa, kk), desc_mn(gt + kk * 2048, kPanel), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_t(dkacc, kstep(da, kk), desc_mn(qt + kk * 2048, kPanel), 1);
      }
      wgmma_commit();
      // the tile's dq = ds k, by 64-column parts of the key tile
#pragma unroll
      for (int p = 0; p < D / NC; ++p) {
        float dqc[NC / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tt<0, 1>(dqc, desc(dss) + 2 * kk, desc_mn(ks + p * kPanel + kk * 2048, kPanel),
                         kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqc);
        store_rows<NC>(dq_bh, dqsr, dqc, p * NC, q0, M, scale);
      }
      fence_regs(dkacc);
      fence_regs(dvacc);
      named_sync(1, kBlock);  // every warp is done with stage s, dss and the vectors
      if (threadIdx.x == 0 && it + S < nt) load(it + S);
    }
    cluster_sum(dkacc, red, [&](int row, int c, float v0, float v1) {
      if (row < N) {
        *reinterpret_cast<__nv_bfloat162*>(dk_bh + (long long)row * dksr + c) =
            __floats2bfloat162_rn(scale * v0, scale * v1);
      }
    });
    cluster_sum(dvacc, red, [&](int row, int c, float v0, float v1) {
      if (row < N) {
        *reinterpret_cast<__nv_bfloat162*>(dv_bh + (long long)row * dksr + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    });
  } else {
    const unsigned char* qs = smem;
    const unsigned char* gs = smem + TB;
    query_vectors<D>(lse_c, delta_c, lse_s, delta_s, gs, smem + 2 * TB, lse, delta_in, bh, 0, M);
    float dqacc[D / 2];
    zero(dqacc);
    for (int it = 0; it < nt; ++it) {
      const int s = it % S, k0 = (t0 + it) * kT;
      bar_wait(full + s, (it / S) & 1);
      const unsigned char* kt = stage(s);
      tile_pds<D>(pa, da, dss, kt, kt + TB, qs, gs, lse_c, delta_c, k0, N, 0, M, scale);
      // the tile's dv = p^T g and dk = ds^T q, the query tiles MN-major
      {
        float acc[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_t(acc, kstep(pa, kk), desc_mn(gs + kk * 2048, kPanel), kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        store_rows<D>(dv_bh, dksr, acc, 0, k0, N, 1.0f);
      }
      {
        float acc[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_t(acc, kstep(da, kk), desc_mn(qs + kk * 2048, kPanel), kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        store_rows<D>(dk_bh, dksr, acc, 0, k0, N, scale);
      }
      // dq += ds k, the key tile MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tt<0, 1>(dqacc, desc(dss) + 2 * kk, desc_mn(kt + kk * 2048, kPanel), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqacc);
      named_sync(1, kBlock);  // every warp is done with stage s and dss
      if (threadIdx.x == 0 && it + S < nt) load(it + S);
    }
    cluster_sum(dqacc, red, [&](int row, int c, float v0, float v1) {
      if (row < M) {
        *reinterpret_cast<__nv_bfloat162*>(dq_bh + (long long)row * dqsr + c) =
            __floats2bfloat162_rn(scale * v0, scale * v1);
      }
    });
  }
}

template <int D, bool kPool>
cudaError_t launch_bwd(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
                       const Op& ra, const Op& rb, const Op& rc, const void* lse,
                       const void* delta, void* dq, int dqsb, int dqsh, int dqsr, void* dk,
                       void* dv, int dksb, int dksh, int dksr, int B, int H, int M, int N,
                       cudaStream_t st) {
  using L = BwdSmem<D, kPool>;
  const auto kernel = rect_bwd_hopper_kernel<D, kPool>;
  cudaError_t err = allow_smem((const void*)kernel, L::total);
  if (err != cudaSuccess) return err;
  const Plan plan(((kPool ? N : M) + kT - 1) / kT, true);
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.r, H, B);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = L::total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.r;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ta, tb, tc, ra, rb, rc, (const float*)lse,
                            (const float*)delta, (bf16*)dq, dqsb, dqsh, dqsr, (bf16*)dk,
                            (bf16*)dv, dksb, dksh, dksr, H, M, N, plan.tpb, scale);
}

template <int D>
cudaError_t launch_width(const Op& q, const Op& k, const Op& v, const Op& g, const Op& o,
                         const void* lse, const void* delta, void* dq, int dqsb, int dqsh,
                         int dqsr, void* dk, void* dv, int dksb, int dksh, int dksr, int B, int H,
                         int M, int N, cudaStream_t st) {
  CUtensorMap ta, tb, tc;
  if (N > kT) {
    if (encode_heads(&ta, k, B, H, N, D) != CUDA_SUCCESS ||
        encode_heads(&tb, v, B, H, N, D) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
    return launch_bwd<D, true>(ta, tb, ta, q, g, o, lse, delta, dq, dqsb, dqsh, dqsr, dk, dv,
                               dksb, dksh, dksr, B, H, M, N, st);
  }
  if (encode_heads(&ta, q, B, H, M, D) != CUDA_SUCCESS ||
      encode_heads(&tb, g, B, H, M, D) != CUDA_SUCCESS ||
      encode_heads(&tc, o, B, H, M, D) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  return launch_bwd<D, false>(ta, tb, tc, k, v, k, lse, delta, dq, dqsb, dqsh, dqsr, dk, dv,
                              dksb, dksh, dksr, B, H, M, N, st);
}

}  // namespace

// q [B, H, M, D], k/v [B, H, N, D], g and o [B, H, M, D] (bf16) through
// their strides, M <= 64 (the pool direction, N > 64) or N <= 64 (the
// unpool direction); the long side's operands with adjacent heads
// (rect_hopper.cuh tma_ok), the short side's staged by threads
// (staged_ok). lse [B, H, M] fp32 contiguous; delta [B, H, M] fp32
// contiguous, or null to form it from g and o. dq [B, H, M, D] and dk, dv
// [B, H, N, D] (dk and dv sharing strides) written whole. D one of 32,
// 48, 64 and 128.
extern "C" int rect_attention_bwd_hopper_launch(
    const void* q, const void* k, const void* v, const void* g, const void* o, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int qsb, int qsh, int qsr, int ksb, int ksh,
    int ksr, int vsb, int vsh, int vsr, int gsb, int gsh, int gsr, int osb, int osh, int osr,
    int dqsb, int dqsh, int dqsr, int dksb, int dksh, int dksr, int B, int H, int M, int N, int D,
    void* stream) {
  const Op qo{(const bf16*)q, qsb, qsh, qsr}, ko{(const bf16*)k, ksb, ksh, ksr},
      vo{(const bf16*)v, vsb, vsh, vsr}, go{(const bf16*)g, gsb, gsh, gsr},
      oo{(const bf16*)o, osb, osh, osr};
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || H < 1 || M < 1 || N < 1 || (M > kT && N > kT)) return (int)cudaErrorInvalidValue;
  const bool pool = N > kT;
  if (pool ? !(staged_ok(qo) && staged_ok(go) && staged_ok(oo) && tma_ok(ko, D) && tma_ok(vo, D))
           : !(tma_ok(qo, D) && tma_ok(go, D) && tma_ok(oo, D) && staged_ok(ko) &&
               staged_ok(vo))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
    case 32:
      return (int)launch_width<32>(qo, ko, vo, go, oo, lse, delta, dq, dqsb, dqsh, dqsr, dk, dv,
                                    dksb, dksh, dksr, B, H, M, N, st);
    case 48:
      return (int)launch_width<48>(qo, ko, vo, go, oo, lse, delta, dq, dqsb, dqsh, dqsr, dk, dv,
                                    dksb, dksh, dksr, B, H, M, N, st);
    case 64:
      return (int)launch_width<64>(qo, ko, vo, go, oo, lse, delta, dq, dqsb, dqsh, dqsr, dk, dv,
                                    dksb, dksh, dksr, B, H, M, N, st);
    case 128:
      return (int)launch_width<128>(qo, ko, vo, go, oo, lse, delta, dq, dqsb, dqsh, dqsr, dk, dv,
                                    dksb, dksh, dksr, B, H, M, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
