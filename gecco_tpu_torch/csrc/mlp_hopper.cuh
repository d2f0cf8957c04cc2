// The Hopper MLP (csrc/mlp.cu forward, csrc/mlp_bwd.cu backward): each
// product of the pre-norm + Gaussian MLP + residual is one pass over the
// B * N rows, a row-block x column-tile GEMM with the function's
// element-wise algebra fused into its epilogue; the [B * N, W] hidden
// planes go through device memory in bf16 (the roundings the TPU kernels
// apply to them anyway) between the passes.
//
// Why passes and not one fused walk per point tile (the WMMA bodies and the
// TPU kernels): a fused walk keeps a [64, C] fp32 accumulator per tile
// across all of W (192 registers a thread at C 384 for one warpgroup) and
// streams both weights through shared memory once per 64 rows (1.2 MB a
// tile at the flagship: ~2 GB of L2 reads a call). Here a block owns a
// [128, BN] output tile and reads a [128, 64] panel of A and a [64, BN]
// panel of B per step of depth 64: 100 FLOP per byte of shared memory
// filled, the weights read (N / BN) x (B * N / 128) times from L2 as
// 64-column panels, and the hidden planes cost 2 bytes per element each way
// in device memory (~0.2 ms at the flagship's B 48, against ~0.35 ms of
// products).
//
// One kernel body, mlp_gemm: 256 threads, two consumer warpgroups, each
// the 64 rows m = 64 w .. 64 w + 63 of the block's 128 and all BN columns
// (a [64, BN] fp32 accumulator in registers). A [M, K] bf16 row-major comes
// by TMA as two 64 x 64 panels a step; B as the BN x 64 panel a step in
// either layout: MN-major (TB = 1, B stored [K, N] row-major, read by
// wgmma transposed, hopper.cuh desc_mn) or K-major (TB = 0, B stored
// [N, K]). A STAGES-deep ring with a full barrier (TMA bytes) and an empty
// barrier (one arrival per warpgroup) per stage; thread 0 refills a stage
// once both warpgroups have released it, one wgmma group kept in flight. The
// dual form (the backward's dh pass) runs two products of one depth into
// two accumulators from two rings of operands. With K2 > 0 a single product
// runs on past depth K into a second pair of operands (A2 [M, K2], B2 of
// depth K2, B2 in B's layout): acc = A B + A2 B2 (csrc/pool_ext_bwd_twopass.cu's
// dy = ds qf^T + dv Wv).
//
// Epilogues (EPI), on the accumulators in registers:
//   kAct  a = bf16(exp(-h^2 / 2)), h = acc + b1                    -> out
//   kOut  o = (acc + b2) + x; out = bf16(o); column sums of o, o^2
//   kGrad o = (acc + b2) + x; g' = g + gs1 + 2 o gs2; bf16(g') -> out,
//         g' fp32 -> gp; column sums of g'
//   kDh   h = acc + b1, a = exp(-h^2 / 2), dh = acc2 * a * (-h);
//         bf16(dh) -> out; column sums of dh
//   kDx   dy = acc; dx = bf16(g' + dy * se) (g' 0 where gp is null); column
//         sums of dy * x, dy
//   kF32  acc -> gp (fp32), no sums (the two-pass pool backward's logits)
//   kDy   dy = acc (the resident pool backward's, csrc/pool_bwd.cu): with
//         gp, fp32 dy -> gp and column sums of dy * (x - mean), dy; without,
//         bf16(dy) -> out and no sums
// A ragged point count comes zero-padded to the 128-row block by the
// wrapper: kOut leaves the padding rows (a batch element's rows from
// n_valid on) out of its sums and kGrad gives them no share of the sums'
// cotangent, so their g' is the padded g, zero, and every later sum and
// weight gradient takes nothing from them.
// and for the h-side (csrc/hside.cu), on its [B I, .] token rows:
//   kHOut hh = acc + b2 -> gp (fp32); each warp's 16-row sums of hh, hh^2
//   kKV   bf16(acc) -> out (columns < split) or out2 (the rest), each of
//         row stride split; B from tm_b or tm_b2 likewise ([Wk; Wv] apart)
// Column sums are fixed-order: a block sums its 128 rows (the thread's two
// rows, shuffles over a warp's rows, then the eight warps in order) into
// part[row block, sum, column]; mlp_colsum_kernel adds the row blocks in
// order (kHOut writes each warp's 16 rows' sums, part[row / 16, sum,
// column], for its caller to add per token set). Every output is the same
// bits from call to call.
#pragma once

#include "backward.cuh"
#include "hopper.cuh"

namespace gecco {
namespace mlp {

constexpr int kRows = 128;           // rows of a block: two warpgroups of 64
constexpr int kGemmThreads = 256;
constexpr int kPanel = 64 * 128;     // one 64 x 64 bf16 panel, 128-byte swizzled
constexpr int kBnWide = 192;         // column tile of the single products
constexpr int kBnDual = 128;         // column tile of the dual product
constexpr int kStagesWide = 4;
constexpr int kStagesDual = 3;
// The single products at C or W not a multiple of 384 (the upsample demo's
// C 128, W 256): 128-column tiles, a two-stage ring (the depth is 2 or 4
// steps of 64 there, so a deeper ring never fills) and two blocks a SM, so
// one block's epilogue runs beside the other's products.
constexpr int kBnNarrow = 128;
constexpr int kStagesNarrow = 2;
constexpr int kBlocksNarrow = 2;

enum Epi { kAct = 0, kOut = 1, kGrad = 2, kDh = 3, kDx = 4, kHOut = 5, kKV = 6, kF32 = 7,
           kDy = 8 };

__host__ __device__ constexpr int epi_sums(int epi) {
  return epi == kOut || epi == kDx || epi == kDy ? 2 : (epi == kGrad || epi == kDh ? 1 : 0);
}

// What an epilogue reads and writes; unused pointers are null.
struct MlpEpi {
  int K;              // depth of the product(s), a multiple of 64
  int N;              // output columns: the row stride of every [M, N] array below
  int rows_b;         // rows of one batch element (its points), a multiple of kRows
  int n_valid;        // its points before the padding of a ragged tail (kOut, kGrad)
  const float* bias;  // [N]: b1 (kAct, kDh), b2 (kOut, kGrad)
  const bf16* x;      // [M, N]: the residual (kOut, kGrad), x of dse (kDx)
  const bf16* g;      // [M, N]: the output's cotangent (kGrad)
  const float* gs;    // [B, 2, N]: the sums' cotangent (kGrad)
  const float* se;    // [B, N] (kDx)
  const float* mean;  // [B, N]: the pre-norm's channel means (kDy)
  float* gp;          // [M, N] fp32 g' (written by kGrad, read by kDx), dy (kDy)
  bf16* out;          // [M, N]: a, out, bf16(g'), bf16(dh) or dx
  float* part;        // [M / kRows, sums, N]: the row blocks' column sums
                      // (kHOut: [M / 16, 2, N], each warp's 16 rows'; kDy
                      // without gp: null)
  int split;          // kKV: the columns of out; the rest go to out2
  bf16* out2;         // kKV: [M, N - split]
  int K2;             // depth of a second operand pair (A2, B2) after K; 0: none
};

// Shared memory of one instance, in bytes from a 1024-aligned base: the
// ring (per stage A [128, 64], B [BN, 64], and for the dual product A2 and
// B2 likewise), the column-sum buffer [sums][8 warps][BN] fp32, then the
// full and empty barriers.
template <int BN, int EPI, int STAGES>
struct GemmSmem {
  static constexpr int kA = 2 * kPanel;
  static constexpr int kB = BN * 128;
  static constexpr int kStage = (EPI == kDh ? 2 : 1) * (kA + kB);
  static constexpr int kRed = STAGES * kStage;
  static constexpr int kBars = kRed + epi_sums(EPI) * 8 * BN * 4;
  static constexpr int kTotal = kBars + 2 * STAGES * 8 + 1024;  // + alignment slack
};

// sum a value over the eight rows lane / 4 of a warp (fixed order)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One block: the [128, BN] output tile (blockIdx.x = column tile,
// blockIdx.y = row block) of A @ B (and A2 @ B2 for kDh), then the epilogue.
template <int BN, int TB, int EPI, int STAGES>
__device__ __forceinline__ void mlp_gemm(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                         const CUtensorMap* tm_a2, const CUtensorMap* tm_b2,
                                         const MlpEpi& e) {
  using namespace hopper;
  using L = GemmSmem<BN, EPI, STAGES>;
  constexpr bool kDual = EPI == kDh;
  constexpr int kSums = epi_sums(EPI);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * BN, rb = blockIdx.y, row0 = rb * kRows;
  const int steps = (e.K + e.K2) / 64;
  // kKV: the columns from split on are a second product, B from tm_b2
  const bool second = EPI == kKV && n0 >= e.split;
  const CUtensorMap* tm_b0 = second ? tm_b2 : tm_b;
  const int nb0 = second ? n0 - e.split : n0;
  auto stage = [&](int s) { return smem + s * L::kStage; };
  auto load = [&](int u) {
    const int s = u % STAGES;
    // past depth K (K2 > 0): the second operand pair
    const bool snd = u * 64 >= e.K;
    const int k0 = snd ? u * 64 - e.K : u * 64;
    unsigned char* st = stage(s);
    bar_expect(full + s, L::kStage);
#pragma unroll
    for (int op = 0; op < (kDual ? 2 : 1); ++op) {
      unsigned char* a = st + op * (L::kA + L::kB);
      unsigned char* b = a + L::kA;
      const CUtensorMap* ta = op || snd ? tm_a2 : tm_a;
      tma_load(a, ta, full + s, row0, k0);
      tma_load(a + kPanel, ta, full + s, row0 + 64, k0);
      if (op == 0 && TB) {
        // B [K, N] row-major: BN / 64 panels of 64 rows of K
        const CUtensorMap* tb = snd ? tm_b2 : tm_b;
#pragma unroll
        for (int p = 0; p < BN / 64; ++p) tma_load(b + p * kPanel, tb, full + s, k0, n0 + 64 * p);
      } else {
        // B [N, K] row-major: one box of BN rows
        tma_load(b, op || snd ? tm_b2 : tm_b0, full + s, op ? n0 : nb0, k0);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 0; u < STAGES && u < steps; ++u) load(u);
  }

  const int w = threadIdx.x / 128, t128 = threadIdx.x % 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4), r = (warp % 4) * 16 + lane / 4;
  float acc[BN / 2];
  float acc2[kDual ? BN / 2 : 1];
  zero(acc);
  zero(acc2);
  for (int u = 0; u < steps; ++u) {
    const int s = u % STAGES;
    unsigned char* st = stage(s);
    bar_wait(full + s, (u / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(st + w * kPanel) + 2 * kk;
      if constexpr (TB) {
        wgmma_tt<0, 1>(acc, da, desc_mn(st + L::kA + kk * 2048, kPanel), 1);
      } else {
        wgmma_tt<0, 0>(acc, da, desc(st + L::kA) + 2 * kk, 1);
      }
      if constexpr (kDual) {
        unsigned char* st2 = st + L::kA + L::kB;
        wgmma_tt<0, 0>(acc2, desc(st2 + w * kPanel) + 2 * kk, desc(st2 + L::kA) + 2 * kk, 1);
      }
    }
    wgmma_commit();
    // the previous step's products are done: release its stage, and refill
    // it once both warpgroups have
    wgmma_wait<1>();
    if (u > 0) {
      const int sp = (u - 1) % STAGES;
      if (t128 == 0) bar_arrive(empty + sp);
      if (threadIdx.x == 0 && u - 1 + STAGES < steps) {
        bar_wait(empty + sp, ((u - 1) / STAGES) & 1);
        load(u - 1 + STAGES);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (kDual) fence_regs(acc2);

  // epilogue: thread rows r and r + 8 of the warpgroup's 64, columns
  // n0 + 8 gi + col + {0, 1}
  const size_t row = (size_t)row0 + 64 * w + r;
  const int bidx = row0 / e.rows_b;
  const int pt = (int)(row - (size_t)bidx * e.rows_b);  // the row's point in its element
  const bool ok0 = pt < e.n_valid, ok1 = pt + 8 < e.n_valid;
  float* red = reinterpret_cast<float*>(smem + L::kRed);  // [sums][8 warps][BN]
#pragma unroll
  for (int gi = 0; gi < BN / 8; ++gi) {
    const int c = n0 + 8 * gi + col;
    const size_t i0 = row * e.N + c, i1 = i0 + 8 * (size_t)e.N;
    const float v0 = acc[4 * gi], v1 = acc[4 * gi + 1], v2 = acc[4 * gi + 2],
                v3 = acc[4 * gi + 3];
    float s0[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f};
    if constexpr (EPI == kAct) {
      const float b0 = __ldg(e.bias + c), b1 = __ldg(e.bias + c + 1);
      const float h0 = v0 + b0, h1 = v1 + b1, h2 = v2 + b0, h3 = v3 + b1;
      st_bf2(e.out + i0, expf(-0.5f * h0 * h0), expf(-0.5f * h1 * h1));
      st_bf2(e.out + i1, expf(-0.5f * h2 * h2), expf(-0.5f * h3 * h3));
    } else if constexpr (EPI == kOut || EPI == kGrad) {
      const float b0 = __ldg(e.bias + c), b1 = __ldg(e.bias + c + 1);
      const float2 x0 = ld_bf2(e.x + i0), x1 = ld_bf2(e.x + i1);
      const float o0 = (v0 + b0) + x0.x, o1 = (v1 + b1) + x0.y;
      const float o2 = (v2 + b0) + x1.x, o3 = (v3 + b1) + x1.y;
      if constexpr (EPI == kOut) {
        st_bf2(e.out + i0, o0, o1);
        st_bf2(e.out + i1, o2, o3);
        const float u0 = ok0 ? o0 : 0.0f, u1 = ok0 ? o1 : 0.0f;
        const float u2 = ok1 ? o2 : 0.0f, u3 = ok1 ? o3 : 0.0f;
        s0[0] = u0 + u2;
        s0[1] = u1 + u3;
        s1[0] = u0 * u0 + u2 * u2;
        s1[1] = u1 * u1 + u3 * u3;
      } else {
        const float* gs1 = e.gs + (size_t)bidx * 2 * e.N;
        const float* gs2 = gs1 + e.N;
        const float a0 = __ldg(gs1 + c), a1 = __ldg(gs1 + c + 1);
        const float q0 = __ldg(gs2 + c), q1 = __ldg(gs2 + c + 1);
        const float2 g0 = ld_bf2(e.g + i0), g1 = ld_bf2(e.g + i1);
        const float p0 = ok0 ? g0.x + a0 + 2.0f * o0 * q0 : g0.x;
        const float p1 = ok0 ? g0.y + a1 + 2.0f * o1 * q1 : g0.y;
        const float p2 = ok1 ? g1.x + a0 + 2.0f * o2 * q0 : g1.x;
        const float p3 = ok1 ? g1.y + a1 + 2.0f * o3 * q1 : g1.y;
        st_bf2(e.out + i0, p0, p1);
        st_bf2(e.out + i1, p2, p3);
        *reinterpret_cast<float2*>(e.gp + i0) = make_float2(p0, p1);
        *reinterpret_cast<float2*>(e.gp + i1) = make_float2(p2, p3);
        s0[0] = p0 + p2;
        s0[1] = p1 + p3;
      }
    } else if constexpr (EPI == kDh) {
      const float b0 = __ldg(e.bias + c), b1 = __ldg(e.bias + c + 1);
      const float h0 = v0 + b0, h1 = v1 + b1, h2 = v2 + b0, h3 = v3 + b1;
      const float d0 = acc2[4 * gi] * expf(-0.5f * h0 * h0) * (-h0);
      const float d1 = acc2[4 * gi + 1] * expf(-0.5f * h1 * h1) * (-h1);
      const float d2 = acc2[4 * gi + 2] * expf(-0.5f * h2 * h2) * (-h2);
      const float d3 = acc2[4 * gi + 3] * expf(-0.5f * h3 * h3) * (-h3);
      st_bf2(e.out + i0, d0, d1);
      st_bf2(e.out + i1, d2, d3);
      s0[0] = d0 + d2;
      s0[1] = d1 + d3;
    } else if constexpr (EPI == kHOut) {
      const float b0 = __ldg(e.bias + c), b1 = __ldg(e.bias + c + 1);
      const float o0 = v0 + b0, o1 = v1 + b1, o2 = v2 + b0, o3 = v3 + b1;
      *reinterpret_cast<float2*>(e.gp + i0) = make_float2(o0, o1);
      *reinterpret_cast<float2*>(e.gp + i1) = make_float2(o2, o3);
      // the warp's 16 rows, in a fixed order
      const float q0 = rows_sum(o0 + o2), q1 = rows_sum(o1 + o3);
      const float r0 = rows_sum(o0 * o0 + o2 * o2), r1 = rows_sum(o1 * o1 + o3 * o3);
      if (lane < 4) {
        float* pw = e.part + ((size_t)row0 / 16 + warp) * 2 * e.N + c;
        *reinterpret_cast<float2*>(pw) = make_float2(q0, q1);
        *reinterpret_cast<float2*>(pw + e.N) = make_float2(r0, r1);
      }
    } else if constexpr (EPI == kF32) {
      *reinterpret_cast<float2*>(e.gp + i0) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(e.gp + i1) = make_float2(v2, v3);
    } else if constexpr (EPI == kDy) {
      if (e.gp != nullptr) {
        *reinterpret_cast<float2*>(e.gp + i0) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(e.gp + i1) = make_float2(v2, v3);
        const float* mb = e.mean + (size_t)bidx * e.N;
        const float m0 = __ldg(mb + c), m1 = __ldg(mb + c + 1);
        const float2 x0 = ld_bf2(e.x + i0), x1 = ld_bf2(e.x + i1);
        s0[0] = v0 * (x0.x - m0) + v2 * (x1.x - m0);
        s0[1] = v1 * (x0.y - m1) + v3 * (x1.y - m1);
        s1[0] = v0 + v2;
        s1[1] = v1 + v3;
      } else {
        st_bf2(e.out + i0, v0, v1);
        st_bf2(e.out + i1, v2, v3);
      }
    } else if constexpr (EPI == kKV) {
      const int ld = second ? e.N - e.split : e.split, cc = c - (second ? e.split : 0);
      bf16* dst = second ? e.out2 : e.out;
      st_bf2(dst + row * ld + cc, v0, v1);
      st_bf2(dst + (row + 8) * ld + cc, v2, v3);
    } else {  // kDx
      const float* seb = e.se + (size_t)bidx * e.N;
      const float se0 = __ldg(seb + c), se1 = __ldg(seb + c + 1);
      const float2 p0 =
          e.gp ? *reinterpret_cast<const float2*>(e.gp + i0) : make_float2(0.0f, 0.0f);
      const float2 p1 =
          e.gp ? *reinterpret_cast<const float2*>(e.gp + i1) : make_float2(0.0f, 0.0f);
      st_bf2(e.out + i0, p0.x + v0 * se0, p0.y + v1 * se1);
      st_bf2(e.out + i1, p1.x + v2 * se0, p1.y + v3 * se1);
      const float2 x0 = ld_bf2(e.x + i0), x1 = ld_bf2(e.x + i1);
      s0[0] = v0 * x0.x + v2 * x1.x;
      s0[1] = v1 * x0.y + v3 * x1.y;
      s1[0] = v0 + v2;
      s1[1] = v1 + v3;
    }
    if constexpr (kSums > 0) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = rows_sum(q == 0 ? s0[h] : s1[h]);
          if (lane < 4) red[(q * 8 + warp) * BN + 8 * gi + col + h] = v;
        }
      }
    }
  }
  if (kSums > 0 && (EPI != kDy || e.part != nullptr)) {
    __syncthreads();
    for (int k = threadIdx.x; k < kSums * BN; k += kGemmThreads) {
      const int q = k / BN, cc = k % BN;
      float t = 0.0f;
#pragma unroll
      for (int wp = 0; wp < 8; ++wp) t += red[(q * 8 + wp) * BN + cc];
      e.part[((size_t)rb * kSums + q) * e.N + n0 + cc] = t;
    }
  }
}

// out[(seg * sums + q) * N + c] = the sum over r < per of
// part[((seg * per + r) * sums + q) * N + c], in a fixed order: 32 columns a
// block, eight row lanes each summing every eighth row block in order,
// then the lanes in order.
__global__ void __launch_bounds__(256)
mlp_colsum_kernel(const float* __restrict__ part, float* __restrict__ out, int per, int sums,
                  int N) {
  __shared__ float red[8][33];
  const int cl = threadIdx.x % 32, lg = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cl, sq = blockIdx.y, seg = sq / sums, q = sq % sums;
  float s = 0.0f;
  if (c < N) {
    for (int r = lg; r < per; r += 8) s += part[((size_t)(seg * per + r) * sums + q) * N + c];
  }
  red[lg][cl] = s;
  __syncthreads();
  if (lg == 0 && c < N) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][cl];
    out[(size_t)sq * N + c] = t;
  }
}

inline cudaError_t launch_colsum(const float* part, float* out, int segs, int per, int sums,
                                 int N, cudaStream_t st) {
  mlp_colsum_kernel<<<dim3((N + 31) / 32, segs * sums), 256, 0, st>>>(part, out, per, sums, N);
  return cudaGetLastError();
}

// A kernel of one mlp_gemm instance; every such kernel has this signature
// (GemmKernel; the maps a product does not use are copies of the used ones).
// MLP_GEMM_KERNEL_MB asks the compiler for MINB blocks a SM (registers
// capped to fit them); MLP_GEMM_KERNEL is one block a SM.
#define MLP_GEMM_KERNEL_MB(name, BN, TB, EPI, STAGES, MINB)                                  \
  __global__ void __launch_bounds__(gecco::mlp::kGemmThreads, MINB)                          \
      name(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b, \
           const __grid_constant__ CUtensorMap tm_a2,                                        \
           const __grid_constant__ CUtensorMap tm_b2, const gecco::mlp::MlpEpi e) {          \
    gecco::mlp::mlp_gemm<BN, TB, EPI, STAGES>(&tm_a, &tm_b, &tm_a2, &tm_b2, e);              \
  }
#define MLP_GEMM_KERNEL(name, BN, TB, EPI, STAGES) MLP_GEMM_KERNEL_MB(name, BN, TB, EPI, STAGES, 1)

using GemmKernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const MlpEpi);

// one launch of a mlp_gemm instance over M rows and e.N columns
template <int BN, int EPI, int STAGES>
inline cudaError_t launch_gemm(GemmKernel kernel, const CUtensorMap& ta, const CUtensorMap& tb,
                               const CUtensorMap& ta2, const CUtensorMap& tb2, const MlpEpi& e,
                               long long M, cudaStream_t st) {
  constexpr int smem = GemmSmem<BN, EPI, STAGES>::kTotal;
  static_assert(smem <= (int)kMaxSmem, "mlp_gemm: shared memory");
  if (e.N % BN || e.K % 64 || e.K2 % 64 || (e.K2 && EPI == kDh) || M % kRows ||
      e.rows_b % kRows ||
      ((EPI == kOut || EPI == kGrad) && (e.n_valid < 1 || e.n_valid > e.rows_b))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap a = ta, b = tb, a2 = ta2, b2 = tb2;
  MlpEpi ep = e;
  void* args[] = {&a, &b, &a2, &b2, &ep};
  err = cudaLaunchKernel((const void*)kernel, dim3(e.N / BN, (unsigned)(M / kRows)),
                         dim3(kGemmThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// tensor map of a row-major bf16 [rows, cols] operand, boxes of 64 columns
// x box_rows
inline bool tmap(CUtensorMap* m, const void* base, long long rows, int cols, int box_rows) {
  return hopper::encode_tiled(m, base, (uint64_t)rows, (uint64_t)cols, (uint32_t)box_rows) ==
         CUDA_SUCCESS;
}

// The shapes both Hopper passes take: C and W multiples of 128 (the single
// products' 128-column tiles, the dual product's and the weight gradients'),
// N a multiple of the 128-row block; wide_tiles: where both are multiples
// of 384, the single products take their 192-column instances.
inline bool hopper_takes(int N, int C, int W) {
  return C % 128 == 0 && W % 128 == 0 && N % kRows == 0;
}

inline bool wide_tiles(int C, int W) { return C % 384 == 0 && W % 384 == 0; }

}  // namespace mlp
}  // namespace gecco
