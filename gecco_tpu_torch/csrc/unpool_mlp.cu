// Unpool + residual -> mlp_norm -> MLP + residual with the output channel
// sums, x' kept on the chip between the two halves: the Hopper body of the
// unpool + MLP megakernel (TMA, wgmma and a thread-block cluster per batch
// element).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_mlp_kernel
// (served by fused_unpool_mlp; opt-in on the sampler through
// GECCO_UNPOOL_MLP_MEGAKERNEL=1). The same function as folded_unpool, the
// mlp_norm statistics and fused_mlp_residual in turn, with their algebra
// and roundings (csrc/unpool.cu, csrc/mlp.cu):
//   x' = x + attn(x * se1 + be1)       as unpool.cu; x' rounded to bf16,
//   s1, s2 = sum_n x', sum_n x'^2      its channel sums in fp32 (unrounded)
//   per group g of C / G channels, over n_tokens points:
//     mean = s1_g / count;  var = s2_g / count - mean^2
//     inv = rsqrt(max(var, 0) + 1e-5)
//   se2 = sc2 * inv;  be2 = bi2 - mean * se2   (sc2/bi2: the raw embed affine)
//   y = bf16(x' * se2 + be2);  g = bf16(exp(-(y @ w1t + b1)^2 / 2))
//   o = (g @ w2t + b2) + x';  out = bf16(o);  sums[b] = [sum o | sum o^2]
//
// Bound on the H100: the unpool's and the MLP's tensor-core operations
// (4 N C (J + W) per batch element).
//
// Design. The MLP of any point needs the statistics of all N points of its
// batch element, so the blocks of one element meet once, between the two
// halves: one cluster of CS = N / 128 blocks (up to 16, a non-portable
// size) per batch element, each block holding its 128 points' x' in shared
// memory (two 64-point tiles, 96 KB at C 384), which never goes to device
// memory. Launches:
// 0. the fold (csrc/unpool_fold.cuh, as csrc/unpool.cu): kft, vf^T, brow.
// 1. unpool_mlp_cluster_kernel, 384 threads: a producer warpgroup issues
//    every TMA load of the block in one sequence (the two x tiles; each
//    consumer's three-stage ring of K panels; each consumer's half of one
//    [C, 64] slab, behind its own barriers and producer warp, so that one
//    consumer's next half loads as soon as it is done with the last,
//    whatever the other's pace), and two consumer warpgroups own C / 2
//    output columns each. Four passes run the same
//    walk over "items", 64 columns of a first product each (csrc/unpool.cu's
//    tile design): consumer warpgroup (item % 2) forms the item's [64, 64]
//    product by wgmma in registers, applies its element-wise step there and
//    writes bf16 p once to a p buffer (double-buffered by item parity);
//    both then add p @ slab into their columns by wgmma. Each warpgroup
//    forms its next item before its product with the current one.
//    a. the unpool of each tile: the items are the heads; x tile @ kft_h^T
//       + brow, the head's softmax (its own row max, exp argument clamped
//       at -80), p @ vf_h. The epilogue from the registers writes x' =
//       bf16(x + attn) over the x tile in shared memory and the tile's
//       channel sums of the unrounded x' (the thread's two rows, shuffles
//       over a warp's rows, the warpgroup's four warps in order, half its
//       columns at a time) into the block's.
//    b. a cluster barrier; every block adds the cluster's block sums in
//       rank order through distributed shared memory (no atomics: the same
//       bits in every block and every call) and collapses them into se2
//       and be2 in its shared memory.
//    c. the MLP of each tile on the resident x': first each thread starts
//       its accumulator at x' + b2 (the residual and the bias at its
//       epilogue's positions) and writes y = bf16(x' se2 + be2) over those
//       positions, so the tile holds y, the first products' A operand,
//       without a second buffer or registers kept for the residual; the
//       items are the W / 64 chunks of the hidden width: h = y @ w1t[:,
//       chunk], g = bf16(exp(-(h + b1)^2 / 2)) into the p buffer, out += g
//       @ w2t[chunk, :] (w1t and w2t read MN-major, as TMA leaves a
//       row-major tile). The epilogue writes out = bf16(acc), acc = (x' +
//       b2) + g @ w2t (the separate MLP adds the same three terms in
//       another fp32 order), and the tile's channel sums as in (a).
//    d. a cluster barrier; the cluster's out sums added in rank order into
//       sums; a last barrier keeps every block's shared memory until the
//       others have read it.
//    The producer arrives at the first cluster barrier before its loads and
//    loads on past it, so the MLP's first operands arrive while the cluster
//    meets. Rows from n_valid on (a ragged N, zero-padded to 128s by the
//    wrapper) stay out of both sums.
// Shapes: C == 384, I == 64, H even, D = C / H a multiple of 16 up to 64,
// W % 128 == 0, N (padded) a multiple of 128 up to 16 * 128 = 2048; the
// rest take the WMMA body (csrc/unpool_mlp_wmma.cu) or the separate
// kernels. Shared memory: x' 96 KB, the kft / w1t rings 2 x 3 x 8 KB, one
// vf / w2t slab of 48 KB, the p / g buffers 16 KB and the sums: ~224 KB,
// one block a SM; the card runs 7 clusters of 16 at once (112 SMs). The
// ring depths are measured ones (PERF.md §6: a second slab stage does
// not fit; the halves' own barriers, y in shared memory and the
// accumulator's start at x' + b2 each took time off). folded_attention.py's
// _unpool_mlp_hopper_takes and _unpool_mlp_hopper_smem repeat these limits:
// change both together.
#include <cmath>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "unpool_fold.cuh"

using namespace gecco;
using namespace gecco::hopper;
namespace cg = cooperative_groups;

namespace {

constexpr int kInd = 64;                  // inducers per head (I)
constexpr int kTile = 64;                 // points of a tile
constexpr int kTiles = 2;                 // tiles a block holds
constexpr int kBlockRows = kTile * kTiles;
constexpr int kMaxCluster = 16;           // blocks of one batch element
constexpr int kKRing = 3;                 // stages of each consumer's K-panel ring
constexpr int kVRing = 1;                 // stages of each consumer's half-slab ring
constexpr int kPanel = kTile * 128;       // one K panel of 64 rows
constexpr int kNW = 192;                  // output columns of a consumer warpgroup
constexpr int kHalf = kNW / 2;            // the columns of one pass of its sums
constexpr int kC = 2 * kNW;               // channels (C)
constexpr int kKP = kC / 64;              // K panels of C
constexpr int kThreadsMk = 384;

enum Pass { kUnpool = 0, kMlp = 1 };

// Shared memory, in bytes from a 1024-aligned base.
struct Smem {
  static constexpr int xs = 0;                               // [kTiles][kKP] panels: x, then x'
  static constexpr int kring = xs + kTiles * kKP * kPanel;    // [2 consumers][kKRing] panels
  static constexpr int vring = kring + 2 * kKRing * kPanel;   // [kVRing] slabs [C, 64] in halves
  static constexpr int pbuf = vring + kVRing * kC * 128;      // [2] p / g panels
  // [2][4 warps][2][kHalf] fp32 the warps' sums; [2][C] the cluster's x' sums
  static constexpr int red = pbuf + 2 * kPanel;
  static constexpr int xsum = red + 2 * 4 * 2 * kHalf * 4;    // [2][C] the block's x' sums
  static constexpr int osum = xsum + 2 * kC * 4;              // [2][C] its out sums
  static constexpr int aff = osum + 2 * kC * 4;               // [2][C] se2 | be2
  static constexpr int bars = aff + 2 * kC * 4;
  static constexpr int kBars = kTiles + 4 * kKRing + 4 * kVRing + 4;
  static constexpr int total = bars + kBars * 8 + 1024;       // + alignment slack
};
static_assert(Smem::total <= (int)kMaxSmem, "unpool_mlp: shared memory");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A consumer's place in its K-panel ring: the stage and its phase bit.
struct RingPos {
  int s = 0, phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == kKRing) {
      s = 0;
      phase ^= 1;
    }
  }
};

// What a consumer warpgroup works on.
struct Ctx {
  unsigned char *xs, *kring, *vring, *pbuf;  // kring: the warpgroup's own ring
  const float* brow;                         // [J] of the block's batch element
  const float* b1;                           // [W]
  const float* aff;                          // se2 | be2 (shared memory)
  uint64_t *kfull, *kempty, *vfull, *vempty, *pfull, *pempty;
  int w, lane, col, r0;
};

// Before the MLP pass over a tile: the accumulator starts at x' + b2 (the
// residual and the bias, at the thread's positions: rows r0 and r0 + 8,
// its warpgroup's column pairs), and y = bf16(x' se2 + be2) is written
// over x', so that the tile holds y, the A operand of the first products.
__device__ __forceinline__ void prenorm_tile(const Ctx& t, int tile, float (&o_acc)[kNW / 2],
                                             const float* __restrict__ b2) {
  unsigned char* xt = t.xs + tile * kKP * kPanel;
#pragma unroll
  for (int g = 0; g < kNW / 8; ++g) {
    const int c = t.w * kNW + 8 * g + t.col;
    const float2 se = *reinterpret_cast<const float2*>(t.aff + c);
    const float2 be = *reinterpret_cast<const float2*>(t.aff + kC + c);
    const float c0 = __ldg(b2 + c), c1 = __ldg(b2 + c + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      auto* pv = reinterpret_cast<__nv_bfloat162*>(xt + swz(t.r0 + 8 * h, c, kPanel));
      const float2 xv = __bfloat1622float2(*pv);
      o_acc[4 * g + 2 * h] = xv.x + c0;
      o_acc[4 * g + 2 * h + 1] = xv.y + c1;
      *pv = __floats2bfloat162_rn(__fmaf_rn(xv.x, se.x, be.x), __fmaf_rn(xv.y, se.y, be.y));
    }
  }
  fence_async_smem();
}

// Item ``item`` of its pass (global index q) on tile ``tile``: the [64, 64]
// first product, its element-wise step and bf16 p into p buffer q % 2;
// kpos is the warpgroup's place in its ring.
template <int P>
__device__ __forceinline__ void first_product(const Ctx& t, int tile, int q, int item,
                                              RingPos& kpos) {
  const unsigned char* xt = t.xs + tile * kKP * kPanel;
  float s_acc[kInd / 2];
  for (int kp = 0; kp < kKP; ++kp, kpos.next()) {
    const int s = kpos.s;
    unsigned char* ks = t.kring + s * kPanel;
    bar_wait(t.kfull + s, kpos.phase);
    // the tile (x, or y in the MLP's passes) against a kft_h panel (K-major)
    // or a w1t panel (MN-major)
    const uint64_t dx = desc(xt + kp * kPanel);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (P == kUnpool) {
        wgmma_ss<kInd>(s_acc, dx + 2 * kk, desc(ks) + 2 * kk, (kp | kk) != 0);
      } else {
        wgmma_tt<0, 1>(s_acc, dx + 2 * kk, desc_mn(ks + kk * 2048, kPanel), (kp | kk) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    if (t.lane == 0) bar_arrive(t.kempty + s);
  }
  const int col = t.col;
  float l0 = 1.0f, l1 = 1.0f;
  if constexpr (P == kUnpool) {
    // the head's softmax: + brow, its own row max, exp argument clamped at -80
    const float* bb = t.brow + item * kInd;
    float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = __ldg(bb + 8 * g + col + e);
        s_acc[4 * g + e] += bias;
        s_acc[4 * g + 2 + e] += bias;
        m0 = fmaxf(m0, s_acc[4 * g + e]);
        m1 = fmaxf(m1, s_acc[4 * g + 2 + e]);
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    l0 = 0.0f;
    l1 = 0.0f;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s_acc[4 * g + e] = expf(fmaxf(s_acc[4 * g + e] - m0, -80.0f));
        s_acc[4 * g + 2 + e] = expf(fmaxf(s_acc[4 * g + 2 + e] - m1, -80.0f));
        l0 += s_acc[4 * g + e];
        l1 += s_acc[4 * g + 2 + e];
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  } else {
    // the Gaussian activation of h = acc + b1 (l stays 1: p = g exactly)
    const float* bb = t.b1 + item * 64;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = __ldg(bb + 8 * g + col + e);
        const float h0 = s_acc[4 * g + e] + bias, h1 = s_acc[4 * g + 2 + e] + bias;
        s_acc[4 * g + e] = expf(-0.5f * h0 * h0);
        s_acc[4 * g + 2 + e] = expf(-0.5f * h1 * h1);
      }
    }
  }
  const int u = q / 2;
  if (u >= 1) bar_wait(t.pempty + q % 2, (u - 1) & 1);
  unsigned char* p = t.pbuf + (q % 2) * kPanel;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int c = 8 * g + col;
    *reinterpret_cast<__nv_bfloat162*>(p + swz(t.r0, c, kPanel)) =
        __floats2bfloat162_rn(s_acc[4 * g] / l0, s_acc[4 * g + 1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(p + swz(t.r0 + 8, c, kPanel)) =
        __floats2bfloat162_rn(s_acc[4 * g + 2] / l1, s_acc[4 * g + 3] / l1);
  }
  fence_async_smem();
  bar_arrive(t.pfull + q % 2);
}

// The warpgroup's output columns += p_q @ its half of slab_q (with
// ``first``, the unpool's first item, overwrite them).
template <int P>
__device__ __forceinline__ void second_product(const Ctx& t, float (&o_acc)[kNW / 2], int q,
                                               bool first) {
  bar_wait(t.pfull + q % 2, (q / 2) & 1);
  const int s = q % kVRing;
  bar_wait(t.vfull + s, (q / kVRing) & 1);
  const uint64_t dp = desc(t.pbuf + (q % 2) * kPanel);
  unsigned char* vs = t.vring + s * kC * 128;
  wgmma_fence();
  if constexpr (P == kUnpool) {
    // vf_h^T rows (K-major): the warpgroup's kNW channels
    const uint64_t dv = desc(vs + t.w * kNW * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<kNW>(o_acc, dp + 2 * kk, dv + 2 * kk, !(first && kk == 0));
    }
  } else {
    // w2t rows of the chunk (MN-major): the warpgroup's kNW / 64 panels
    unsigned char* vw = vs + t.w * (kNW / 64) * kPanel;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tt<0, 1>(o_acc, dp + 2 * kk, desc_mn(vw + kk * 2048, kPanel), !(first && kk == 0));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o_acc);
  if (t.lane == 0) {
    bar_arrive(t.pempty + q % 2);
    bar_arrive(t.vempty + s);
  }
}

// One pass over tile ``tile``: items base ... base + n - 1 (base even).
template <int P>
__device__ __forceinline__ void run_pass(const Ctx& t, float (&o_acc)[kNW / 2], int tile,
                                         int base, int n, RingPos& kpos) {
  if (t.w == 0) first_product<P>(t, tile, base, 0, kpos);
  for (int h = 0; h < n; ++h) {
    if (h + 1 < n && (h + 1) % 2 == t.w) first_product<P>(t, tile, base + h + 1, h + 1, kpos);
    // the unpool's first item overwrites the accumulator, the MLP's add to x' + b2
    second_product<P>(t, o_acc, base + h, P == kUnpool && h == 0);
  }
}

// A warp's sums of o and o^2 over its 16 rows (those before ``valid``) for
// the column pair cw, cw + 1 of a half of the warpgroup's columns into red
// [4 warps][2][kHalf].
__device__ __forceinline__ void warp_sums(float* red, int wi, int cw, int lane, bool ok0,
                                          bool ok1, float o00, float o01, float o10, float o11) {
  float q[4] = {(ok0 ? o00 : 0.0f) + (ok1 ? o10 : 0.0f), (ok0 ? o01 : 0.0f) + (ok1 ? o11 : 0.0f),
                (ok0 ? o00 * o00 : 0.0f) + (ok1 ? o10 * o10 : 0.0f),
                (ok0 ? o01 * o01 : 0.0f) + (ok1 ? o11 * o11 : 0.0f)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] += __shfl_xor_sync(0xffffffffu, q[k], 4);
    q[k] += __shfl_xor_sync(0xffffffffu, q[k], 8);
    q[k] += __shfl_xor_sync(0xffffffffu, q[k], 16);
  }
  if (lane < 4) {
    *reinterpret_cast<float2*>(red + (wi * 2) * kHalf + cw) = make_float2(q[0], q[1]);
    *reinterpret_cast<float2*>(red + (wi * 2 + 1) * kHalf + cw) = make_float2(q[2], q[3]);
  }
}

// The warpgroup's four warps' sums of its column half ``half`` added in
// order into the block's [2][C] sums (the first tile sets them, the second
// adds to them).
__device__ __forceinline__ void block_sums(const float* red, float* sum, int w, int tile,
                                           int half) {
  named_sync(2 + w, 128);
  for (int e = threadIdx.x % 128; e < 2 * kHalf; e += 128) {
    const int k = e / kHalf, cw = e % kHalf;
    const float v = red[k * kHalf + cw] + red[(2 + k) * kHalf + cw] +
                    red[(4 + k) * kHalf + cw] + red[(6 + k) * kHalf + cw];
    float* dst = sum + k * kC + w * kNW + half * kHalf + cw;
    *dst = tile == 0 ? v : *dst + v;
  }
  named_sync(2 + w, 128);
}

// The x' epilogue of an unpool pass: x' = bf16(x + attn) over the x tile,
// and the tile's sums of the unrounded x' over its rows before ``valid``.
__device__ __forceinline__ void unpool_epilogue(const Ctx& t, const float (&o_acc)[kNW / 2],
                                                int tile, int valid, float* red, float* xsum) {
  unsigned char* xt = t.xs + tile * kKP * kPanel;
  const int wi = (threadIdx.x % 128) / 32;
  const bool ok0 = t.r0 < valid, ok1 = t.r0 + 8 < valid;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int gh = 0; gh < kHalf / 8; ++gh) {
      const int g = half * (kHalf / 8) + gh, cw = 8 * g + t.col, c = t.w * kNW + cw;
      auto* p0 = reinterpret_cast<__nv_bfloat162*>(xt + swz(t.r0, c, kPanel));
      auto* p1 = reinterpret_cast<__nv_bfloat162*>(xt + swz(t.r0 + 8, c, kPanel));
      const float2 x0 = __bfloat1622float2(*p0), x1 = __bfloat1622float2(*p1);
      const float o00 = x0.x + o_acc[4 * g], o01 = x0.y + o_acc[4 * g + 1];
      const float o10 = x1.x + o_acc[4 * g + 2], o11 = x1.y + o_acc[4 * g + 3];
      *p0 = __floats2bfloat162_rn(o00, o01);
      *p1 = __floats2bfloat162_rn(o10, o11);
      warp_sums(red, wi, 8 * gh + t.col, t.lane, ok0, ok1, o00, o01, o10, o11);
    }
    block_sums(red, xsum, t.w, tile, half);
  }
}

// The out epilogue of an MLP pass: o = the accumulator (x' + b2 + g @ w2t:
// prenorm_tile started it at x' + b2), out = bf16(o) at rows row0 ... of
// device memory, the tile's sums of o.
__device__ __forceinline__ void mlp_epilogue(const Ctx& t, const float (&o_acc)[kNW / 2],
                                             int tile, int valid, bf16* __restrict__ out,
                                             size_t row0, float* red, float* osum) {
  const int wi = (threadIdx.x % 128) / 32;
  const bool ok0 = t.r0 < valid, ok1 = t.r0 + 8 < valid;
  bf16* o0p = out + (row0 + t.r0) * kC;
  bf16* o1p = o0p + 8 * kC;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int gh = 0; gh < kHalf / 8; ++gh) {
      const int g = half * (kHalf / 8) + gh, c = t.w * kNW + 8 * g + t.col;
      const float o00 = o_acc[4 * g], o01 = o_acc[4 * g + 1];
      const float o10 = o_acc[4 * g + 2], o11 = o_acc[4 * g + 3];
      *reinterpret_cast<__nv_bfloat162*>(o0p + c) = __floats2bfloat162_rn(o00, o01);
      *reinterpret_cast<__nv_bfloat162*>(o1p + c) = __floats2bfloat162_rn(o10, o11);
      warp_sums(red, wi, 8 * gh + t.col, t.lane, ok0, ok1, o00, o01, o10, o11);
    }
    block_sums(red, osum, t.w, tile, half);
  }
}

// One cluster per batch element (blockIdx.y), one block per 128 points
// (blockIdx.x, the block's rank). tm_x: x [B N, C]; tm_k: kft [B J, C];
// tm_v: vf^T [B C, J] in boxes of 192 rows; tm_w1: w1t [C, W]; tm_w2: w2t
// [W, C].
__global__ void __launch_bounds__(kThreadsMk, 1)
unpool_mlp_cluster_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_w1,
                          const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ brow,
                          const float* __restrict__ sc2, const float* __restrict__ bi2,
                          const float* __restrict__ b1, const float* __restrict__ b2,
                          bf16* __restrict__ out, float* __restrict__ sums, int N, int n_valid,
                          int H, int W, int G, int n_tokens) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int b = blockIdx.y, J = H * kInd, WC = W / 64;
  const size_t row0 = (size_t)b * N + (size_t)rank * kBlockRows;  // the block's first row
  unsigned char* xs = smem + Smem::xs;
  float* red = reinterpret_cast<float*>(smem + Smem::red);
  float* xsum = reinterpret_cast<float*>(smem + Smem::xsum);
  float* osum = reinterpret_cast<float*>(smem + Smem::osum);
  float* tot = red;  // free between the two halves' epilogues
  float* aff = reinterpret_cast<float*>(smem + Smem::aff);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + Smem::bars);  // [kTiles]
  uint64_t* kfull = xfull + kTiles;          // [2][kKRing]
  uint64_t* kempty = kfull + 2 * kKRing;     // [2][kKRing]
  uint64_t* vfull = kempty + 2 * kKRing;     // [2 halves][kVRing]
  uint64_t* vempty = vfull + 2 * kVRing;     // [2 halves][kVRing]
  uint64_t* pfull = vempty + 2 * kVRing;     // [2]
  uint64_t* pempty = pfull + 2;              // [2]
  auto kstage = [&](int w, int s) { return smem + Smem::kring + (w * kKRing + s) * kPanel; };
  auto vstage = [&](int s) { return smem + Smem::vring + s * kC * 128; };

  if (threadIdx.x == 0) {
    for (int q = 0; q < kTiles; ++q) bar_init(xfull + q, 1);
    for (int q = 0; q < 2 * kKRing; ++q) {
      bar_init(kfull + q, 1);
      bar_init(kempty + q, 4);  // the consumer's four warps
    }
    for (int q = 0; q < 2 * kVRing; ++q) {
      bar_init(vfull + q, 1);
      bar_init(vempty + q, 4);  // the consumer's four warps
    }
    for (int q = 0; q < 2; ++q) {
      bar_init(pfull + q, 128);  // every thread of the writing warpgroup
      bar_init(pempty + q, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: warp 8 the x tiles and consumer 0's ring, warp 9
    // consumer 1's ring, warps 10 and 11 the consumers' halves of the
    // slabs; the unpool's operands, then the MLP's
    setmaxnreg_dec<24>();
    cluster_arrive();  // (b): this warpgroup brings nothing to the meeting
    if (lane == 0 && warp == 8) {
      for (int t = 0; t < kTiles; ++t) {
        bar_expect(xfull + t, kKP * kPanel);
        for (int p = 0; p < kKP; ++p) {
          tma_load(xs + (t * kKP + p) * kPanel, &tm_x, xfull + t, (int)(row0 + t * kTile), p * 64);
        }
      }
    }
    if (lane == 0 && warp <= 9) {
      const int w = warp - 8;
      int it = 0;
      for (int pass = 0; pass < 2 * kTiles; ++pass) {
        const bool mlp = pass >= kTiles;
        for (int h = w; h < (mlp ? WC : H); h += 2) {
          for (int kp = 0; kp < kKP; ++kp, ++it) {
            const int s = it % kKRing;
            if (it >= kKRing) bar_wait(kempty + w * kKRing + s, ((it / kKRing) - 1) & 1);
            bar_expect(kfull + w * kKRing + s, kPanel);
            if (mlp) {
              tma_load(kstage(w, s), &tm_w1, kfull + w * kKRing + s, kp * 64, h * 64);
            } else {
              tma_load(kstage(w, s), &tm_k, kfull + w * kKRing + s, b * J + h * kInd, kp * 64);
            }
          }
        }
      }
    } else if (lane == 0 && warp >= 10) {
      // warp 10 + v: consumer v's half of each slab
      const int v = warp - 10;
      uint64_t* vf = vfull + v * kVRing;
      uint64_t* ve = vempty + v * kVRing;
      int q = 0;
      for (int pass = 0; pass < 2 * kTiles; ++pass) {
        const bool mlp = pass >= kTiles;
        for (int h = 0; h < (mlp ? WC : H); ++h, ++q) {
          const int s = q % kVRing;
          if (q >= kVRing) bar_wait(ve + s, ((q / kVRing) - 1) & 1);
          bar_expect(vf + s, kNW * 128);
          if (mlp) {
            for (int p = v * (kNW / 64); p < (v + 1) * (kNW / 64); ++p) {
              tma_load(vstage(s) + p * kPanel, &tm_w2, vf + s, h * 64, p * 64);
            }
          } else {
            tma_load(vstage(s) + v * kNW * 128, &tm_v, vf + s, b * kC + v * kNW, h * kInd);
          }
        }
      }
    }
    cluster_wait();
    cluster_arrive();  // (d)
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup w owns output columns w * kNW ...
  setmaxnreg_inc<240>();
  const int w = wg, tid = threadIdx.x;
  const Ctx t{xs, kstage(w, 0), vstage(0), smem + Smem::pbuf, brow + (size_t)b * J, b1, aff,
              kfull + w * kKRing, kempty + w * kKRing, vfull + w * kVRing,
              vempty + w * kVRing, pfull, pempty,
              w, lane, 2 * (lane % 4), (warp % 4) * 16 + lane / 4};
  float* wred = red + w * 4 * 2 * kHalf;
  const int valid = n_valid - rank * kBlockRows;  // the block's rows before n_valid
  float o_acc[kNW / 2];
  RingPos kpos;
  int q = 0;
  // (a) the unpool of each tile: x' over x, its sums into xsum
  for (int tile = 0; tile < kTiles; ++tile, q += H) {
    bar_wait(xfull + tile, 0);
    run_pass<kUnpool>(t, o_acc, tile, q, H, kpos);
    unpool_epilogue(t, o_acc, tile, valid - tile * kTile, wred, xsum);
  }
  // (b) the cluster's x' sums in rank order, the collapse into se2 | be2
  cluster_arrive();
  cluster_wait();
  for (int e = tid; e < 2 * kC; e += 256) {
    float s = 0.0f;
    for (int r = 0; r < cs; ++r) s += cl.map_shared_rank(xsum, r)[e];
    tot[e] = s;
  }
  named_sync(1, 256);
  const int pg = kC / G;
  const float count = (float)n_tokens * (float)pg;
  for (int c = tid; c < kC; c += 256) {
    const int c0 = (c / pg) * pg;
    float g1 = 0.0f, g2 = 0.0f;
    for (int u = c0; u < c0 + pg; ++u) {
      g1 += tot[u];
      g2 += tot[kC + u];
    }
    const float mean = g1 / count;
    const float var = g2 / count - mean * mean;
    const float inv = rsqrtf(fmaxf(var, 0.0f) + 1e-5f);
    const float se = sc2[(size_t)b * kC + c] * inv;
    aff[c] = se;
    aff[kC + c] = bi2[(size_t)b * kC + c] - mean * se;
  }
  named_sync(1, 256);
  // (c) the MLP of each tile on the resident x', y written over it
  for (int tile = 0; tile < kTiles; ++tile, q += WC) {
    prenorm_tile(t, tile, o_acc, b2);
    named_sync(1, 256);  // both halves of the tile hold y
    run_pass<kMlp>(t, o_acc, tile, q, WC, kpos);
    mlp_epilogue(t, o_acc, tile, valid - tile * kTile, out, row0 + tile * kTile, wred, osum);
  }
  // (d) the cluster's out sums in rank order
  cluster_arrive();
  cluster_wait();
  for (int e = rank * 256 + tid; e < 2 * kC; e += cs * 256) {
    float s = 0.0f;
    for (int r = 0; r < cs; ++r) s += cl.map_shared_rank(osum, r)[e];
    sums[(size_t)b * 2 * kC + e] = s;
  }
  cluster_arrive();  // every block is done reading the others' sums
  cluster_wait();
}

bool takes(int N, int C, int H, int I, int W) {
  return C == kC && I == kInd && H >= 2 && H % 2 == 0 && C % H == 0 && (C / H) % 16 == 0 &&
         C / H <= 64 && W >= 128 && W % 128 == 0 && N % kBlockRows == 0 && N >= kBlockRows &&
         N <= kMaxCluster * kBlockRows;
}

cudaError_t configure() {
  cudaError_t err = set_smem((const void*)unpool_mlp_cluster_kernel, Smem::total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute((const void*)unpool_mlp_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// Shared memory of one block of the Hopper body (for the wrapper's mirror).
extern "C" int unpool_mlp_smem() { return Smem::total; }

// How many clusters of cs blocks the card runs at once (0: none fits), or
// a negative CUDA error.
extern "C" int unpool_mlp_clusters(int cs) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(kThreadsMk);
  cfg.dynamicSmemBytes = Smem::total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)unpool_mlp_cluster_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// x [B, N, C] bf16 with N the padded point count (a multiple of 128; the
// points from n_valid on are zero padding); bq [B, C], kft [B, J, C], vft
// [B, C, J] and brow [B, J] the fold's scratch; out [B, N, C], sums [B, 2,
// C] (written, not added to).
extern "C" int unpool_mlp_launch(const void* x, const void* se1, const void* be1, const void* k,
                                 const void* v, const void* wq, const void* wo, const void* sc2,
                                 const void* bi2, const void* w1t, const void* b1,
                                 const void* w2t, const void* b2, void* bq, void* kft, void* vft,
                                 void* brow, void* out, void* sums, int B, int N, int C, int H,
                                 int I, int W, int G, int n_valid, int n_tokens, void* stream) {
  if (!takes(N, C, H, I, W) || B < 1 || G < 1 || C % G != 0 || n_valid < 1 || n_valid > N) {
    return (int)cudaErrorInvalidValue;
  }
  const int J = H * I, cs = N / kBlockRows;
  // 1/sqrt(D) rounded once from double, as the JAX package's Python float
  const float scale = (float)(1.0 / sqrt((double)(C / H)));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = fold::launch_unpool_fold(
      (const float*)se1, (const float*)be1, (const bf16*)k, (const bf16*)v, (const bf16*)wq,
      (const bf16*)wo, (float*)bq, (bf16*)kft, (bf16*)vft, (float*)brow, B, C, H, true, scale,
      st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_x, tm_k, tm_v, tm_w1, tm_w2;
  if (encode_tiled(&tm_x, x, (uint64_t)B * N, C, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_k, kft, (uint64_t)B * J, C, kInd) != CUDA_SUCCESS ||
      encode_tiled(&tm_v, vft, (uint64_t)B * C, J, kNW) != CUDA_SUCCESS ||
      encode_tiled(&tm_w1, w1t, C, W, 64) != CUDA_SUCCESS ||
      encode_tiled(&tm_w2, w2t, W, C, 64) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = configure()) != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B);
  cfg.blockDim = dim3(kThreadsMk);
  cfg.dynamicSmemBytes = Smem::total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, unpool_mlp_cluster_kernel, tm_x, tm_k, tm_v, tm_w1, tm_w2,
                           (const float*)brow, (const float*)sc2, (const float*)bi2,
                           (const float*)b1, (const float*)b2, (bf16*)out, (float*)sums, N,
                           n_valid, H, W, G, n_tokens);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
