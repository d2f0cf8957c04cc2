// Backward of the resident attention pool (folded_pool_layer): the Hopper
// body.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_bwd_kernel, with
// its per-head algebra (no fold of Wv into the logit side). From the
// forward (pool.cu): mean_c, inv_c, the pre-normed stream y [B, N, C], the
// column max M and sum L [B, J] and the fp32 P [B, I, C]. Per batch element
// b, g = bf16(g_h0):
//   dpool = bf16(g @ Wo) [I, C];  merged = bf16(P);  dWo = sum_b g^T merged
//   t[hI+i] = sum_d dpool[i, hD+d] P[i, hD+d]   (= sum_n dp p, exactly)
//   per head h, recomputed per point tile: s = y qf_h, v_h = bf16(y Wv_h^T),
//     p = bf16(exp(max(s - M, -80)) / L) (normalised before its rounding)
//     dp = v_h dpool_h^T [N, I];  dv_h = bf16(p dpool_h) [N, D]
//     ds_h = bf16(p (dp - t_h) [s - M > -80])  (the clamped forward's jacobian)
//   dy = [ds | dv] [qf^T ; Wv];  dqf = sum_b y^T ds;  dWv = sum_b dv^T y
// and with the pre-norm (xc = x - mean_c, w_c = inv_c scale, count = n_valid
// C/G):
//   dscale = inv_c sum_n dy xc;  dbias = sum_n dy
//   dinv_c = scale sum_n dy xc + g_inv;  dmean_c = -w_c sum_n dy + g_mean
//   per group: dvar_g = -inv_g^3 / 2 sum_c dinv_c;
//              dmean_g = sum_c dmean_c - 2 mean_g dvar_g
//   dx = bf16(dy w_c + 2 x dvar_g / count + dmean_g / count)
// without it dx = bf16(dy), and scale and bias take no gradient.
//
// Bound on the H100: tensor-core operations, the products of the gradient
// (dp, dv, dy's two, dqf, dWv; dpool and dWo) and the recompute of the
// logits and values, ~0.22 ms at the flagship's B 48.
//
// Design (the WMMA body, pool_bwd_wmma.cu, walked all heads per point tile
// through shared-memory WMMA round trips, re-read qf_h and Wv_h from L2 for
// every tile and head, summed dWo, the channel sums, dqf and dWv with fp32
// atomics). Here every product over C is a pass of Hopper GEMMs and the
// per-head work stays in registers:
// 1. dpool = bf16(g Wo) for all heads: one mlp_gemm (mlp_hopper.cuh) over
//    the B I rows; layer_bwd_t_kernel, one warp per (b, i, h): t from the
//    forward's fp32 P (no pass over the points) and merged = bf16(P); dWo
//    = g^T merged by wgrad.cuh;
// 2. layer_bwd_pass_kernel, one block per (point tile, group of 8 heads):
//    the y tile by TMA into the 128-byte swizzle, read once for the eight
//    heads. Up to C 384 the tile holds 128 points, both warpgroups walk the
//    eight heads on their own 64 and one TMA ring of the heads' qf^T K
//    panels (and Wv_h's with a head's first block of inducers) feeds both,
//    so each panel read from L2 serves 128 points (the K loop is bound by
//    those reads); at C 768, where such a tile does not fit, the tile holds
//    64 points and each warpgroup walks four heads through its own ring,
//    as pool.cu's pass B. Per head
//    and block of 64 inducers s (m64n64) and v (m64n48) by wgmma into
//    registers at depth C while the block's dpool rows (cp.async) and its
//    columns' M, L and t come in behind them, p (exp times the column's
//    1/L) and the mask in registers, dp = bf16(v) dpool_h^T (m64n64) and
//    dv += bf16(p) dpool_h (m64n48, kept across the blocks) by wgmma with
//    v and p as A operands in registers (no shared-memory round trip) and
//    the head's dpool block staged, ds in registers; bf16(ds) [B N, J] and
//    bf16(dv) [B N, C] to device memory.
//    No fp32 logits go through device memory;
// 3. dy = [ds | dv] [qf^T ; Wv]: one mlp_gemm of depth J + C (epilogue kDy):
//    without the pre-norm dx = bf16(dy); with it the fp32 dy and each
//    128-row block's column sums of dy xc and dy, added in block order by
//    mlp_colsum_kernel, then layer_bwd_dx_kernel (the per-group
//    coefficients, dx, dscale and dbias);
// 4. dqf = y^T ds and dWv = dv^T y over the B N rows by wgrad.cuh.
// No atomics: every sum runs in a fixed order, so every output is the same
// bits from call to call. Any I % 16 == 0: a head's inducers go by blocks
// of 64 columns; a block's columns past I (the next head's rows of qf^T, or
// TMA's zero fill past J) take no part (p 0, their dpool rows staged as 0,
// no ds written). A ragged N comes zero-padded to a multiple of 128 by the
// wrapper: with kMask p is 0 on the points from n_valid on, so their ds, dv
// and dy are too.
#include <cmath>

#include "mlp_hopper.cuh"
#include "wgrad.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kHD = 48;        // channels per head (D)
constexpr int kGroup = 8;      // heads per block (PassSmem: eight or four a warpgroup)
constexpr int kTM = 64;        // points a warpgroup: one 64-row m-block
constexpr int kIB = 64;        // inducer columns per block
constexpr int kMaxRing = 3;    // stages of a weight ring (2 at C 768)
constexpr int kOp = 64 * 128;  // one [64, 64] bf16 operand, 128-byte swizzled
constexpr int kQBytes = kIB * 128;   // one K panel of a column block of qf^T_h
constexpr int kWBytes = kHD * 128;   // one K panel of Wv_h [48, 64]
constexpr int kDpt = kHD * 128;      // dpool_h^T [48, 64 inducers]
constexpr int kStageBytes = kQBytes + kWBytes;
constexpr int kPassThreads = 256;
constexpr int kDxTile = 64;          // points per block of the dx kernel

MLP_GEMM_KERNEL(layer_bwd_dpool_kernel, mlp::kBnWide, 1, mlp::kKV, mlp::kStagesWide)
MLP_GEMM_KERNEL(layer_bwd_dy_kernel, mlp::kBnWide, 1, mlp::kDy, mlp::kStagesWide)

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~(uintptr_t)1023);
}

// two floats as a bf16 pair in one register (the first in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 16 bytes from global to shared memory, asynchronously (cp.async); with
// ``fill`` the 16 bytes are zeros and src is not read
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 0 : 16)
               : "memory");
}

// Shared-memory layout of a pass block, in bytes from a 1024-aligned base:
// the y tile [TR, C] (TR = 128 points where ``pair``, else 64), the weight
// ring (one shared by both warpgroups where ``pair``, else one each), then
// per warpgroup the dpool_h block [64, 48] and its transpose [48, 64], the
// block's column statistics (M, 1/L, t) [3, 64] fp32, the barriers (folded_attention.py
// _pool_layer_bwd_pass_smem: change both together). ``pair`` up to C 384:
// both warpgroups walk the same eight heads on their own 64 points, so each
// weight panel read from L2 serves 128 points; at C 768 the y tile of 128
// points would not fit, and each warpgroup walks four heads of one tile.
struct PassSmem {
  int pair, rows, ring, y, stages, dpk, dpt, stat, bars, total;
  __host__ __device__ explicit PassSmem(int C) {
    pair = C <= 384;
    rows = pair ? 2 * kTM : kTM;
    ring = C <= 384 ? kMaxRing : 2;
    y = 0;
    stages = y + (C / 64) * rows * 128;
    dpk = stages + (pair ? 1 : 2) * ring * kStageBytes;
    dpt = dpk + 2 * kOp;
    stat = dpt + 2 * kDpt;
    bars = stat + 2 * 3 * kIB * 4;
    total = bars + (1 + 2 * 2 * kMaxRing) * 8 + 1024;  // + alignment slack
  }
};

// dpool [Mg, C] (rows b I + i), the forward's fp32 P [B, I, C]: one warp per
// (b, i, h) forms t[b, hI + i] = sum_d dpool P (lanes, then the warp's
// shuffles in a fixed order) and writes merged = bf16(P) on its head's
// columns.
__global__ void __launch_bounds__(kThreads)
layer_bwd_t_kernel(const bf16* __restrict__ dpool, const float* __restrict__ pacc,
                   float* __restrict__ tacc, bf16* __restrict__ merged, int B, int C, int H,
                   int I) {
  const int J = H * I, lane = threadIdx.x % 32;
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= (long long)B * I * H) return;
  const int h = (int)(w % H);
  const long long bi = w / H;  // b I + i
  const int b = (int)(bi / I), i = (int)(bi % I);
  const size_t o = (size_t)bi * C + (size_t)h * kHD;
  float acc = 0.0f;
  for (int d = lane; d < kHD; d += 32) {
    const float p = pacc[o + d];
    acc += __bfloat162float(dpool[o + d]) * p;
    merged[o + d] = __float2bfloat16(p);
  }
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) tacc[(size_t)b * J + (size_t)h * I + i] = acc;
}

// The main pass (see the header, 2.). kMask: the tile's points may hold a
// ragged tail's padding. kPair: PassSmem's ``pair`` (a 128-point tile, one
// weight ring, each warpgroup all eight heads on its 64 points).
template <bool kMask, bool kPair>
__global__ void __launch_bounds__(kPassThreads, 1)
layer_bwd_pass_kernel(const __grid_constant__ CUtensorMap tm_y,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ macc,
                      const float* __restrict__ sacc, const float* __restrict__ tacc,
                      const bf16* __restrict__ dpool, bf16* __restrict__ ds_out,
                      bf16* __restrict__ dv_out, int N, int n_valid, int C, int H, int I) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const PassSmem L(C);
  constexpr int TR = kPair ? 2 * kTM : kTM;  // points a block
  constexpr int kHeads = kPair ? kGroup : kGroup / 2;  // heads a warpgroup walks
  const int ring = L.ring;
  const int KP = C / 64, J = H * I, NB = (I + kIB - 1) / kIB;
  const int tile = blockIdx.x, grp = blockIdx.y;
  const int w = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int b = tile * TR / N;
  // the warpgroup's first point in its batch element
  const int n0 = tile * TR % N + (kPair ? w * kTM : 0);
  // the warpgroup's ring (kPair: the block's one) and its first head
  const int rw = kPair ? 0 : w, h0 = grp * kGroup + (kPair ? 0 : w * kHeads);
  unsigned char* y = smem + L.y;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* yfull = bars;
  uint64_t* full = bars + 1;               // [rings][ring]
  uint64_t* empty = full + 2 * kMaxRing;   // [rings][ring]
  auto stage = [&](int s) { return smem + L.stages + (rw * ring + s) * kStageBytes; };

  if (threadIdx.x == 0) {
    bar_init(yfull, 1);
    for (int q = 0; q < 2 * ring; ++q) {
      bar_init(full + q, 1);
      // one arrive per warp of the ring's consumers
      bar_init(empty + q, kPair ? 8 : 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the ring's loader (the block's first thread where kPair, else each
  // warpgroup's) keeps it filled: item it is K panel it % KP of column
  // block it / KP % NB of head h0 + it / (KP NB), beside the K panel of
  // Wv_h for the first block
  const bool loader = kPair ? threadIdx.x == 0 : threadIdx.x % 128 == 0;
  const int items = kHeads * NB * KP;
  auto load_stage = [&](int it) {
    const int hh = it / (NB * KP), ib = it / KP % NB, kp = it % KP, s = it % ring;
    const int h = h0 + hh;
    const bool wv = ib == 0;
    uint64_t* f = full + rw * ring + s;
    bar_expect(f, kQBytes + (wv ? kWBytes : 0));
    tma_load(stage(s), &tm_q, f, h * I + ib * kIB, kp * 64);
    if (wv) tma_load(stage(s) + kQBytes, &tm_w, f, C + h * kHD, kp * 64);
  };
  if (threadIdx.x == 0) {
    bar_expect(yfull, KP * TR * 128);
    for (int p = 0; p < KP; ++p) {
#pragma unroll
      for (int half = 0; half < TR / kTM; ++half) {
        tma_load(y + (p * TR + half * kTM) * 128, &tm_y, yfull, tile * TR + half * kTM, p * 64);
      }
    }
  }
  if (loader) {
    for (int it = 0; it < ring && it < items; ++it) load_stage(it);
  }
  unsigned char* dpk = smem + L.dpk + w * kOp;  // the dpool_h block [64 inducers, 48]
  unsigned char* dpt = smem + L.dpt + w * kDpt; // its transpose [48, 64 inducers]
  float* stat = reinterpret_cast<float*>(smem + L.stat) + w * 3 * kIB;  // M, 1/L, t
  const int tq = threadIdx.x % 128;
  bar_wait(yfull, 0);

  const int col = 2 * (lane % 4);       // first column of the thread's pairs
  const int r = wi * 16 + lane / 4;     // the thread's rows r and r + 8
  // whether rows r and r + 8 are points (not a ragged tail's padding)
  const bool ok0 = !kMask || n0 + r < n_valid, ok1 = !kMask || n0 + r + 8 < n_valid;
  const size_t row0 = (size_t)b * N + n0;  // the warpgroup's first row of [B N, .]
  // the warpgroup's rows of the y tile
  unsigned char* yw = y + (kPair ? w * kTM * 128 : 0);
  int it = 0;
  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = h0 + hh;
    float dv[kHD / 2];
    zero(dv);
    // bf16 v_h as the dp product's A operand: va[4 kk + j] holds columns
    // 16 kk .. 16 kk + 15 (the accumulator's pairs, hopper.cuh wgmma_rs)
    uint32_t va[kHD / 4];
    for (int ib = 0; ib < NB; ++ib) {
      const int i_base = ib * kIB;  // the block's first inducer of head h
      const bool with_v = ib == 0;
      const size_t jb = (size_t)b * J + (size_t)h * I + i_base;
      // every warp of the warpgroup is done with the last block's operands
      // and statistics; the block's rows of dpool_h (0 past I) and its
      // columns' M, L and t are fetched behind the logits' products
      named_sync(2 + w, 128);
      for (int t = tq; t < kIB * (kHD / 8); t += 128) {
        const int i = t / (kHD / 8), q = (t % (kHD / 8)) * 8;
        const bool in = i_base + i < I;
        copy16_async(dpk + swz(i, q, kOp),
                     in ? dpool + ((size_t)b * I + i_base + i) * C + (size_t)h * kHD + q : dpool,
                     !in);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float st_m = 0.0f, st_l = 1.0f, st_t = 0.0f;
      if (tq < kIB && i_base + tq < I) {
        st_m = __ldg(macc + jb + tq);
        st_l = __ldg(sacc + jb + tq);
        st_t = __ldg(tacc + jb + tq);
      }
      // the logits s = y @ qf_h (64 columns) and, with_v, v = y @ Wv_h^T:
      // one m64n112 product, the stage's qf^T panel and the Wv_h panel
      // after it read as one K-major operand of 64 + 48 rows (sv holds s
      // in its first 32 registers, v in the rest)
      float sv[(kIB + kHD) / 2];
      float(&s_acc)[kIB / 2] = *reinterpret_cast<float(*)[kIB / 2]>(sv);
      float(&v_acc)[kHD / 2] = *reinterpret_cast<float(*)[kHD / 2]>(sv + kIB / 2);
      for (int kp = 0; kp < KP; ++kp, ++it) {
        const int s = it % ring;
        bar_wait(full + rw * ring + s, (it / ring) & 1);
        const uint64_t dq = desc(stage(s)), dyt = desc(yw + kp * TR * 128);
        wgmma_fence();
        if (with_v) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss<kIB + kHD>(sv, dyt + 2 * kk, dq + 2 * kk, (kp | kk) != 0);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss<kIB>(s_acc, dyt + 2 * kk, dq + 2 * kk, (kp | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sv);
        if (lane == 0) bar_arrive(empty + rw * ring + s);
        // refill the stage once all its consumers' warps are done with it
        if (loader && it + ring < items) {
          bar_wait(empty + rw * ring + s, (it / ring) & 1);
          load_stage(it + ring);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (tq < kIB) {
        stat[tq] = st_m;
        stat[kIB + tq] = 1.0f / st_l;
        stat[2 * kIB + tq] = st_t;
      }
      if (with_v) {
#pragma unroll
        for (int j = 0; j < kHD / 4; ++j) va[j] = pack_bf16(v_acc[2 * j], v_acc[2 * j + 1]);
      }
      // every warp's dpool rows and statistics are in
      named_sync(2 + w, 128);
      // dpool_h^T: element (d, i)
      for (int t = tq; t < kIB * (kHD / 8); t += 128) {
        const int i = t / (kHD / 8), q = (t % (kHD / 8)) * 8;
        const int4 raw = *reinterpret_cast<const int4*>(dpk + swz(i, q, kOp));
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) *reinterpret_cast<bf16*>(dpt + swz(q + e, i, kOp)) = v[e];
      }
      // z = s - M (kept in s_acc), p = bf16(exp(max(z, -80)) (1/L)), 0 on
      // the padding and past I, as bf16 pairs: the dv product's A operand
      // (pa[4 kk + j], as va) and ds's p
      uint32_t pa[kIB / 4];
#pragma unroll
      for (int j = 0; j < kIB / 4; ++j) {
        // columns 8 (j / 2) + col + {0, 1}, row r (j even) or r + 8
        const int i = 8 * (j / 2) + col, q = 2 * j;
        const bool in = i_base + i < I, ok = j % 2 == 0 ? ok0 : ok1;
        s_acc[q] -= stat[i];
        s_acc[q + 1] -= stat[i + 1];
        pa[j] = ok && in ? pack_bf16(expf(fmaxf(s_acc[q], -80.0f)) * stat[kIB + i],
                                     expf(fmaxf(s_acc[q + 1], -80.0f)) * stat[kIB + i + 1])
                         : 0u;
      }
      fence_async_smem();
      named_sync(2 + w, 128);

      // dp = bf16(v_h) dpool_h^T [64 points, 64 inducers], depth 48;
      // dv += bf16(p) dpool_h [64 points, 48], depth 64: A from registers
      float dp[kIB / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        wgmma_rs(dp, *reinterpret_cast<const uint32_t(*)[4]>(va + 4 * kk), desc(dpk) + 2 * kk,
                 kk != 0);
      }
#pragma unroll
      for (int kk = 0; kk < kIB / 16; ++kk) {
        wgmma_rs(dv, *reinterpret_cast<const uint32_t(*)[4]>(pa + 4 * kk), desc(dpt) + 2 * kk,
                 (ib | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      fence_regs(dv);

      // ds = bf16(p (dp - t) [z > -80]) on the block's columns below I
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int i = 8 * g + col;
        if (i_base + i < I) {
          const float t0 = stat[2 * kIB + i], t1 = stat[2 * kIB + i + 1];
          const int q = 4 * g;
          const float2 p0 = unpack_bf16(pa[2 * g]), p1 = unpack_bf16(pa[2 * g + 1]);
          const float d00 = s_acc[q] > -80.0f ? p0.x * (dp[q] - t0) : 0.0f;
          const float d01 = s_acc[q + 1] > -80.0f ? p0.y * (dp[q + 1] - t1) : 0.0f;
          const float d10 = s_acc[q + 2] > -80.0f ? p1.x * (dp[q + 2] - t0) : 0.0f;
          const float d11 = s_acc[q + 3] > -80.0f ? p1.y * (dp[q + 3] - t1) : 0.0f;
          const size_t c = (size_t)h * I + i_base + i;
          *reinterpret_cast<__nv_bfloat162*>(ds_out + (row0 + r) * J + c) =
              __floats2bfloat162_rn(d00, d01);
          *reinterpret_cast<__nv_bfloat162*>(ds_out + (row0 + r + 8) * J + c) =
              __floats2bfloat162_rn(d10, d11);
        }
      }
    }
    // dv_h = bf16 of the blocks' sum
#pragma unroll
    for (int g = 0; g < kHD / 8; ++g) {
      const size_t c = (size_t)h * kHD + 8 * g + col;
      *reinterpret_cast<__nv_bfloat162*>(dv_out + (row0 + r) * C + c) =
          __floats2bfloat162_rn(dv[4 * g], dv[4 * g + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + (row0 + r + 8) * C + c) =
          __floats2bfloat162_rn(dv[4 * g + 2], dv[4 * g + 3]);
    }
  }
}

// dx with the pre-norm, one block per (64-point tile, b), from the fp32 dy
// and the column sums dsum [B, 2, C] (sum_n dy xc, sum_n dy); shared memory:
// the per-channel coefficients [3, C] of dx = dy a + x bx + c0. The tile-0
// blocks write dscale and dbias.
__global__ void __launch_bounds__(kThreads)
layer_bwd_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ scale, const float* __restrict__ gmean,
                    const float* __restrict__ ginv, const float* __restrict__ dsum,
                    bf16* __restrict__ dx, float* __restrict__ dscale, float* __restrict__ dbias,
                    int N, int n_valid, int C, int G) {
  extern __shared__ float coef[];
  const int b = blockIdx.y, pg = C / G;
  const float count = (float)n_valid * (float)pg;
  const size_t off = (size_t)b * C;
  const float* sxc = dsum + (size_t)b * 2 * C;  // sum_n dy xc
  const float* s1 = sxc + C;                     // sum_n dy
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g0 = (c / pg) * pg;
    float dinv_g = 0.0f, dmean_g = 0.0f;
    for (int q = g0; q < g0 + pg; ++q) {
      dinv_g += sxc[q] * scale[off + q] + ginv[off + q];
      dmean_g += -s1[q] * (inv[off + q] * scale[off + q]) + gmean[off + q];
    }
    const float inv_g = inv[off + c], mean_g = mean[off + c];
    const float dvar_g = -0.5f * inv_g * inv_g * inv_g * dinv_g;
    dmean_g -= 2.0f * mean_g * dvar_g;
    coef[c] = inv_g * scale[off + c];
    coef[C + c] = 2.0f * (dvar_g / count);
    coef[2 * C + c] = dmean_g / count;
    if (blockIdx.x == 0) {
      dscale[off + c] = sxc[c] * inv_g;
      dbias[off + c] = s1[c];
    }
  }
  __syncthreads();
  const size_t base = ((size_t)b * N + (size_t)blockIdx.x * kDxTile) * C;
  for (int t = threadIdx.x; t < kDxTile * C; t += kThreads) {
    const int c = t % C;
    const size_t e = base + t;
    dx[e] = __float2bfloat16(dy[e] * coef[c] + __bfloat162float(x[e]) * coef[C + c] +
                             coef[2 * C + c]);
  }
}

// The shapes this body takes (folded_attention.py _pool_layer_bwd_body:
// change both together): D 48 with H % 8 == 0 (a block's two warpgroups of
// four heads), C 384 or 768 (the GEMMs' 192-column tiles and wgrad.cuh's
// 128-row ones), any I % 16 == 0 (in blocks of 64 columns), B I % 64 == 0
// (wgrad.cuh's 64-row tiles), N a multiple of the GEMMs' 128-row block.
inline bool body_takes(int B, int N, int C, int H, int I) {
  return H > 0 && C % H == 0 && C / H == kHD && H % kGroup == 0 && (C == 384 || C == 768) &&
         I > 0 && I % 16 == 0 && (B * I) % 64 == 0 && N % mlp::kRows == 0 && B >= 1;
}

}  // namespace

// y is the forward's pre-normed stream (x itself without the pre-norm), qft
// [J, C] the folded query transposed, gh [Mg, C] bf16 the cotangent of h0
// with its B I rows zero-padded to Mg (a multiple of 128), pacc [B, I, C]
// the forward's fp32 P. Scratch: dpool [Mg, C] and merged [B I, C] bf16,
// tacc [B, J] fp32, ds [B N, J] and dv [B N, C] bf16, wpart the weight
// gradients' split partials (s_qf, s_wv, s_wo splits). With the pre-norm
// (mean non-null) dy [B N, C], part [B N / 128, 2, C] and dsum [B, 2, C] fp32
// are scratch as well and dscale, dbias are written; without, all five are
// null and dx comes from the dy product. dqf [C, J], dwv [C, C] (Wv's
// layout, [D out, C in] per head) and dwo [C, C] are written.
extern "C" int pool_layer_bwd_launch(
    const void* x, const void* mean, const void* inv, const void* scale, const void* y,
    const void* qft, const void* kvw, const void* wo, const void* gh, const void* gmean,
    const void* ginv, const void* macc, const void* sacc, const void* pacc, void* dpool,
    void* tacc, void* merged, void* ds, void* dv, void* dy, void* part, void* dsum, void* dx,
    void* dscale, void* dbias, void* wpart, void* dqf, void* dwv, void* dwo, int B, int N, int C,
    int H, int I, int G, int Mg, int s_qf, int s_wv, int s_wo, int n_valid, void* stream) {
  using namespace mlp;
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I;
  const bool prenorm = mean != nullptr;
  if (!body_takes(B, N, C, H, I) || (prenorm && (G <= 0 || C % G)) || n_valid < 1 ||
      n_valid > N || Mg % kRows || Mg < B * I) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * N;
  cudaError_t err;
  // 1. dpool = bf16(g Wo) [Mg, C]; t and merged; dWo = g^T merged
  {
    CUtensorMap tm_g, tm_wo;
    if (!tmap(&tm_g, gh, Mg, C, 64) || !tmap(&tm_wo, wo, C, C, 64)) {
      return (int)cudaErrorInvalidValue;
    }
    MlpEpi e{};
    e.K = C;
    e.N = C;
    e.rows_b = Mg;
    e.out = (bf16*)dpool;
    e.split = C;
    if ((err = launch_gemm<kBnWide, kKV, kStagesWide>(layer_bwd_dpool_kernel, tm_g, tm_wo, tm_g,
                                                      tm_wo, e, Mg, st)) != cudaSuccess) {
      return (int)err;
    }
  }
  {
    const long long warps = (long long)B * I * H;
    layer_bwd_t_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        (const bf16*)dpool, (const float*)pacc, (float*)tacc, (bf16*)merged, B, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if ((err = launch_wgrad(gh, merged, (float*)wpart, (float*)dwo, row_major(C, C), 1, B * I, C,
                          C, s_wo, st)) != cudaSuccess) {
    return (int)err;
  }
  // 2. the main pass: ds and dv
  {
    CUtensorMap tm_y, tm_q, tm_w;
    if (!tmap(&tm_y, y, M, C, kTM) || !tmap(&tm_q, qft, J, C, kIB) ||
        !tmap(&tm_w, kvw, 2LL * C, C, kHD)) {
      return (int)cudaErrorInvalidValue;
    }
    const PassSmem L(C);
    const bool mask = n_valid < N;
    const auto kernel = L.pair ? (mask ? layer_bwd_pass_kernel<true, true>
                                       : layer_bwd_pass_kernel<false, true>)
                               : (mask ? layer_bwd_pass_kernel<true, false>
                                       : layer_bwd_pass_kernel<false, false>);
    if ((err = set_smem((const void*)kernel, L.total)) != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)(M / L.rows), H / kGroup), kPassThreads, L.total, st>>>(
        tm_y, tm_q, tm_w, (const float*)macc, (const float*)sacc, (const float*)tacc,
        (const bf16*)dpool, (bf16*)ds, (bf16*)dv, N, n_valid, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 3. dy = ds qf^T + dv Wv: dx, or the fp32 dy and its column sums
  {
    CUtensorMap tm_ds, tm_qn, tm_dv, tm_wn;
    if (!tmap(&tm_ds, ds, M, J, 64) || !tmap(&tm_qn, qft, J, C, 64) ||
        !tmap(&tm_dv, dv, M, C, 64) || !tmap(&tm_wn, (const bf16*)kvw + (size_t)C * C, C, C, 64)) {
      return (int)cudaErrorInvalidValue;
    }
    MlpEpi e{};
    e.K = J;
    e.K2 = C;
    e.N = C;
    e.rows_b = N;
    if (prenorm) {
      e.gp = (float*)dy;
      e.x = (const bf16*)x;
      e.mean = (const float*)mean;
      e.part = (float*)part;
    } else {
      e.out = (bf16*)dx;
    }
    if ((err = launch_gemm<kBnWide, kDy, kStagesWide>(layer_bwd_dy_kernel, tm_ds, tm_qn, tm_dv,
                                                      tm_wn, e, M, st)) != cudaSuccess) {
      return (int)err;
    }
  }
  if (prenorm) {
    if ((err = launch_colsum((const float*)part, (float*)dsum, B, N / kRows, 2, C, st)) !=
        cudaSuccess) {
      return (int)err;
    }
    layer_bwd_dx_kernel<<<dim3(N / kDxTile, B), kThreads, (size_t)3 * C * 4, st>>>(
        (const bf16*)x, (const float*)dy, (const float*)mean, (const float*)inv,
        (const float*)scale, (const float*)gmean, (const float*)ginv, (const float*)dsum,
        (bf16*)dx, (float*)dscale, (float*)dbias, N, n_valid, C, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 4. dqf = y^T ds [C, J], dWv = dv^T y [C, C] over the B N rows
  if ((err = launch_wgrad(y, ds, (float*)wpart, (float*)dqf, row_major(C, J), 1, (int)M, C, J,
                          s_qf, st)) != cudaSuccess) {
    return (int)err;
  }
  return (int)launch_wgrad(dv, y, (float*)wpart, (float*)dwv, row_major(C, C), 1, (int)M, C, C,
                           s_wv, st);
}
