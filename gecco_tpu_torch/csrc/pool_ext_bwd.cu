// Backward of the tiled online-softmax attention pool (folded_pool_ext):
// the Hopper body (TMA and wgmma), the train step's.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel_v3
// (the "fold everything" body that _pool_bwd_mode picks at the flagship,
// the 8k width, the upsample demo's width and three heads), with the same
// algebra and the same bf16 roundings. With
// y = bf16(x * se + be), s = y @ qf [N, J] (qf^T = qft, the forward's
// folded query), the forward's column max macc and sum sacc [J],
// e = exp(max(s - macc, -80)) and the cotangent g_h0 [I, C], per batch
// element b:
//   eTy  = bf16(bf16(e)^T y)                               [J, C]  pass 0
//   DMs[hI+i, :] = bf16((g_h0 @ Wo_h)[i] / sacc)            [J, D]  fold
//   pacc = eTy @ Wv^T (head-diagonal blocks);  tacc = rowsum(DMs * pacc) / sacc
//   dWo += g_h0^T bf16(pacc / sacc);  dWv += DMs^T eTy
//   W3 = bf16(DMs Wv) [J, C]  (the v3 algebra's W2 = bf16(Wv^T DMs^T) is
//        W3^T: the same fp32 sums, so pass 1 reads W3 for both)
//   ds = e * (y @ W3^T - tacc) * [s - macc > -80]           pass 1
//   dy = bf16(ds) @ qf^T + bf16(e) @ W3;  dx = bf16(dy * se)
//   dse += sum dy * x;  dbe += sum dy
//   dqf = sum over b and the points of y^T bf16(ds)          [C, J]
// The caller chains dqf to the inducers and Wk (plain PyTorch).
//
// A ragged N comes zero-padded to a multiple of 128 by the wrapper: e and
// ds are zero on the points from n_valid on, so the padding adds nothing to
// eTy, dse, dbe or dqf.
//
// Bound on the H100: tensor-core operations (six [N, C] x [C, J]-sized
// products per batch element, hundreds of FLOP per byte moved).
//
// Shapes: I == 64, C in (128, 384, 768), D = C / H a multiple of 16 and
// the fold's block within the SM's shared memory (backward.cuh
// pool_bwd_fold_smem): the flagship (C 384, 8 heads of 48), the 8k width
// (C 768, 16 of 48), the upsample demo's width (C 128, 4 of 32) and three
// heads (C 384, 3 of 128, J 192: pass 1 walks J in 64-row chunks and the
// dqf product takes a 64-column tail). No pass needs D <= 64 or J % 128
// == 0: the fold takes a head's rows in 64-row blocks at any D % 16 and
// the weight gradients a 64-column tail. The rest (I != 64, C 256, 512,
// 640) take csrc/pool_ext_bwd_wmma.cu.
//
// Design (six launches):
// 0. prenorm_kernel (backward.cuh): y = bf16(x * se + be) [B, N, C] once,
//    which the three products below read by TMA (each would otherwise
//    pre-norm its tiles again: pass 0 once per head).
// 1. pool_bwd_ety_kernel<CB>, one block per (head h, b, CB columns of C):
//    the TMA brings the head's qf^T_h [64, C] once and y in 64-point tiles
//    through a ring (three stages at C 128 and 384, one at 768). The
//    first of two warpgroups forms the head's logits by one m64n64 wgmma
//    into registers (two narrower ones would read the tile from shared
//    memory twice) and e there, and writes bf16 e^T to shared memory; then
//    both add e^T @ y into their CB / 2 columns of eTy_h (a [64, CB / 2]
//    fp32 accumulator each: 96 registers a thread at CB 384, 32 at 128), y
//    read MN-major by wgmma straight from the TMA tile. The accumulator
//    leaves registers once, as bf16 eTy. CB is 384 at C 384 and 768, 128
//    at C 128, whose grid (H x B = 192 blocks at the demo, each walking
//    its element's 32 tiles) would leave a third of the SMs idle at one
//    block a SM: its blocks run two a SM.
// 2. pool_bwd_fold_kernel (backward.cuh, WMMA, one block per (head, b)):
//    DMs, pacc, tacc, W3 and the dWo/dWv blocks by fp32 atomics.
// 3. pool_bwd_dy_kernel<CB, JC>, one block per (64-point tile, b, CB
//    columns): the y tile by TMA; J in chunks of JC rows (64 at C 128 and
//    384, 32 at 768) of qf^T and W3_b by TMA. Per chunk the first
//    warpgroup forms s and the second y @ W3^T, each one wgmma of the
//    chunk's width, the second's handed over through shared memory; the
//    first forms e and ds in registers, bf16 into shared memory (and ds to
//    device memory for the dqf product); both then add bf16(ds) @ qf^T +
//    bf16(e) @ W3 into their CB / 2 columns of dy, the chunk read MN-major.
//    The epilogue takes dx, dse and dbe from the registers (one fp32
//    atomic per column and block for the sums). At C 768 two blocks share
//    a tile, each forming the tile's logits again for its half of dy (a
//    [64, 768] accumulator does not fit); at C 128 two blocks share a SM.
// 4. wgrad_kernel (wgrad.cuh), one block per (128 columns of J, 128 rows
//    of C, split of the B*N points): y^T and ds by TMA through a
//    four-stage ring, both read MN-major by wgmma; each split writes its
//    fp32 partial [C, J] tile (one split writes dqf itself).
// 5. wgrad_sum_kernel: dqf = the partials summed in split order, so dqf is
//    the same bits from run to run (dWv, dWo, dse and dbe come from fp32
//    atomics and vary at their rounding).
#include <cmath>

#include "backward.cuh"
#include "hopper.cuh"
#include "wgrad.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kInd = 64;             // inducers per head (I)
constexpr int kTile = 64;            // points per tile: one 64-row m-block
constexpr int kPanel = kTile * 128;  // one 64-column panel of a 64-row tile
constexpr int kBwdThreads = 256;     // two consumer warpgroups

// The constants of a column block: CB columns of C a block (eTy, dy), CB /
// 2 a consumer warpgroup. <384> is the flagship's, the 8k width's and three
// heads'; <128> the upsample demo's, whose blocks (64-column accumulators)
// share a SM two at a time, within the 128 registers a thread that leaves:
// on the H100 one block a SM (no spill) took pass 0 from 0.065 to 0.084 ms
// at the demo and pass 1 from 0.144 to 0.161, where both spill ~110 bytes
// at two (PERF.md row 8).
template <int CB>
struct Cols {
  static constexpr int kHalf = CB / 2;
  static constexpr int kMinBlocks = CB == 128 ? 2 : 1;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~(uintptr_t)1023);
}

// ------------------------------------------------------------- pass 0 --

// Shared memory of pool_bwd_ety_kernel, in bytes from a 1024-aligned base.
struct EtySmem {
  int q, ring, et, bars, total;
  __host__ __device__ EtySmem(int C, int stages) {
    q = 0;
    ring = q + (C / 64) * kPanel;
    et = ring + stages * (C / 64) * kPanel;
    bars = et + kPanel;
    total = bars + (1 + stages) * 8 + 1024;  // + alignment slack
  }
};

// kMask (here and in pool_bwd_dy_kernel): the tiles may hold a ragged
// tail's padding (n_valid < N); without it the masks fold away (they cost
// the backward ~17% at N 2048 on the H100)
template <int CB, bool kMask>
__global__ void __launch_bounds__(kBwdThreads, Cols<CB>::kMinBlocks)
pool_bwd_ety_kernel(const __grid_constant__ CUtensorMap tm_y,
                    const __grid_constant__ CUtensorMap tm_q,
                    const float* __restrict__ macc, bf16* __restrict__ ety, int N, int n_valid,
                    int C, int J, int stages) {
  constexpr int kHalf = Cols<CB>::kHalf;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const EtySmem L(C, stages);
  // the tiles holding points (a ragged tail's padding tiles add nothing)
  const int KP = C / 64, T = (n_valid + kTile - 1) / kTile, tile_bytes = KP * kPanel;
  const int h = blockIdx.x, b = blockIdx.y, cs = blockIdx.z;
  unsigned char* qs = smem + L.q;
  unsigned char* et = smem + L.et;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* yfull = qfull + 1;  // [stages]
  auto ystage = [&](int s) { return smem + L.ring + s * tile_bytes; };
  auto load_tile = [&](int t) {
    const int s = t % stages;
    bar_expect(yfull + s, tile_bytes);
    for (int p = 0; p < KP; ++p) {
      tma_load(ystage(s) + p * kPanel, &tm_y, yfull + s, b * N + t * kTile, p * 64);
    }
  };
  if (threadIdx.x == 0) {
    bar_init(qfull, 1);
    for (int s = 0; s < stages; ++s) bar_init(yfull + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(qfull, tile_bytes);
    for (int p = 0; p < KP; ++p) tma_load(qs + p * kPanel, &tm_q, qfull, h * kInd, p * 64);
    for (int t = 0; t < stages && t < T; ++t) load_tile(t);
  }

  const int w = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);   // first column of the thread's pairs
  const int r = wi * 16 + lane / 4;  // the thread's accumulator rows r and r + 8
  // macc of the thread's logit columns (warpgroup 0): inducers 8g + col + {0, 1}
  const float* mb = macc + (size_t)b * J + h * kInd;
  float mcol[16];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    mcol[2 * g] = __ldg(mb + 8 * g + col);
    mcol[2 * g + 1] = __ldg(mb + 8 * g + col + 1);
  }
  const int cb0 = cs * CB + w * kHalf;  // the warpgroup's first column of eTy
  float acc[kHalf / 2];
  zero(acc);
  bar_wait(qfull, 0);
  for (int t = 0; t < T; ++t) {
    const int s = t % stages;
    unsigned char* y = ystage(s);
    bar_wait(yfull + s, (t / stages) & 1);
    if (w == 0) {
      // the head's logits over all C (one m64n64 product: a narrower one per
      // warpgroup would read the tile twice from shared memory), then bf16
      // e^T [I, 64 points]
      float sacc[32];
      wgmma_fence();
      for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tt<0, 0>(sacc, desc(y + kp * kPanel) + 2 * kk, desc(qs + kp * kPanel) + 2 * kk,
                         (kp | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      // e is zero on the padding rows from n_valid on
      const bool ok0 = !kMask || t * kTile + r < n_valid;
      const bool ok1 = !kMask || t * kTile + r + 8 < n_valid;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * g + col + e;
          const float m = mcol[2 * g + e];
          *reinterpret_cast<bf16*>(et + swz(i, r, kPanel)) =
              __float2bfloat16(ok0 ? expf(fmaxf(sacc[4 * g + e] - m, -80.0f)) : 0.0f);
          *reinterpret_cast<bf16*>(et + swz(i, r + 8, kPanel)) =
              __float2bfloat16(ok1 ? expf(fmaxf(sacc[4 * g + 2 + e] - m, -80.0f)) : 0.0f);
        }
      }
      fence_async_smem();
    }
    __syncthreads();

    // eTy[:, cb0 .. cb0 + CB / 2] += e^T @ y, y read MN-major from the tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tt<0, 1>(acc, desc(et) + 2 * kk,
                     desc_mn(y + (cb0 / 64) * kPanel + kk * 2048, kPanel), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // both warpgroups are done with stage s and e^T
    if (threadIdx.x == 0 && t + stages < T) load_tile(t + stages);
  }

  bf16* out = ety + ((size_t)b * J + h * kInd) * C + cb0;
#pragma unroll
  for (int g = 0; g < kHalf / 8; ++g) {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * C + 8 * g + col) =
        __floats2bfloat162_rn(acc[4 * g], acc[4 * g + 1]);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8) * C + 8 * g + col) =
        __floats2bfloat162_rn(acc[4 * g + 2], acc[4 * g + 3]);
  }
}

// ------------------------------------------------------------- pass 1 --

// Shared memory of pool_bwd_dy_kernel: the stream tile, the chunk's qf^T
// and W3 rows, bf16 ds and e [64, JC] (whose 16 KB the epilogue's column
// sums reuse), the barriers. One chunk buffer: two (32-row chunks, so that
// the next loads while one computes) ran 7% slower at the flagship on the
// H100, the narrower logits products costing more than the hidden loads;
// at C 128 two 64-row chunk buffers took pass 1 from 0.140 to 0.144 ms.
struct DySmem {
  int y, qc, wc, ds, e, bars, total;
  __host__ __device__ DySmem(int C, int JC) {
    y = 0;
    qc = y + (C / 64) * kPanel;
    wc = qc + (C / 64) * JC * 128;
    ds = wc + (C / 64) * JC * 128;
    e = ds + kPanel;
    bars = e + kPanel;
    total = bars + 2 * 8 + 1024;  // + alignment slack
  }
};

template <int CB, int JC, bool kMask>
__global__ void __launch_bounds__(kBwdThreads, Cols<CB>::kMinBlocks)
pool_bwd_dy_kernel(const __grid_constant__ CUtensorMap tm_y,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ x,
                   const float* __restrict__ se, const float* __restrict__ macc,
                   const float* __restrict__ tacc, bf16* __restrict__ ds_out,
                   bf16* __restrict__ dx, float* __restrict__ dse, float* __restrict__ dbe, int N,
                   int n_valid, int C, int J) {
  constexpr int kHalf = Cols<CB>::kHalf;
  constexpr int JH = JC / 2;    // logit columns per warpgroup
  constexpr int CP = JC * 128;  // bytes of one 64-column panel of a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const DySmem L(C, JC);
  const int KP = C / 64, nch = J / JC;
  const int tile = blockIdx.x, b = blockIdx.y, cs = blockIdx.z;
  const int row0 = b * N + tile * kTile;
  unsigned char* y = smem + L.y;
  unsigned char* dss = smem + L.ds;
  unsigned char* es = smem + L.e;
  unsigned char* qc = smem + L.qc;
  unsigned char* wc = smem + L.wc;
  uint64_t* yfull = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* cfull = yfull + 1;
  auto load_chunk = [&](int c) {
    bar_expect(cfull, 2 * KP * CP);
    for (int p = 0; p < KP; ++p) {
      tma_load(qc + p * CP, &tm_q, cfull, c * JC, p * 64);
      tma_load(wc + p * CP, &tm_w, cfull, b * J + c * JC, p * 64);
    }
  };
  if (threadIdx.x == 0) {
    bar_init(yfull, 1);
    bar_init(cfull, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(yfull, KP * kPanel);
    for (int p = 0; p < KP; ++p) tma_load(y + p * kPanel, &tm_y, yfull, row0, p * 64);
    load_chunk(0);
  }
  const float* mb = macc + (size_t)b * J;
  const float* tb = tacc + (size_t)b * J;
  const int w = threadIdx.x / 128, t128 = threadIdx.x % 128, wi = t128 / 32, lane = t128 % 32;
  const int col = 2 * (lane % 4), r = wi * 16 + lane / 4;
  const int cb0 = cs * CB + w * kHalf;  // the warpgroup's first column of dy
  bar_wait(yfull, 0);

  float dy[kHalf / 2];
  zero(dy);
  for (int c = 0; c < nch; ++c) {
    bar_wait(cfull, c & 1);
    // s and y @ W3^T for the warpgroup's JH columns of the chunk
    float sa[JH / 2], pa[JH / 2];
    wgmma_fence();
    for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc(y + kp * kPanel) + 2 * kk;
        wgmma_tt<0, 0>(sa, da, desc(qc + kp * CP + w * JH * 128) + 2 * kk, (kp | kk) != 0);
        wgmma_tt<0, 0>(pa, da, desc(wc + kp * CP + w * JH * 128) + 2 * kk, (kp | kk) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(pa);
    // e and ds: bf16 into shared memory (K-major A operands), ds also to
    // device memory for the dqf product
#pragma unroll
    for (int g = 0; g < JH / 8; ++g) {
      const int jl = w * JH + 8 * g + col;  // column in the chunk
      const int jj = c * JC + jl;           // column of J
      float ev[4], dv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = q % 2;
        const float z = sa[4 * g + q] - __ldg(mb + jj + e);
        // e and ds are zero on the padding rows from n_valid on
        const bool ok = !kMask || tile * kTile + r + 8 * (q / 2) < n_valid;
        ev[q] = ok ? expf(fmaxf(z, -80.0f)) : 0.0f;
        dv[q] = ok && z > -80.0f ? ev[q] * (pa[4 * g + q] - __ldg(tb + jj + e)) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = r + 8 * (q / 2), cc = jl + q % 2;
        *reinterpret_cast<bf16*>(es + swz(rr, cc, kPanel)) = __float2bfloat16(ev[q]);
        *reinterpret_cast<bf16*>(dss + swz(rr, cc, kPanel)) = __float2bfloat16(dv[q]);
      }
      if (cs == 0) {
        *reinterpret_cast<__nv_bfloat162*>(ds_out + (size_t)(row0 + r) * J + jj) =
            __floats2bfloat162_rn(dv[0], dv[1]);
        *reinterpret_cast<__nv_bfloat162*>(ds_out + (size_t)(row0 + r + 8) * J + jj) =
            __floats2bfloat162_rn(dv[2], dv[3]);
      }
    }
    fence_async_smem();
    __syncthreads();

    // dy[:, cb0 .. cb0 + CB / 2] += bf16(ds) @ qf^T + bf16(e) @ W3, the chunk
    // read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < JC / 16; ++kk) {
      wgmma_tt<0, 1>(dy, desc(dss) + 2 * kk, desc_mn(qc + (cb0 / 64) * CP + kk * 2048, CP), 1);
      wgmma_tt<0, 1>(dy, desc(es) + 2 * kk, desc_mn(wc + (cb0 / 64) * CP + kk * 2048, CP), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dy);
    __syncthreads();  // both warpgroups are done with the chunk, ds and e
    if (threadIdx.x == 0 && c + 1 < nch) load_chunk(c + 1);
  }

  // dx = bf16(dy * se); the column sums of dy * x and dy over the tile's
  // rows: shuffles over a warp's rows, then the four warps through shared
  // memory (the ds/e tiles), one atomic per column and block
  float* red = reinterpret_cast<float*>(dss) + w * 2 * 4 * kHalf;  // [2][4 warps][CB / 2]
  const float* seb = se + (size_t)b * C;
  const bf16* xrow = x + (size_t)row0 * C;
  bf16* dxb = dx + (size_t)row0 * C;
#pragma unroll
  for (int g = 0; g < kHalf / 8; ++g) {
    const int cc = cb0 + 8 * g + col;
    const float s0 = __ldg(seb + cc), s1 = __ldg(seb + cc + 1);
    const float2 x0 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xrow + (size_t)r * C + cc));
    const float2 x1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xrow + (size_t)(r + 8) * C + cc));
    const float d0 = dy[4 * g], d1 = dy[4 * g + 1], d2 = dy[4 * g + 2], d3 = dy[4 * g + 3];
    *reinterpret_cast<__nv_bfloat162*>(dxb + (size_t)r * C + cc) =
        __floats2bfloat162_rn(d0 * s0, d1 * s1);
    *reinterpret_cast<__nv_bfloat162*>(dxb + (size_t)(r + 8) * C + cc) =
        __floats2bfloat162_rn(d2 * s0, d3 * s1);
    float v[4] = {d0 * x0.x + d2 * x1.x, d1 * x0.y + d3 * x1.y, d0 + d2, d1 + d3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 4);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 8);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 16);
    }
    if (lane < 4) {
      const int k = 8 * g + col;
      red[wi * kHalf + k] = v[0];
      red[wi * kHalf + k + 1] = v[1];
      red[(4 + wi) * kHalf + k] = v[2];
      red[(4 + wi) * kHalf + k + 1] = v[3];
    }
  }
  named_sync(2 + w, 128);
  for (int k = t128; k < kHalf; k += 128) {
    float a = 0.0f, bsum = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a += red[q * kHalf + k];
      bsum += red[(4 + q) * kHalf + k];
    }
    atomicAdd(dse + (size_t)b * C + cb0 + k, a);
    atomicAdd(dbe + (size_t)b * C + cb0 + k, bsum);
  }
}

}  // namespace

extern "C" int pool_ext_bwd_launch(const void* x, const void* se, const void* be, const void* qft,
                                   const void* kvw, const void* wo, const void* gh,
                                   const void* macc, const void* sacc, void* y, void* ety,
                                   void* w3, void* tacc, void* ds, void* dx, void* dse, void* dbe,
                                   void* dqf_part, void* dqf, void* dwv, void* dwo, int B, int N,
                                   int C, int H, int I, int splits, int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I, D = C / H, KP = C / 64;
  if ((C != 128 && C != 384 && C != 768) || C % H || I != kInd || D % 16 || N % kTile ||
      splits < 1 || n_valid < 1 || n_valid > N) {
    return (int)cudaErrorInvalidValue;
  }
  const bool mask = n_valid < N, narrow = C == 128;
  cudaError_t err;
  CUtensorMap tm_y, tm_q;
  if (encode_tiled(&tm_y, y, (uint64_t)B * N, C, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_q, qft, J, C, kInd) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  // the pre-normed stream
  if ((err = launch_prenorm((const bf16*)x, (const float*)se, (const float*)be, (bf16*)y, B, N,
                            C, st)) != cudaSuccess) {
    return (int)err;
  }

  // pass 0: as many stream stages as fit, up to three (at C 128 two, three
  // and four timed within 2% of each other on the H100)
  {
    int stages = (int)((kMaxSmem - EtySmem(C, 0).total) / (KP * kPanel));
    if (stages > 3) stages = 3;
    if (stages < 1) return (int)cudaErrorInvalidValue;
    const EtySmem L(C, stages);
    const auto ety_kernel =
        narrow ? (mask ? pool_bwd_ety_kernel<128, true> : pool_bwd_ety_kernel<128, false>)
               : (mask ? pool_bwd_ety_kernel<384, true> : pool_bwd_ety_kernel<384, false>);
    if ((err = set_smem((const void*)ety_kernel, L.total)) != cudaSuccess) return (int)err;
    ety_kernel<<<dim3(H, B, narrow ? 1 : C / 384), kBwdThreads, L.total, st>>>(
        tm_y, tm_q, (const float*)macc, (bf16*)ety, N, n_valid, C, J, stages);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // fold (no W2: pass 1 reads W3 for both)
  if ((err = launch_pool_bwd_fold((const bf16*)gh, (const bf16*)wo, (const bf16*)kvw,
                                  (const float*)sacc, (const bf16*)ety, (float*)tacc, (bf16*)w3,
                                  (float*)dwv, (float*)dwo, B, C, H, I, st)) != cudaSuccess) {
    return (int)err;
  }
  // pass 1: chunks of 64 rows of J at C 128 and 384, 32 at C 768 (at C
  // 128, 32 and 128 rows took 7% and 28% longer on the H100)
  {
    const int JC = C == 768 ? 32 : 64;
    CUtensorMap tm_qc, tm_w;
    if (encode_tiled(&tm_qc, qft, J, C, JC) != CUDA_SUCCESS ||
        encode_tiled(&tm_w, w3, (uint64_t)B * J, C, JC) != CUDA_SUCCESS) {
      return (int)cudaErrorInvalidValue;
    }
    const DySmem L(C, JC);
    const auto kernel =
        narrow ? (mask ? pool_bwd_dy_kernel<128, 64, true> : pool_bwd_dy_kernel<128, 64, false>)
        : JC == 64 ? (mask ? pool_bwd_dy_kernel<384, 64, true>
                           : pool_bwd_dy_kernel<384, 64, false>)
                   : (mask ? pool_bwd_dy_kernel<384, 32, true>
                           : pool_bwd_dy_kernel<384, 32, false>);
    if ((err = set_smem((const void*)kernel, L.total)) != cudaSuccess) return (int)err;
    kernel<<<dim3(N / kTile, B, narrow ? 1 : C / 384), kBwdThreads, L.total, st>>>(
        tm_y, tm_qc, tm_w, (const bf16*)x, (const float*)se, (const float*)macc,
        (const float*)tacc, (bf16*)ds, (bf16*)dx, (float*)dse, (float*)dbe, N, n_valid, C, J);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // dqf: split partials, then their sum in split order
  return (int)launch_wgrad(y, ds, (float*)dqf_part, (float*)dqf, row_major(C, J), 1, B * N, C, J,
                           splits, st);
}
