// Folded unpool attention + residual, with the output channel sums.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_kernel (served
// by folded_unpool), with its two flags: ``prenorm`` (with it off, y = x:
// no se fold into wq and no bias row) and ``residual`` (with it off, no x
// add). With y = x * se + be, per batch element b and head h:
//   kft[hI+i, :] = bf16(s * k_h[i] @ bf16(wq_h * se))       [J, C]
//   brow[hI+i]   = s * (be @ wq_h^T) . k_h[i]                [J] fp32
//   vf[hI+i, :]  = bf16(v_h[i] @ wo_h^T)                      [J, C]
// then per point: logits = x @ kft^T + brow; a softmax over each head's
// I-wide block with THAT block's own max (exp argument clamped at -80);
// attn = bf16(p) @ vf; o = x + attn; out = bf16(o); sums[b] += [o | o^2].
//
// Bound on the H100: tensor-core operations (4*N*C*J per batch element
// against 4*N*C bytes of stream: J = 512 FLOP per byte at the flagship).
//
// Design (four launches):
// 1. unpool_bq_kernel: bq = be @ wq^T per batch element (CUDA cores, B*C
//    dot products; only with the pre-norm).
// 2. unpool_fold_k_kernel and unpool_fold_v_kernel, per (64 channels,
//    head, batch element): kft_h and vf_h as depth-D products on the tensor
//    cores (WMMA), wq_h * se rounded to bf16 on its way into shared memory,
//    wo read in place as a column-major operand; vf is written transposed,
//    [B, C, J], so that both operands of the main kernel are K-major; brow
//    beside kft.
// 3. unpool_tile_kernel<NW>, one block per (64-point tile, CB = 2 NW output
//    columns): a producer warpgroup keeps three TMA streams going (the x
//    tile, each consumer's ring of kft_h panels, and a ring of vf_h^T slabs
//    [CB, I], in boxes of CB rows, or of CB / 2 above 256),
//    and two consumer warpgroups split the output columns (CB / 2 each, a
//    [64, CB/2] fp32 accumulator in registers) and take the heads' logits
//    in turn: warpgroup h % 2 forms head h's [64, I] logits by wgmma in
//    registers, adds brow, runs the head's softmax there (row max and sum
//    by shuffles within the four lanes of a row), and writes bf16 p once to
//    shared memory (double-buffered by head parity); both warpgroups then
//    add p @ vf_h into their columns by wgmma. Each warpgroup forms the
//    next head's logits before its product with the current head, so one
//    warpgroup's softmax runs beside the other's product. Per-head
//    processing gives every head block its own max by construction. The
//    epilogue stages the fp32 output in shared memory: o = x + attn, out =
//    bf16(o), and the channel sums by one fp32 atomic per column and block
//    (as csrc/common.cuh's residual_epilogue), over the points before
//    n_valid: a ragged N comes zero-padded to a multiple of 128 by the
//    wrapper, and the padding rows stay out of the sums.
// CB is C at C <= 384 (the flagship: 2048 blocks at B 64, N 2048; the
// upsample demo's C 128: 1536 blocks at B 48) and 192 above (the 8k width's
// C 768: 4 column blocks, each forming the logits again).
// Shapes: I == 64, H even, D = C / H a multiple of 16 up to 64, C % 64 == 0
// up to 384 or C % 192 == 0 above; the rest (three heads, another I) take
// csrc/unpool_wmma.cu.
// The megakernel (csrc/unpool_mlp.cu) keeps unpool.cuh's WMMA device code.
#include <cmath>

#include "hopper.cuh"
#include "unpool_fold.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kInd = 64;   // inducers per head (I)
constexpr int kTile = 64;  // points per block
constexpr int kKRing = 4;  // stages of each consumer's kft ring
constexpr int kVRing = 2;  // stages of the vf ring
constexpr int kPanel = kTile * 128;  // one K panel of 64 rows (x tile, kft_h, p)

struct TileSmem {
  int xs, kring, vring, pbuf, bars, total;
  __host__ __device__ TileSmem(int C, int CB) {
    xs = 0;
    kring = xs + (C / 64) * kPanel;
    vring = kring + 2 * kKRing * kPanel;
    pbuf = vring + kVRing * CB * 128;
    bars = pbuf + 2 * kPanel;
    total = bars + (1 + 4 * kKRing + 4 * kVRing) * 8 + 1024;  // + alignment slack
  }
};

// What a consumer warpgroup of unpool_tile_kernel works on.
struct TileCtx {
  unsigned char *xs, *kring, *vcols, *pbuf;  // vcols: the warpgroup's columns of vf stage 0
  const float* brow;                          // [J] of the tile's batch element
  uint64_t *kfull, *kempty, *vfull, *vempty, *pfull, *pempty;  // kfull/kempty: its own ring
  int KP, CB, lane, col, r0;
};

// Head h's logits x @ kft_h^T + brow, its softmax (the head's own row max,
// exp argument clamped at -80) and bf16 p into p buffer h % 2; kuse counts
// the warpgroup's kft ring stages.
__device__ __forceinline__ void unpool_logits(const TileCtx& t, int w, int h, int& kuse) {
  float s_acc[kInd / 2];
  for (int kp = 0; kp < t.KP; ++kp, ++kuse) {
    const int s = kuse % kKRing;
    bar_wait(t.kfull + s, (kuse / kKRing) & 1);
    const uint64_t dx = desc(t.xs + kp * kPanel), dk = desc(t.kring + (w * kKRing + s) * kPanel);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<kInd>(s_acc, dx + 2 * kk, dk + 2 * kk, (kp | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    if (t.lane == 0) bar_arrive(t.kempty + s);
  }
  const float* bb = t.brow + h * kInd;
  const int col = t.col;
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
  float l0 = 0.0f, l1 = 0.0f;
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
  const int u = h / 2;
  if (u >= 1) bar_wait(t.pempty + h % 2, (u - 1) & 1);
  unsigned char* p = t.pbuf + (h % 2) * kPanel;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int c = 8 * g + col;
    *reinterpret_cast<__nv_bfloat162*>(p + swz(t.r0, c, kPanel)) =
        __floats2bfloat162_rn(s_acc[4 * g] / l0, s_acc[4 * g + 1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(p + swz(t.r0 + 8, c, kPanel)) =
        __floats2bfloat162_rn(s_acc[4 * g + 2] / l1, s_acc[4 * g + 3] / l1);
  }
  fence_async_smem();
  bar_arrive(t.pfull + h % 2);
}

// The warpgroup's output columns += p_h @ vf_h.
template <int NW>
__device__ __forceinline__ void unpool_product(const TileCtx& t, float (&o_acc)[NW / 2], int h) {
  bar_wait(t.pfull + h % 2, (h / 2) & 1);
  const int s = h % kVRing;
  bar_wait(t.vfull + s, (h / kVRing) & 1);
  const uint64_t dp = desc(t.pbuf + (h % 2) * kPanel), dv = desc(t.vcols + s * t.CB * 128);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss<NW>(o_acc, dp + 2 * kk, dv + 2 * kk, (h | kk) != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o_acc);
  if (t.lane == 0) {
    bar_arrive(t.pempty + h % 2);
    bar_arrive(t.vempty + s);
  }
}

// One 64-point tile and CB = 2 * NW output columns per block; the vf slabs
// come in boxes of VBOX rows (TMA's boxes hold at most 256).
template <int NW>
__global__ void __launch_bounds__(384, 1)
unpool_tile_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ x,
                   const float* __restrict__ brow, bf16* __restrict__ out,
                   float* __restrict__ sums, int N, int n_valid, int C, int H, int residual) {
  constexpr int CB = 2 * NW, VBOX = CB <= 256 ? CB : CB / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const TileSmem L(C, CB);
  const int KP = C / 64, J = H * kInd;
  const int row0 = blockIdx.x * kTile, b = row0 / N, cbase = blockIdx.y * CB;
  unsigned char* xs = smem + L.xs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* xfull = bars;
  uint64_t* kfull = bars + 1;             // [2][kKRing]
  uint64_t* kempty = kfull + 2 * kKRing;  // [2][kKRing]
  uint64_t* vfull = kempty + 2 * kKRing;  // [kVRing]
  uint64_t* vempty = vfull + kVRing;      // [kVRing]
  uint64_t* pfull = vempty + kVRing;      // [2]
  uint64_t* pempty = pfull + 2;           // [2]
  auto kstage = [&](int w, int s) { return smem + L.kring + (w * kKRing + s) * kPanel; };
  auto vstage = [&](int s) { return smem + L.vring + s * CB * 128; };

  if (threadIdx.x == 0) {
    bar_init(xfull, 1);
    for (int q = 0; q < 2 * kKRing; ++q) {
      bar_init(kfull + q, 1);
      bar_init(kempty + q, 4);  // the consumer's four warps
    }
    for (int q = 0; q < kVRing; ++q) {
      bar_init(vfull + q, 1);
      bar_init(vempty + q, 8);  // both consumers' warps
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
    // ---- producer: warp 8 the x tile and consumer 0's kft ring, warp 9
    // consumer 1's kft ring, warp 10 the vf ring
    setmaxnreg_dec<24>();
    if (lane == 0 && warp <= 9) {
      const int w = warp - 8;
      if (w == 0) {
        bar_expect(xfull, KP * kPanel);
        for (int p = 0; p < KP; ++p) tma_load(xs + p * kPanel, &tm_x, xfull, row0, p * 64);
      }
      for (int it = 0; it < (H / 2) * KP; ++it) {
        const int h = w + 2 * (it / KP), kp = it % KP, s = it % kKRing;
        if (it >= kKRing) bar_wait(kempty + w * kKRing + s, ((it / kKRing) - 1) & 1);
        bar_expect(kfull + w * kKRing + s, kPanel);
        tma_load(kstage(w, s), &tm_k, kfull + w * kKRing + s, b * J + h * kInd, kp * 64);
      }
    } else if (lane == 0 && warp == 10) {
      for (int h = 0; h < H; ++h) {
        const int s = h % kVRing;
        if (h >= kVRing) bar_wait(vempty + s, ((h / kVRing) - 1) & 1);
        bar_expect(vfull + s, CB * 128);
        for (int r = 0; r < CB; r += VBOX) {
          tma_load(vstage(s) + r * 128, &tm_v, vfull + s, b * C + cbase + r, h * kInd);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns output columns cbase + w*NW ...
    setmaxnreg_inc<240>();
    const int w = wg, wi = warp % 4, col = 2 * (lane % 4), r0 = wi * 16 + lane / 4;
    float o_acc[NW / 2];
    zero(o_acc);
    int kuse = 0;
    bar_wait(xfull, 0);
    const TileCtx t{xs, smem + L.kring, smem + L.vring + w * NW * 128, smem + L.pbuf,
                    brow + (size_t)b * J, kfull + w * kKRing, kempty + w * kKRing, vfull, vempty,
                    pfull, pempty, KP, CB, lane, col, r0};
    if (w == 0) unpool_logits(t, w, 0, kuse);
    for (int h = 0; h < H; ++h) {
      if (h + 1 < H && (h + 1) % 2 == w) unpool_logits(t, w, h + 1, kuse);
      unpool_product<NW>(t, o_acc, h);
    }

    if constexpr (CB <= 128) {
      // epilogue from the registers (a block of at most 128 columns: too
      // little work to stage): o = x + attn with x read from the tile in
      // shared memory, out = bf16(o) stored from the registers, and the
      // column sums over the thread's two rows, the eight lanes of a column
      // by shuffles, the warpgroup's four warps through shared memory (its
      // own kft ring, free once its logits are done), one atomic each per
      // column and block
      float* red = reinterpret_cast<float*>(kstage(w, 0));  // [4 warps][2][NW]
      fence_async_smem();
      // rows from n_valid on (a ragged tail's padding) stay out of the sums
      const int valid = n_valid - row0 % N;
      const bool ok0 = r0 < valid, ok1 = r0 + 8 < valid;
#pragma unroll
      for (int g = 0; g < NW / 8; ++g) {
        const int c = cbase + w * NW + 8 * g + col;
        float2 x0 = make_float2(0.0f, 0.0f), x1 = x0;
        if (residual) {
          x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + swz(r0, c, kPanel)));
          x1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + swz(r0 + 8, c, kPanel)));
        }
        const float o00 = x0.x + o_acc[4 * g], o01 = x0.y + o_acc[4 * g + 1];
        const float o10 = x1.x + o_acc[4 * g + 2], o11 = x1.y + o_acc[4 * g + 3];
        const size_t e0 = (size_t)(row0 + r0) * C + c, e1 = e0 + (size_t)8 * C;
        *reinterpret_cast<__nv_bfloat162*>(out + e0) = __floats2bfloat162_rn(o00, o01);
        *reinterpret_cast<__nv_bfloat162*>(out + e1) = __floats2bfloat162_rn(o10, o11);
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
          const int cw = 8 * g + col;
          *reinterpret_cast<float2*>(red + (wi * 2) * NW + cw) = make_float2(q[0], q[1]);
          *reinterpret_cast<float2*>(red + (wi * 2 + 1) * NW + cw) = make_float2(q[2], q[3]);
        }
      }
      named_sync(2 + w, 128);
      for (int t = threadIdx.x % 128; t < 2 * NW; t += 128) {
        const int k = t / NW, cw = t % NW;
        const float v = red[k * NW + cw] + red[(2 + k) * NW + cw] + red[(4 + k) * NW + cw] +
                        red[(6 + k) * NW + cw];
        atomicAdd(sums + (size_t)b * 2 * C + k * C + cbase + w * NW + cw, v);
      }
    } else {
      // epilogue: the fp32 output through shared memory (over the rings)
      constexpr int ldo = CB + kPadF;
      float* obuf = reinterpret_cast<float*>(smem + L.kring);
      named_sync(1, 256);  // both consumers are done with the rings
      fence_async_smem();
#pragma unroll
      for (int g = 0; g < NW / 8; ++g) {
        const int c = w * NW + 8 * g + col;
        *reinterpret_cast<float2*>(obuf + r0 * ldo + c) = make_float2(o_acc[4 * g], o_acc[4 * g + 1]);
        *reinterpret_cast<float2*>(obuf + (r0 + 8) * ldo + c) =
            make_float2(o_acc[4 * g + 2], o_acc[4 * g + 3]);
      }
      named_sync(1, 256);
      // rows from n_valid on (a ragged tail's padding) stay out of the sums
      const int valid = n_valid - row0 % N;
      for (int c = threadIdx.x; c < CB; c += 256) {
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 16
        for (int r = 0; r < kTile; ++r) {
          const size_t e = (size_t)(row0 + r) * C + cbase + c;
          const float o = (residual ? __bfloat162float(x[e]) : 0.0f) + obuf[r * ldo + c];
          out[e] = __float2bfloat16(o);
          if (r < valid) {
            s1 += o;
            s2 += o * o;
          }
        }
        atomicAdd(sums + (size_t)b * 2 * C + cbase + c, s1);
        atomicAdd(sums + (size_t)b * 2 * C + C + cbase + c, s2);
      }
    }
  }
}

}  // namespace

extern "C" int unpool_launch(const void* x, const void* se, const void* be, const void* k,
                             const void* v, const void* wq, const void* wo, void* bq, void* kft,
                             void* vft, void* brow, void* out, void* sums, int B, int N, int C,
                             int H, int I, int residual, int prenorm, int n_valid,
                             void* stream) {
  const int J = H * I, D = C / H;
  // the column block: C up to 384 (2 NW for NW in 32 ... 192), else 192
  const int CB = C <= 384 ? C : 192;
  if (I != kInd || N % kTile != 0 || n_valid < 1 || n_valid > N || H % 2 != 0 || C % H != 0 ||
      D % 16 != 0 || D > 64 || C % 64 != 0 || C % CB != 0 ||
      TileSmem(C, CB).total > (int)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  // 1/sqrt(D) rounded once from double, as the JAX package's Python float
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = fold::launch_unpool_fold(
      (const float*)se, (const float*)be, (const bf16*)k, (const bf16*)v, (const bf16*)wq,
      (const bf16*)wo, (float*)bq, (bf16*)kft, (bf16*)vft, (float*)brow, B, C, H, prenorm != 0,
      scale, st);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_x, tm_k, tm_v;
  if (encode_tiled(&tm_x, x, (uint64_t)B * N, C, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_k, kft, (uint64_t)B * J, C, kInd) != CUDA_SUCCESS ||
      encode_tiled(&tm_v, vft, (uint64_t)B * C, J, CB <= 256 ? CB : CB / 2) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const TileSmem L(C, CB);
  decltype(&unpool_tile_kernel<96>) kernel;
  switch (CB) {
    case 64: kernel = unpool_tile_kernel<32>; break;
    case 128: kernel = unpool_tile_kernel<64>; break;
    case 192: kernel = unpool_tile_kernel<96>; break;
    case 256: kernel = unpool_tile_kernel<128>; break;
    case 320: kernel = unpool_tile_kernel<160>; break;
    default: kernel = unpool_tile_kernel<192>; break;
  }
  err = set_smem((const void*)kernel, L.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * N / kTile, C / CB), 384, L.total, st>>>(
      tm_x, tm_k, tm_v, (const bf16*)x, (const float*)brow, (bf16*)out, (float*)sums, N, n_valid,
      C, H, residual);
  return (int)cudaGetLastError();
}
