// Backward of the folded unpool attention + residual (folded_unpool): the
// Hopper body (TMA and wgmma), the train step's.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_bwd_kernel, in
// all four variants of its flags: with ``prenorm`` off y = x (no dse, dbe),
// with ``residual`` off the x term of attn and the d_attn term of dx drop
// out. Per batch element b, with the fold WITHOUT se (the backward reads y
// explicitly, unlike the forward kernel unpool.cu):
//   kft[hI+i, :] = bf16(s * k_h[i] @ wq_h)    vf[hI+i, :] = bf16(v_h[i] @ wo_h^T)
// and per point, y = bf16(x * se + be):
//   logits = y @ kft^T; per head block its own max m, e = exp(max(. - m,
//   -80)), p = e / sum e, act = [logit - m > -80]
//   attn = x + bf16(p) @ vf;  d_attn = g + gs1 + 2 attn gs2
//   dp = bf16(d_attn) @ vf^T;  ds = p (dp - blocksum(dp p)) act
//   dy = bf16(ds) @ kft;  dx = dy * se + d_attn;  dse += sum dy x, dbe += sum dy
//   dkf[b] = y^T bf16(ds) [C, J];  dvf[b] = bf16(p)^T bf16(d_attn) [J, C]
// The caller chains dkf/dvf to dk, dv, dWq and dWo (plain PyTorch). A
// ragged N comes zero-padded (x and g) to a multiple of 128: the sums'
// cotangent reaches only the first n_valid points of an element, so the
// padding's d_attn, ds and dy are zero and add nothing to dse, dbe, dkf, dvf.
//
// Bound on the H100: tensor-core operations (six [N, C] x [C, J]-sized
// products per batch element, J = 512 FLOP per byte of the stream at the
// flagship). The TPU kernel kept one batch element's folded operands in
// VMEM and both walks over the heads in one grid step. Here every product
// is a wgmma with its operands brought by TMA in the 128-byte swizzle, read
// K-major or MN-major (hopper.cuh desc_mn) as TMA leaves them, and the
// point-wise work runs in the accumulators' registers. No block holds a
// [64, C] stream tile and a head's operands at once (at C 768 they would
// not fit), so the walks go through device memory in bf16, as the WMMA
// body's p and ds already did:
// 1. unpool_bwd_fold_kernel (backward.cuh, WMMA): kft, vf [B, J, C];
// 2. prenorm_kernel (backward.cuh): y [B, N, C] once (with the pre-norm);
// 3. unpool_bwd_heads_kernel<0>, one block per (64-point tile, 4 heads):
//    warpgroup w forms the logits of two heads by one m64n128 wgmma (K = C
//    in 64-column panels through a TMA ring of the y panel and the four
//    heads' kft rows), the two softmaxes in registers (row max and sum by
//    shuffles within the four lanes of a row), bf16 p [B, N, J];
// 4. unpool_bwd_rows_kernel<0>, one block per (64-point tile, 384 columns
//    at most): attn = bf16(p) @ vf over J in one-head chunks (p K-major, vf
//    MN-major through a TMA ring), a [64, 192] fp32 accumulator a
//    warpgroup; the epilogue forms d_attn there: bf16 d_attn [B, N, C], and
//    the fp32 d_attn that dx adds (with the residual);
// 5. unpool_bwd_heads_kernel<1>: the logits again and dp = bf16(d_attn) @
//    vf^T beside them (vf K-major), the softmax backward in registers, bf16
//    ds [B, N, J];
// 6. unpool_bwd_rows_kernel<1>: dy = bf16(ds) @ kft (kft MN-major); dx from
//    the registers, dse and dbe by shuffles, shared memory and one fp32
//    atomic per column and block;
// 7. wgrad_kernel (wgrad.cuh) twice: dkf and dvf, per batch element, both
//    operands MN-major, split partials summed in a fixed order, so dkf and
//    dvf are the same bits from run to run (dse and dbe come from fp32
//    atomics and vary at their rounding).
// Kept bf16 roundings: kft, vf, p, d_attn and ds, as the TPU kernel's;
// softmax statistics, dp and ds stay fp32 until rounded.
#include <cmath>

#include "backward.cuh"
#include "hopper.cuh"
#include "wgrad.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kInd = 64;             // inducers per head (I)
constexpr int kTile = 64;            // points per tile: one 64-row m-block
constexpr int kPanel = kTile * 128;  // 64 rows of one 64-column panel
constexpr int kHeadRows = 4 * kInd;  // kft / vf rows of a heads block (4 heads)
constexpr int kBwdThreads = 256;     // two consumer warpgroups
// ring stages of the heads and rows kernels: 2 and 4 timed within 5% of
// each other at the flagship, the 8k width and the demo's shapes (the
// heads kernel's p pass then fits two blocks on an SM)
constexpr int kRing = 2;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~(uintptr_t)1023);
}

// bytes of one ring stage of the heads kernel: the stream panel and the
// four heads' panel of kft, and with DS the d_attn panel and vf's
__host__ __device__ constexpr int heads_stage(int ds) { return (1 + ds) * (kPanel + 4 * kPanel); }

// Work item q: the 64-point tile q / NG and heads h0 = 4 (q % NG) .. h0 + 3
// (NG = ceil(H / 4)); warpgroup w takes heads h0 + 2w and h0 + 2w + 1 as one
// m64n128 product. Heads at or past H (H not a multiple of 4) are computed
// on whatever rows follow and not stored. DS = 0: bf16(p) to ``out``;
// DS = 1: bf16(ds) to ``out``. Persistent: block x takes items x, x +
// gridDim.x, ..., and its ring runs on across them, so the next item's
// loads are in flight while one item's epilogue stores.
template <int DS>
__global__ void __launch_bounds__(kBwdThreads, 1)
unpool_bwd_heads_kernel(const __grid_constant__ CUtensorMap tm_y,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_da,
                        const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int N,
                        int C, int H, int items) {
  constexpr int kStage = heads_stage(DS);
  constexpr int kB = kPanel;       // offset of the kft rows in a stage
  constexpr int kA2 = 5 * kPanel;  // d_attn panel, then the vf rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * kStage);
  const int KP = C / 64, J = H * kInd, NG = (H + 3) / 4;
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * KP;  // ring iterations of this block
  auto item = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto stage = [&](int s) { return smem + s * kStage; };
  auto load = [&](int u) {
    const int q = item(u / KP), kp = u % KP, s = u % kRing;
    const int row0 = (q / NG) * kTile, krow = (row0 / N) * J + 4 * (q % NG) * kInd;
    unsigned char* st = stage(s);
    bar_expect(full + s, kStage);
    tma_load(st, &tm_y, full + s, row0, kp * 64);
    tma_load(st + kB, &tm_k, full + s, krow, kp * 64);
    if (DS) {
      tma_load(st + kA2, &tm_da, full + s, row0, kp * 64);
      tma_load(st + kA2 + kPanel, &tm_v, full + s, krow, kp * 64);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) bar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 0; u < kRing && u < total; ++u) load(u);
  }
  const int w = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4), r = wi * 16 + lane / 4;

  for (int k = 0; k < mine; ++k) {
    const int it = item(k);
    const int row0 = (it / NG) * kTile, h0 = 4 * (it % NG);
    // the logits (and dp) of the warpgroup's two heads, columns 64 hh + 8g + ...
    float s_acc[64];
    float dp[DS ? 64 : 1];
    for (int kp = 0; kp < KP; ++kp) {
      const int u = k * KP + kp, s = u % kRing;
      unsigned char* st = stage(s);
      bar_wait(full + s, (u / kRing) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tt<0, 0>(s_acc, desc(st) + 2 * kk, desc(st + kB + w * 2 * kPanel) + 2 * kk,
                       (kp | kk) != 0);
      }
      if constexpr (DS) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tt<0, 0>(dp, desc(st + kA2) + 2 * kk,
                         desc(st + kA2 + kPanel + w * 2 * kPanel) + 2 * kk, (kp | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if constexpr (DS) fence_regs(dp);
      __syncthreads();  // both warpgroups are done with the stage
      if (threadIdx.x == 0 && u + kRing < total) load(u + kRing);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = h0 + 2 * w + hh;
      if (h >= H) continue;
      // the head's softmax in registers: row r in elements 4G + {0, 1}, row
      // r + 8 in 4G + {2, 3}, G = 8 hh + g
      float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int G = 8 * hh + g;
        m0 = fmaxf(m0, fmaxf(s_acc[4 * G], s_acc[4 * G + 1]));
        m1 = fmaxf(m1, fmaxf(s_acc[4 * G + 2], s_acc[4 * G + 3]));
      }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      uint32_t act = 0;  // [logit - m > -80], bit 4g + q
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int G = 8 * hh + g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float z = s_acc[4 * G + q] - (q < 2 ? m0 : m1);
          if (z > -80.0f) act |= 1u << (4 * g + q);
          s_acc[4 * G + q] = expf(fmaxf(z, -80.0f));
        }
        l0 += s_acc[4 * G] + s_acc[4 * G + 1];
        l1 += s_acc[4 * G + 2] + s_acc[4 * G + 3];
      }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int G = 8 * hh + g;
        s_acc[4 * G] /= l0;
        s_acc[4 * G + 1] /= l0;
        s_acc[4 * G + 2] /= l1;
        s_acc[4 * G + 3] /= l1;
      }
      float v[32];  // the values stored: p, or ds
      if constexpr (DS) {
        // ds = p (dp - sum dp p) act
        float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int G = 8 * hh + g;
          t0 += dp[4 * G] * s_acc[4 * G] + dp[4 * G + 1] * s_acc[4 * G + 1];
          t1 += dp[4 * G + 2] * s_acc[4 * G + 2] + dp[4 * G + 3] * s_acc[4 * G + 3];
        }
        t0 += __shfl_xor_sync(0xffffffffu, t0, 1);
        t0 += __shfl_xor_sync(0xffffffffu, t0, 2);
        t1 += __shfl_xor_sync(0xffffffffu, t1, 1);
        t1 += __shfl_xor_sync(0xffffffffu, t1, 2);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int G = 8 * hh + g;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float p = s_acc[4 * G + q];
            v[4 * g + q] = (act >> (4 * g + q)) & 1u ? p * (dp[4 * G + q] - (q < 2 ? t0 : t1))
                                                      : 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 32; ++q) v[q] = s_acc[32 * hh + q];
      }
      bf16* o = out + (size_t)(row0 + r) * J + h * kInd + col;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * g) =
            __floats2bfloat162_rn(v[4 * g], v[4 * g + 1]);
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)8 * J + 8 * g) =
            __floats2bfloat162_rn(v[4 * g + 2], v[4 * g + 3]);
      }
    }
  }
}

// Work item q: the 64-point tile q / (C / CB) and CB = 2 NW output columns
// from (q % (C / CB)) CB: acc [64, CB] += A [64, J] @ M_b [J, CB] over J
// in one-head chunks of 64 rows, A read K-major and M_b MN-major from a TMA
// ring. MODE 0: A = bf16(p), M = vf; the epilogue forms d_attn = g + gs1 +
// 2 attn gs2 (attn = x + acc with the residual): bf16 to ``da``, fp32 to
// ``da32`` (with the residual). MODE 1: A = bf16(ds), M = kft, acc = dy;
// dx = bf16(dy * se + d_attn) (se 1 without the pre-norm, no d_attn
// without the residual), and with the pre-norm dse += sum dy x, dbe +=
// sum dy (through a shared-memory region of its own, beside the ring).
// Persistent, as the heads kernel.
template <int MODE, int NW>
__global__ void __launch_bounds__(kBwdThreads, 1)
unpool_bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_m, const bf16* __restrict__ x,
                       const bf16* __restrict__ g, const float* __restrict__ gsums,
                       const float* __restrict__ se, float* __restrict__ da32,
                       bf16* __restrict__ da, bf16* __restrict__ dx, float* __restrict__ dse,
                       float* __restrict__ dbe, int N, int n_valid, int C, int H, int residual,
                       int items) {
  constexpr int CB = 2 * NW;
  constexpr int kStage = (1 + CB / 64) * kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * kStage);
  const int J = H * kInd, NCB = C / CB;
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * H;  // ring iterations of this block
  auto item = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto stage = [&](int s) { return smem + s * kStage; };
  auto load = [&](int u) {
    const int q = item(u / H), kc = u % H, s = u % kRing;
    const int row0 = (q / NCB) * kTile, cbase = (q % NCB) * CB;
    unsigned char* st = stage(s);
    bar_expect(full + s, kStage);
    tma_load(st, &tm_a, full + s, row0, kc * kInd);
    for (int p = 0; p < CB / 64; ++p) {
      tma_load(st + (1 + p) * kPanel, &tm_m, full + s, (row0 / N) * J + kc * kInd,
               cbase + p * 64);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) bar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 0; u < kRing && u < total; ++u) load(u);
  }
  const int w = threadIdx.x / 128, t128 = threadIdx.x % 128, wi = t128 / 32, lane = t128 % 32;
  const int col = 2 * (lane % 4), r = wi * 16 + lane / 4;

  for (int k = 0; k < mine; ++k) {
    const int it = item(k);
    const int row0 = (it / NCB) * kTile, b = row0 / N;
    const int cb0 = (it % NCB) * CB + w * NW;  // the warpgroup's first output column
    float acc[NW / 2];
    zero(acc);
    for (int kc = 0; kc < H; ++kc) {
      const int u = k * H + kc, s = u % kRing;
      unsigned char* st = stage(s);
      bar_wait(full + s, (u / kRing) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tt<0, 1>(acc, desc(st) + 2 * kk,
                       desc_mn(st + (1 + w * NW / 64) * kPanel + kk * 2048, kPanel), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // both warpgroups are done with the stage
      if (threadIdx.x == 0 && u + kRing < total) load(u + kRing);
    }

    const size_t e0 = (size_t)(row0 + r) * C, e1 = e0 + (size_t)8 * C;
    if constexpr (MODE == 0) {
      const float* gs1 = gsums + (size_t)b * 2 * C;
      const float* gs2 = gs1 + C;
      // the sums' cotangent reaches the first n_valid points only (the rest
      // are a ragged tail's padding, g zero there: d_attn stays zero)
      const int pt = row0 - b * N + r;
#pragma unroll
      for (int q = 0; q < NW / 8; ++q) {
        const int c = cb0 + 8 * q + col;
        const float2 g1 = *reinterpret_cast<const float2*>(gs1 + c);
        const float2 g2 = *reinterpret_cast<const float2*>(gs2 + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool on = pt + 8 * half < n_valid;
          const size_t e = (half ? e1 : e0) + c;
          float a0 = acc[4 * q + 2 * half], a1 = acc[4 * q + 2 * half + 1];
          if (residual) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + e));
            a0 = xv.x + a0;
            a1 = xv.y + a1;
          }
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + e));
          const float d0 = on ? gv.x + g1.x + 2.0f * a0 * g2.x : gv.x;
          const float d1 = on ? gv.y + g1.y + 2.0f * a1 * g2.y : gv.y;
          *reinterpret_cast<__nv_bfloat162*>(da + e) = __floats2bfloat162_rn(d0, d1);
          if (residual) *reinterpret_cast<float2*>(da32 + e) = make_float2(d0, d1);
        }
      }
    } else {
      // dx; the column sums of dy * x and dy over the tile's rows: shuffles
      // over a warp's rows, then the four warps through shared memory, one
      // atomic per column and item
      float* red = reinterpret_cast<float*>(smem + kRing * kStage + 64) + w * 2 * 4 * NW;
#pragma unroll
      for (int q = 0; q < NW / 8; ++q) {
        const int c = cb0 + 8 * q + col;
        const float s0 = se ? __ldg(se + (size_t)b * C + c) : 1.0f;
        const float s1 = se ? __ldg(se + (size_t)b * C + c + 1) : 1.0f;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const size_t e = (half ? e1 : e0) + c;
          const float d0 = acc[4 * q + 2 * half], d1 = acc[4 * q + 2 * half + 1];
          float o0 = d0 * s0, o1 = d1 * s1;
          if (residual) {
            const float2 rv = *reinterpret_cast<const float2*>(da32 + e);
            o0 += rv.x;
            o1 += rv.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(dx + e) = __floats2bfloat162_rn(o0, o1);
          if (se) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + e));
            v[0] += d0 * xv.x;
            v[1] += d1 * xv.y;
            v[2] += d0;
            v[3] += d1;
          }
        }
        if (se) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] += __shfl_xor_sync(0xffffffffu, v[u], 4);
            v[u] += __shfl_xor_sync(0xffffffffu, v[u], 8);
            v[u] += __shfl_xor_sync(0xffffffffu, v[u], 16);
          }
          if (lane < 4) {
            const int c0 = 8 * q + col;
            red[wi * NW + c0] = v[0];
            red[wi * NW + c0 + 1] = v[1];
            red[(4 + wi) * NW + c0] = v[2];
            red[(4 + wi) * NW + c0 + 1] = v[3];
          }
        }
      }
      if (se) {
        named_sync(2 + w, 128);
        for (int c = t128; c < NW; c += 128) {
          float a = 0.0f, bsum = 0.0f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a += red[u * NW + c];
            bsum += red[(4 + u) * NW + c];
          }
          atomicAdd(dse + (size_t)b * C + cb0 + c, a);
          atomicAdd(dbe + (size_t)b * C + cb0 + c, bsum);
        }
      }
    }
  }
}

// blocks of a persistent kernel: every SM filled as far as its resources
// allow, at most one block per work item
int persistent_blocks(const void* kernel, size_t smem, int items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return blocks < items ? blocks : items;
}

template <int MODE>
cudaError_t launch_rows(const CUtensorMap& tm_a, const CUtensorMap& tm_m, const bf16* x,
                        const bf16* g, const float* gsums, const float* se, float* da32, bf16* da,
                        bf16* dx, float* dse, float* dbe, int B, int N, int n_valid, int C, int H,
                        int residual, cudaStream_t st) {
  const int CB = C <= 384 ? C : 384;
  const int stage_bytes = (1 + CB / 64) * kPanel;
  const int red = MODE == 1 ? 2 * 2 * 4 * (CB / 2) * 4 : 0;  // [2 wg][2][4 warps][NW] fp32
  const size_t smem = (size_t)kRing * stage_bytes + 64 + red + 1024;
  decltype(&unpool_bwd_rows_kernel<MODE, 192>) kernel = unpool_bwd_rows_kernel<MODE, 64>;
  if (CB == 384) kernel = unpool_bwd_rows_kernel<MODE, 192>;
  if (CB == 256) kernel = unpool_bwd_rows_kernel<MODE, 128>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int items = B * N / kTile * (C / CB);
  kernel<<<persistent_blocks((const void*)kernel, smem, items), kBwdThreads, smem, st>>>(
      tm_a, tm_m, x, g, gsums, se, da32, da, dx, dse, dbe, N, n_valid, C, H, residual, items);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_heads(const CUtensorMap& tm_y, const CUtensorMap& tm_k, const CUtensorMap& tm_da,
                         const CUtensorMap& tm_v, bf16* out, int B, int N, int C, int H,
                         cudaStream_t st) {
  const size_t smem = (size_t)kRing * heads_stage(DS) + 64 + 1024;
  const void* kernel = (const void*)unpool_bwd_heads_kernel<DS>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int items = B * N / kTile * ((H + 3) / 4);
  unpool_bwd_heads_kernel<DS><<<persistent_blocks(kernel, smem, items), kBwdThreads, smem, st>>>(
      tm_y, tm_k, tm_da, tm_v, out, N, C, H, items);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unpool_bwd_launch(const void* x, const void* se, const void* be, const void* k,
                                 const void* v, const void* wq, const void* wo, const void* g,
                                 const void* gsums, void* y, void* kft, void* vf, void* p,
                                 void* ds, void* da, void* da32, void* dx, void* dse, void* dbe,
                                 void* dkf, void* dvf, void* wpart, int B, int N, int C, int H,
                                 int I, int residual, int prenorm, int splits, int n_valid,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I, D = C / H;
  if (I != kInd || H % 2 || C % 128 || (C > 384 && C % 384) || D % 16 || N % kTile ||
      splits < 1 || n_valid < 1 || n_valid > N) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = launch_unpool_bwd_fold((const bf16*)k, (const bf16*)v, (const bf16*)wq,
                                           (const bf16*)wo, (bf16*)kft, (bf16*)vf, B, C, H, I, st);
  if (err != cudaSuccess) return (int)err;
  const void* yp = x;
  if (prenorm) {
    err = launch_prenorm((const bf16*)x, (const float*)se, (const float*)be, (bf16*)y, B, N, C, st);
    if (err != cudaSuccess) return (int)err;
    yp = y;
  }
  const uint64_t rows = (uint64_t)B * N, jrows = (uint64_t)B * J;
  CUtensorMap tm_y, tm_k4, tm_v4, tm_da, tm_p, tm_ds, tm_k, tm_v;
  if (encode_tiled(&tm_y, yp, rows, C, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_k4, kft, jrows, C, kHeadRows) != CUDA_SUCCESS ||
      encode_tiled(&tm_v4, vf, jrows, C, kHeadRows) != CUDA_SUCCESS ||
      encode_tiled(&tm_da, da, rows, C, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_p, p, rows, J, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_ds, ds, rows, J, kTile) != CUDA_SUCCESS ||
      encode_tiled(&tm_k, kft, jrows, C, kInd) != CUDA_SUCCESS ||
      encode_tiled(&tm_v, vf, jrows, C, kInd) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const float* se_p = prenorm ? (const float*)se : nullptr;
  // p, then d_attn
  err = launch_heads<0>(tm_y, tm_k4, tm_da, tm_v4, (bf16*)p, B, N, C, H, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_rows<0>(tm_p, tm_v, (const bf16*)x, (const bf16*)g, (const float*)gsums, se_p,
                       (float*)da32, (bf16*)da, (bf16*)dx, (float*)dse, (float*)dbe, B, N, n_valid,
                       C, H, residual, st);
  if (err != cudaSuccess) return (int)err;
  // ds, then dy into dx, dse, dbe
  err = launch_heads<1>(tm_y, tm_k4, tm_da, tm_v4, (bf16*)ds, B, N, C, H, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_rows<1>(tm_ds, tm_k, (const bf16*)x, (const bf16*)g, (const float*)gsums, se_p,
                       (float*)da32, (bf16*)da, (bf16*)dx, (float*)dse, (float*)dbe, B, N, n_valid,
                       C, H, residual, st);
  if (err != cudaSuccess) return (int)err;
  // dkf[b] = y_b^T bf16(ds_b) [C, J];  dvf[b] = bf16(p_b)^T bf16(d_attn_b) [J, C]
  // laid out per head as the chain to the weights reads them: dkf as
  // [H, C, B, I], dvf as [H, B, I, C]
  const long long BI = (long long)B * I;
  err = launch_wgrad(yp, ds, (float*)wpart, (float*)dkf, WgradLayout{I, 64 * BI, BI, C * BI}, B,
                     N, C, J, splits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad(p, da, (float*)wpart, (float*)dvf,
                           WgradLayout{(long long)I * C, BI * C, C, 64}, B, N, J, C, splits, st);
}
