// Resident attention pool onto the inducers, with the set-level GroupNorm
// statistics computed on the card (folded_pool_layer): the Hopper body.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_kernel. Per batch
// element b, with ``prenorm``, mean_c, inv_c [B, C] and y = bf16((x -
// mean_c) * (inv_c * scale) + bias) (pool_layer.cuh), and without it y = x.
// Then per head h, over the N points:
//   s = y @ qf[:, hI:(h+1)I] [N, I] fp32;  M = column max of s;
//   L = sum_n exp(max(s - M, -80));  p = bf16(exp(max(s - M, -80)) / L)
//   v = bf16(y @ Wv_h^T) [N, D];  P_h = p^T v [I, D] fp32
//   pooled[b, :, hD:(h+1)D] = bf16(P_h);  h0 = bf16(pooled @ Wo^T) [I, C]
// p is normalised by the global column max and sum before its bf16
// rounding (the TPU kernel's rounding point), unlike the online softmax of
// pool_ext.cu, which rounds e against a chunk's own max and rescales in its
// merge. M, L [B, J] (macc, sacc), the fp32 P [B, I, C] (pacc) and y are
// what the backward (pool_bwd.cu) reads.
//
// Bound on the H100: tensor-core operations, 2*N*C*(J + C) + 2*N*J*D per
// batch element against 2*N*C bytes of stream.
//
// Design: the TPU kernel held one batch element's [N, J] logits in VMEM;
// here the stream goes by 64-point chunks, in two passes with pool_ext.cu's
// tools (TMA in the 128-byte swizzle, wgmma with register accumulators):
// 1. with the pre-norm, its statistics and y, written once (pool_layer.cuh);
// 2. pass A, pool_layer_pass_kernel<false>, one block per (chunk, group of
//    8 heads), two warpgroups of four heads each: the y tile by TMA, read
//    once for all eight heads; each warpgroup streams the K panels of its
//    heads' qf^T through its own three-stage TMA ring and accumulates the
//    logits of 64 inducer columns at a time (m64n64 wgmma) in registers;
//    the chunk's column max m_c and sum l_c of exp(max(s - m_c, -80)) go to
//    device memory [B, chunks, J];
// 3. pool_layer_merge_kernel: per (b, j), in chunk order, M = max m_c and
//    L = sum exp(max(m_c - M, -80)) l_c -> macc, sacc;
// 4. pass B, pool_layer_pass_kernel<true>, the same grid: the logits again
//    and, beside the first block of columns, v = y Wv_h^T (m64n48), then p
//    against M and L, bf16 p^T and v^T into shared memory, and the chunk's
//    P_c = p^T v by one more wgmma, written as fp32 partials [B, chunks, J,
//    D]. No rescale is needed, so their sum is plain;
// 5. pool_layer_sum_kernel: pacc = the partials summed in chunk order,
//    pooled = bf16(pacc);
// 6. h0 = pooled @ Wo^T (pool.cuh's linear_nt_kernel).
// The logits are computed twice, as in the WMMA body; every sum runs in a
// fixed order, so the outputs are the same bits from call to call. Any
// I % 16 == 0 is taken: a head's inducers go by blocks of 64 columns, and a
// block's columns past I (the next head's rows of qf^T, or TMA's zero fill
// past J) take no part. A ragged N comes zero-padded to a multiple of 128 by
// the wrapper: with kMask the points from n_valid on are masked out (a chunk
// of padding alone gives m_c = -inf, l_c = 0 and P_c = 0); without it
// (N % 128 == 0) the masks fold away, as in pool_ext.cu.
#include <cmath>

#include "hopper.cuh"
#include "pool.cuh"
#include "pool_layer.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kHD = 48;        // channels per head (D)
constexpr int kGroup = 8;      // heads per block: four per warpgroup
constexpr int kTM = 64;        // points per chunk: one 64-row m-block
constexpr int kIB = 64;        // inducer columns per block of logits
constexpr int kRing = 3;       // stages of each warpgroup's weight ring
constexpr int kQBytes = kIB * 128;   // one K panel of a column block of qf^T_h
constexpr int kWBytes = kHD * 128;   // one K panel of Wv_h [48, 64]
constexpr int kStageBytes = kQBytes + kWBytes;
constexpr int kPassThreads = 256;

// Shared-memory layout of a pass block, in bytes from a 1024-aligned base
// (pass A leaves the Wv half of each stage and the v^T tile unused).
struct PassSmem {
  int y, stages, et, vt, red, bars, total;
  __host__ __device__ explicit PassSmem(int C) {
    y = 0;
    stages = y + (C / 64) * kTM * 128;
    et = stages + 2 * kRing * kStageBytes;
    vt = et + 2 * kIB * 128;
    red = vt + 2 * kHD * 128;
    bars = red + 2 * 2 * 4 * kIB * 4;
    total = bars + (1 + 2 * 2 * kRing) * 8 + 1024;  // + alignment slack
  }
};

// kPool false: pass A (part_m, part_l); true: pass B (part_p, reading macc
// and sacc). kMask: the chunk's points may hold a ragged tail's padding.
template <bool kPool, bool kMask>
__global__ void __launch_bounds__(kPassThreads, 1)
pool_layer_pass_kernel(const __grid_constant__ CUtensorMap tm_y,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ macc,
                       const float* __restrict__ sacc, float* __restrict__ part_m,
                       float* __restrict__ part_l, float* __restrict__ part_p, int N, int n_valid,
                       int C, int H, int I) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~(uintptr_t)1023);
  const PassSmem L(C);
  const int KP = C / 64, J = H * I, NB = (I + kIB - 1) / kIB;
  const int tile = blockIdx.x, grp = blockIdx.y;
  const int b = tile * kTM / N, n0 = tile * kTM % N, nch = N / kTM, ch = n0 / kTM;
  unsigned char* y = smem + L.y;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* yfull = bars;
  uint64_t* full = bars + 1;              // [2][kRing]
  uint64_t* empty = full + 2 * kRing;     // [2][kRing]
  auto stage = [&](int w, int s) { return smem + L.stages + (w * kRing + s) * kStageBytes; };

  if (threadIdx.x == 0) {
    bar_init(yfull, 1);
    for (int q = 0; q < 2 * kRing; ++q) {
      bar_init(full + q, 1);
      bar_init(empty + q, 4);  // one arrive per warp of the consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int w = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // warpgroup w owns heads grp*8 + 4w ... + 3; its first thread keeps its
  // ring filled: item it is K panel it % KP of column block it / KP % NB of
  // head it / (KP NB), beside the K panel of Wv_h for the first block in
  // pass B
  const bool loader = threadIdx.x % 128 == 0;
  const int items = 4 * NB * KP;
  auto load_stage = [&](int it) {
    const int hh = it / (NB * KP), ib = it / KP % NB, kp = it % KP, s = it % kRing;
    const int h = grp * kGroup + w * 4 + hh;
    const bool wv = kPool && ib == 0;
    bar_expect(full + w * kRing + s, kQBytes + (wv ? kWBytes : 0));
    tma_load(stage(w, s), &tm_q, full + w * kRing + s, h * I + ib * kIB, kp * 64);
    if (wv) tma_load(stage(w, s) + kQBytes, &tm_w, full + w * kRing + s, C + h * kHD, kp * 64);
  };
  if (threadIdx.x == 0) {
    bar_expect(yfull, KP * kTM * 128);
    for (int p = 0; p < KP; ++p) tma_load(y + p * kTM * 128, &tm_y, yfull, tile * kTM, p * 64);
  }
  if (loader) {
    for (int it = 0; it < kRing && it < items; ++it) load_stage(it);
  }
  unsigned char* et = smem + L.et + w * kIB * 128;  // p^T [kIB, kTM]
  unsigned char* vt = smem + L.vt + w * kHD * 128;  // v^T [D, kTM]
  float* red_m = reinterpret_cast<float*>(smem + L.red) + w * 2 * 4 * kIB;  // [4][kIB]
  float* red_l = red_m + 4 * kIB;
  bar_wait(yfull, 0);

  const int col = 2 * (lane % 4);       // first column of the thread's pairs
  const int r = wi * 16 + lane / 4;     // the thread's rows r and r + 8
  // whether rows r and r + 8 are points (not a ragged tail's padding)
  const bool ok0 = !kMask || n0 + r < n_valid, ok1 = !kMask || n0 + r + 8 < n_valid;
  int it = 0;
  for (int hh = 0; hh < 4; ++hh) {
    const int h = grp * kGroup + w * 4 + hh;
    for (int ib = 0; ib < NB; ++ib) {
      const int i_base = ib * kIB;  // the block's first inducer of head h
      const bool with_v = kPool && ib == 0;
      // the logits s = y @ qf_h (64 columns) and, with_v, v = y @ Wv_h^T
      float s_acc[kIB / 2];
      float v_acc[kHD / 2];
      for (int kp = 0; kp < KP; ++kp, ++it) {
        const int s = it % kRing;
        bar_wait(full + w * kRing + s, (it / kRing) & 1);
        const uint64_t dq = desc(stage(w, s)), dy = desc(y + kp * kTM * 128);
        wgmma_fence();
        if (with_v) {
          const uint64_t dw = desc(stage(w, s) + kQBytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss<kIB>(s_acc, dy + 2 * kk, dq + 2 * kk, (kp | kk) != 0);
            wgmma_ss<kHD>(v_acc, dy + 2 * kk, dw + 2 * kk, (kp | kk) != 0);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss<kIB>(s_acc, dy + 2 * kk, dq + 2 * kk, (kp | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s_acc);
        if (with_v) fence_regs(v_acc);
        if (lane == 0) bar_arrive(empty + w * kRing + s);
        // refill the stage once all four warps are done with it
        if (loader && it + kRing < items) {
          bar_wait(empty + w * kRing + s, (it / kRing) & 1);
          load_stage(it + kRing);
        }
      }
      // every warp of the warpgroup is done with the last block's shared
      // tiles (reductions, p^T and its product)
      named_sync(2 + w, 128);

      if constexpr (!kPool) {
        // column max over the chunk's points
        float cm[16];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float m = fmaxf(ok0 ? s_acc[4 * g + e] : -INFINITY,
                            ok1 ? s_acc[4 * g + 2 + e] : -INFINITY);
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
            if (lane < 4) red_m[wi * kIB + 8 * g + col + e] = m;
          }
        }
        named_sync(2 + w, 128);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int c = 8 * (q / 2) + col + q % 2;
          cm[q] = fmaxf(fmaxf(red_m[c], red_m[kIB + c]),
                        fmaxf(red_m[2 * kIB + c], red_m[3 * kIB + c]));
        }
        // the column sum of e = exp(max(s - m_c, -80))
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int g = q / 2, e = q % 2;
          float l = (ok0 ? expf(fmaxf(s_acc[4 * g + e] - cm[q], -80.0f)) : 0.0f) +
                    (ok1 ? expf(fmaxf(s_acc[4 * g + 2 + e] - cm[q], -80.0f)) : 0.0f);
          l += __shfl_xor_sync(0xffffffffu, l, 4);
          l += __shfl_xor_sync(0xffffffffu, l, 8);
          l += __shfl_xor_sync(0xffffffffu, l, 16);
          if (lane < 4) red_l[wi * kIB + 8 * g + col + e] = l;
        }
        named_sync(2 + w, 128);
        if (wi == 0 && lane < 4) {
          const size_t base = ((size_t)b * nch + ch) * J + (size_t)h * I + i_base;
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int c = 8 * (q / 2) + col + q % 2;
            if (i_base + c < I) {
              part_m[base + c] = cm[q];
              part_l[base + c] =
                  red_l[c] + red_l[kIB + c] + red_l[2 * kIB + c] + red_l[3 * kIB + c];
            }
          }
        }
      } else {
        // bf16 v^T once per head, which frees v's registers
        if (with_v) {
#pragma unroll
          for (int g = 0; g < kHD / 8; ++g) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 8 * g + col + e;
              *reinterpret_cast<bf16*>(vt + swz(d, r, kHD * 128)) =
                  __float2bfloat16(v_acc[4 * g + e]);
              *reinterpret_cast<bf16*>(vt + swz(d, r + 8, kHD * 128)) =
                  __float2bfloat16(v_acc[4 * g + 2 + e]);
            }
          }
        }
        // p = bf16(exp(max(s - M, -80)) / L), 0 on the padding and past I
        const float* mrow = macc + (size_t)b * J + (size_t)h * I + i_base;
        const float* lrow = sacc + (size_t)b * J + (size_t)h * I + i_base;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * g + col + e;
            const bool in = i_base + i < I;
            const float m = in ? __ldg(mrow + i) : 0.0f, l = in ? __ldg(lrow + i) : 1.0f;
            const float p0 = ok0 && in ? expf(fmaxf(s_acc[4 * g + e] - m, -80.0f)) / l : 0.0f;
            const float p1 = ok1 && in ? expf(fmaxf(s_acc[4 * g + 2 + e] - m, -80.0f)) / l : 0.0f;
            *reinterpret_cast<bf16*>(et + swz(i, r, kIB * 128)) = __float2bfloat16(p0);
            *reinterpret_cast<bf16*>(et + swz(i, r + 8, kIB * 128)) = __float2bfloat16(p1);
          }
        }
        fence_async_smem();
        named_sync(2 + w, 128);

        // P_c = p^T @ v over the chunk's points
        float p_acc[kHD / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTM / 16; ++kk) {
          wgmma_ss<kHD>(p_acc, desc(et) + 2 * kk, desc(vt) + 2 * kk, kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(p_acc);

        const size_t base = ((size_t)b * nch + ch) * J + (size_t)h * I + i_base;
#pragma unroll
        for (int g = 0; g < kHD / 8; ++g) {
          const int d = 8 * g + col;
          if (i_base + r < I) {
            *reinterpret_cast<float2*>(part_p + (base + r) * kHD + d) =
                make_float2(p_acc[4 * g], p_acc[4 * g + 1]);
          }
          if (i_base + r + 8 < I) {
            *reinterpret_cast<float2*>(part_p + (base + r + 8) * kHD + d) =
                make_float2(p_acc[4 * g + 2], p_acc[4 * g + 3]);
          }
        }
      }
    }
  }
}

// Per (b, j), in chunk order: M = max m_c, L = sum exp(max(m_c - M, -80))
// l_c (a chunk of padding alone adds exp(-80) * 0).
__global__ void __launch_bounds__(kThreads)
pool_layer_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                        float* __restrict__ macc, float* __restrict__ sacc, int B, int nch,
                        int J) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * J) return;
  const int b = idx / J, j = idx % J;
  const float* pm = part_m + (size_t)b * nch * J + j;
  const float* pl = part_l + (size_t)b * nch * J + j;
  float M = -3.0e38f;
  for (int c = 0; c < nch; ++c) M = fmaxf(M, pm[(size_t)c * J]);
  float Lsum = 0.0f;
  for (int c = 0; c < nch; ++c) {
    Lsum += expf(fmaxf(pm[(size_t)c * J] - M, -80.0f)) * pl[(size_t)c * J];
  }
  macc[idx] = M;
  sacc[idx] = Lsum;
}

// Per (b, j, d), in chunk order: pacc = the sum of the chunks' P_c (where
// asked), pooled = bf16 of it, both in the [B, I, C] layout.
__global__ void __launch_bounds__(kThreads)
pool_layer_sum_kernel(const float* __restrict__ part_p, float* __restrict__ pacc,
                      bf16* __restrict__ pooled, int B, int nch, int C, int H, int I) {
  const int J = H * I;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * J * kHD) return;
  const int d = (int)(idx % kHD), j = (int)(idx / kHD % J), b = (int)(idx / ((long long)kHD * J));
  const float* pp = part_p + ((size_t)b * nch * J + j) * kHD + d;
  float P = 0.0f;
  for (int c = 0; c < nch; ++c) P += pp[(size_t)c * J * kHD];
  const size_t o = ((size_t)b * I + j % I) * C + (size_t)(j / I) * kHD + d;
  pooled[o] = __float2bfloat16(P);
  if (pacc != nullptr) pacc[o] = P;
}

}  // namespace

// qft [J, C] is the folded query transposed. With the pre-norm (mean
// non-null), part [B, N / 64, 2, C] fp32 is scratch and mean, inv and y
// [B, N, C] are written; without, mean and y must be null and the passes
// read x. part_m, part_l [B, N / 64, J] and part_p [B, N / 64, J, D] fp32
// are scratch; macc, sacc [B, J] are always written, pacc where non-null.
extern "C" int pool_layer_launch(const void* x, const void* scale, const void* bias,
                                 const void* qft, const void* kvw, const void* wo, void* part,
                                 void* mean, void* inv, void* y, void* part_m, void* part_l,
                                 void* part_p, void* macc, void* sacc, void* pooled, void* h0,
                                 void* pacc, int B, int N, int C, int H, int I, int G,
                                 int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = C / H, J = H * I;
  if (C % H || D != kHD || H % kGroup || C % 64 || C > 768 || I % 16 || (B * I) % 64 ||
      N % 128 || n_valid < 1 || n_valid > N || (mean != nullptr && (G <= 0 || C % G))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (mean != nullptr &&
      (err = pool_layer_prenorm((const bf16*)x, (const float*)scale, (const float*)bias,
                                (float*)part, (float*)mean, (float*)inv, (bf16*)y, B, N, C, G,
                                n_valid, st)) != cudaSuccess) {
    return (int)err;
  }
  const void* ys = mean != nullptr ? y : x;
  CUtensorMap tm_y, tm_q, tm_w;
  if (encode_tiled(&tm_y, ys, (uint64_t)B * N, C, kTM) != CUDA_SUCCESS ||
      encode_tiled(&tm_q, qft, J, C, kIB) != CUDA_SUCCESS ||
      encode_tiled(&tm_w, kvw, 2 * (uint64_t)C, C, kHD) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const PassSmem L(C);
  const bool mask = n_valid < N;
  const dim3 grid(B * N / kTM, H / kGroup);
  const auto pass_a =
      mask ? pool_layer_pass_kernel<false, true> : pool_layer_pass_kernel<false, false>;
  const auto pass_b =
      mask ? pool_layer_pass_kernel<true, true> : pool_layer_pass_kernel<true, false>;
  if ((err = set_smem((const void*)pass_a, L.total)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)pass_b, L.total)) != cudaSuccess) return (int)err;
  pass_a<<<grid, kPassThreads, L.total, st>>>(tm_y, tm_q, tm_w, nullptr, nullptr, (float*)part_m,
                                              (float*)part_l, nullptr, N, n_valid, C, H, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pool_layer_merge_kernel<<<(B * J + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)part_m, (const float*)part_l, (float*)macc, (float*)sacc, B, N / kTM, J);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pass_b<<<grid, kPassThreads, L.total, st>>>(tm_y, tm_q, tm_w, (const float*)macc,
                                              (const float*)sacc, nullptr, nullptr,
                                              (float*)part_p, N, n_valid, C, H, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long elems = (long long)B * J * kHD;
  pool_layer_sum_kernel<<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const float*)part_p, (float*)pacc, (bf16*)pooled, B, N / kTM, C, H, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_nt_kernel<<<dim3(C / 64, B * I / 64), kThreads, 0, st>>>(
      (const bf16*)pooled, (const bf16*)wo, (bf16*)h0, B * I, C, C);
  return (int)cudaGetLastError();
}
