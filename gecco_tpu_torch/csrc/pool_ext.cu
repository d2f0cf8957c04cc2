// Online-softmax attention pool onto the inducers, split over point chunks.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_kernel_wfold
// and _pool_ext_kernel (both served by folded_pool_ext), in the v-stream
// form of the latter. Per batch element b and head h, with y = bf16(x*se+be):
//   qf = s * fold(Wk, ind2)                [C, J]  (one fold per call)
//   s  = y @ qf[:, hI:(h+1)I]              [N, I]  logits (fp32)
//   v  = bf16(y @ Wv_h^T)                  [N, D]
//   softmax over the POINT axis per column: per chunk of TM points its
//   column max m_c, e = exp(max(s - m_c, -80)), l_c = sum e (fp32) and
//   P_c = bf16(e)^T @ v [I, D] (fp32); then across chunks
//   M = max m_c, corr_c = exp(max(m_c - M, -80)), L = sum corr_c l_c,
//   pooled[b, :, hD:(h+1)D] = bf16(sum corr_c P_c / L)
//   h0 = bf16(pooled @ Wo^T)               [B, I, C]
// Where the caller asks (a gradient will be taken), M and L are written to
// macc/sacc [B, J] for the backward (pool_ext_bwd.cu).
//
// Bound on the H100: tensor-core operations, 2*N*C*(J + C) + 2*N*J*D per
// batch element against 2*N*C bytes of stream (about 900 FLOP per byte at
// the flagship).
//
// Design (four launches):
// 1. pool_fold_kernel: qf^T [J, C] = s * ind2_h @ Wk_h per head on the
//    tensor cores (WMMA, depth D), once per call.
// 2. pool_chunk_kernel<HD, G>, one block per (chunk of TM points, group of
//    G heads of HD channels): the stream is read once per block. Its first
//    thread brings the x tile in by TMA (128-byte swizzle, one box per
//    64-channel panel); the two warpgroups pre-norm it in place into y, the
//    A operand of every product of the chunk. Each warpgroup owns G / 2
//    heads: per head, the K panels of qf^T_h and Wv_h stream through its
//    own TMA ring (three stages at G 8, two at G 4, where a smaller block
//    lets two share an SM), which its first thread refills as stages free
//    up (qf and Wv, 688 KB at the flagship, do not fit on chip), and wgmma
//    accumulates the logits (64 x 64 per m-block) and v (64 x HD) in
//    registers. The column
//    max and sum come from registers (shuffles over the rows a warp holds,
//    then a four-warp step through shared memory); bf16 e^T and v^T go to
//    shared memory once, and P_c = e^T @ v is one more wgmma. The chunk's
//    (m_c, l_c, P_c) go to device memory (flash-decoding partials). No
//    producer warps: ptxas budgets registers by whole warpgroups, and a
//    third one would hold every thread to 168 registers.
// 3. pool_merge_kernel<HD>: per (b, j, d) the clamped rescale and sum over
//    the chunks, pooled, and macc/sacc.
// 4. linear_nt_kernel (pool.cuh): h0 = pooled @ Wo^T on the tensor cores.
// A ragged N comes zero-padded to a multiple of 128 by the wrapper; the
// points from n_valid on are masked out of the chunk's softmax, and a
// chunk of padding alone adds exp(-80) * 0 to the merge.
// A chunk is TM = 64 points, one m-block: two m-blocks a warpgroup (128
// points, half the weight traffic and partials) ran faster on the H100 but
// spilled at ptxas's 255 registers. The grid is B*N/64 x H/G blocks: 2048
// at the flagship (B 64, N 2048, H 8, HD 48, G 8), 512 at the 8k width (B
// 2, N 8192, H 16), 1536 at the upsample demo's width (B 48, N 2048, C
// 128, H 4, HD 32, G 4).
// Shapes: I == 64, C % 64 == 0 and C <= 768, HD = C / H in (16, 32, 48,
// 64), G = 8 where H % 8 == 0, else 4 where H % 4 == 0, and the block's
// shared memory (ChunkSmem) within the SM's; the rest (three heads, another
// I) take csrc/pool_ext_wmma.cu.
#include <cmath>

#include "hopper.cuh"
#include "pool.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kInd = 64;       // inducers per head (I)
constexpr int kTM = 64;        // points per chunk: one 64-row m-block
constexpr int kQBytes = kInd * 128;  // one K panel of qf^T_h [64, 64]
// two warpgroups (their per-head accumulators need more than the 168
// registers a thread of a three-warpgroup block gets)
constexpr int kChunkThreads = 256;

// The constants of an instance: HD channels a head (D), G heads a block
// (G / 2 per consumer warpgroup). <48, 8> is the flagship's and the 8k
// width's, <32, 4> the upsample demo's.
template <int HD, int G>
struct Chunk {
  static constexpr int kHeads = G / 2;          // heads per warpgroup
  static constexpr int kRing = G == 8 ? 3 : 2;  // stages of each warpgroup's weight ring
  static constexpr int kWBytes = HD * 128;      // one K panel of Wv_h [HD, 64]
  static constexpr int kStageBytes = kQBytes + kWBytes;
  // two blocks a SM where the block is small (128 registers a thread)
  static constexpr int kMinBlocks = G == 4 && HD <= 32 ? 2 : 1;
};

// Shared-memory layout of a chunk block, in bytes from a 1024-aligned base
// (mirrored by folded_attention.py _pool_ext_smem: change both together).
template <int HD, int G>
struct ChunkSmem {
  int y, stages, et, vt, red, bars, total;
  __host__ __device__ explicit ChunkSmem(int C) {
    using K = Chunk<HD, G>;
    y = 0;
    stages = y + (C / 64) * kTM * 128;
    et = stages + 2 * K::kRing * K::kStageBytes;
    vt = et + 2 * kInd * 128;
    red = vt + 2 * HD * 128;
    bars = red + 2 * 2 * 4 * kInd * 4;
    total = bars + (1 + 2 * 2 * K::kRing) * 8 + 1024;  // + alignment slack
  }
};

// qft[hI + i, c] = bf16(scale * sum_d ind2[hI + i, d] * Wk[hD + d, c]), one
// 64 x 64 tile per block (I == 64).
__global__ void __launch_bounds__(kThreads)
pool_fold_kernel(const bf16* __restrict__ ind2, const bf16* __restrict__ kvw,
                 bf16* __restrict__ qft, int C, int D, float scale) {
  __shared__ __align__(128) float tile[64 * 64];
  const int h = blockIdx.y, c0 = blockIdx.x * 64;
  gemm_to_smem<wmma::row_major, wmma::row_major>(ind2 + (size_t)h * kInd * D, D,
                                                 kvw + (size_t)h * D * C + c0, C, tile, 64, 64,
                                                 64, D);
  __syncthreads();
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    qft[(size_t)(h * kInd + t / 64) * C + c0 + t % 64] = __float2bfloat16(scale * tile[t]);
  }
}

// kMask: the chunk's points may hold a ragged tail's padding (n_valid < N);
// without it the masks fold away (they cost the pool forward ~10% at N
// 2048 on the H100)
template <int HD, int G, bool kMask>
__global__ void __launch_bounds__(kChunkThreads, Chunk<HD, G>::kMinBlocks)
pool_chunk_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ se,
                  const float* __restrict__ be, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_p, int N, int n_valid,
                  int C, int H) {
  constexpr int TM = kTM;
  using K = Chunk<HD, G>;
  constexpr int kRing = K::kRing, kHeads = K::kHeads, kStageBytes = K::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const ChunkSmem<HD, G> L(C);
  const int KP = C / 64, J = H * kInd;
  const int tile = blockIdx.x, grp = blockIdx.y;
  const int b = tile * TM / N, n0 = tile * TM % N, nch = N / TM, ch = n0 / TM;
  const int row0 = tile * TM;
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
  // warpgroup w owns heads grp*G + w*G/2 ... + G/2 - 1; its first thread
  // keeps the warpgroup's weight ring filled: item it is the K panel it % KP
  // of qf^T and Wv of its head it / KP
  const bool loader = threadIdx.x % 128 == 0;
  auto load_stage = [&](int it) {
    const int h = grp * G + w * kHeads + it / KP, kp = it % KP, s = it % kRing;
    bar_expect(full + w * kRing + s, kStageBytes);
    tma_load(stage(w, s), &tm_q, full + w * kRing + s, h * kInd, kp * 64);
    tma_load(stage(w, s) + kQBytes, &tm_w, full + w * kRing + s, C + h * HD, kp * 64);
  };
  if (threadIdx.x == 0) {
    bar_expect(yfull, KP * TM * 128);
    for (int p = 0; p < KP; ++p) tma_load(y + p * TM * 128, &tm_x, yfull, row0, p * 64);
  }
  if (loader) {
    for (int it = 0; it < kRing && it < kHeads * KP; ++it) load_stage(it);
  }
  unsigned char* et = smem + L.et + w * kInd * 128;  // e^T [I, TM]
  unsigned char* vt = smem + L.vt + w * HD * 128;    // v^T [D, TM]
  float* red_m = reinterpret_cast<float*>(smem + L.red) + w * 2 * 4 * kInd;  // [4][I]
  float* red_l = red_m + 4 * kInd;

  // pre-norm the tile in place: y = bf16(x * se + be), 8 channels a chunk
  bar_wait(yfull, 0);
  const float* seb = se + (size_t)b * C;
  const float* beb = be + (size_t)b * C;
  for (int idx = threadIdx.x; idx < KP * TM * 8; idx += kChunkThreads) {
    const int p = idx / (TM * 8), r = (idx / 8) % TM, q = idx % 8;
    const int c = p * 64 + ((q ^ (r & 7)) << 3);
    int4* ptr = reinterpret_cast<int4*>(y + p * TM * 128 + r * 128 + q * 16);
    int4 raw = *ptr;
    bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = __float2bfloat16(__bfloat162float(v[e]) * __ldg(seb + c + e) + __ldg(beb + c + e));
    }
    *ptr = raw;
  }
  fence_async_smem();
  __syncthreads();

  const int col = 2 * (lane % 4);  // first column of the thread's pairs
  // whether the thread's rows r and r + 8 are points (not a ragged tail's
  // padding): a padding row takes no part in the max, the sum or P_c, and a
  // chunk of padding alone gives m_c = -inf, l_c = 0 and P_c = 0
  const int pt = n0 + wi * 16 + lane / 4;
  const bool ok0 = !kMask || pt < n_valid, ok1 = !kMask || pt + 8 < n_valid;
  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = grp * G + w * kHeads + hh;
    // the logits s = y @ qf_h and v = y @ Wv_h^T, one K panel of each a stage
    float s_acc[kInd / 2];
    float v_acc[HD / 2];
    for (int kp = 0; kp < KP; ++kp) {
      const int it = hh * KP + kp, s = it % kRing;
      bar_wait(full + w * kRing + s, (it / kRing) & 1);
      const uint64_t dq = desc(stage(w, s)), dw = desc(stage(w, s) + kQBytes);
      const uint64_t dy = desc(y + kp * TM * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss<kInd>(s_acc, dy + 2 * kk, dq + 2 * kk, (kp | kk) != 0);
        wgmma_ss<HD>(v_acc, dy + 2 * kk, dw + 2 * kk, (kp | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(v_acc);
      if (lane == 0) bar_arrive(empty + w * kRing + s);
      // refill the stage once all four warps are done with it
      if (loader && it + kRing < kHeads * KP) {
        bar_wait(empty + w * kRing + s, (it / kRing) & 1);
        load_stage(it + kRing);
      }
    }

    // bf16 v^T first, which frees v's registers (the last head's e^T @ v
    // is done with the buffer once every warp of the warpgroup is here)
    named_sync(2 + w, 128);
    const int r = wi * 16 + lane / 4;  // the thread's rows r and r + 8
#pragma unroll
    for (int g = 0; g < HD / 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * g + col + e;
        *reinterpret_cast<bf16*>(vt + swz(d, r, HD * 128)) = __float2bfloat16(v_acc[4 * g + e]);
        *reinterpret_cast<bf16*>(vt + swz(d, r + 8, HD * 128)) =
            __float2bfloat16(v_acc[4 * g + 2 + e]);
      }
    }

    // column max over the chunk's TM points
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
        if (lane < 4) red_m[wi * kInd + 8 * g + col + e] = m;
      }
    }
    named_sync(2 + w, 128);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int c = 8 * (q / 2) + col + q % 2;
      cm[q] = fmaxf(fmaxf(red_m[c], red_m[kInd + c]), fmaxf(red_m[2 * kInd + c], red_m[3 * kInd + c]));
    }
    // e = exp(max(s - m, -80)); its column sum; bf16 e^T
    float cl[16];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m = cm[2 * g + e];
        const float e0 = ok0 ? expf(fmaxf(s_acc[4 * g + e] - m, -80.0f)) : 0.0f;
        const float e1 = ok1 ? expf(fmaxf(s_acc[4 * g + 2 + e] - m, -80.0f)) : 0.0f;
        cl[2 * g + e] = e0 + e1;
        const int i = 8 * g + col + e;
        *reinterpret_cast<bf16*>(et + swz(i, r, kInd * 128)) = __float2bfloat16(e0);
        *reinterpret_cast<bf16*>(et + swz(i, r + 8, kInd * 128)) = __float2bfloat16(e1);
      }
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      float l = cl[q];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      if (lane < 4) red_l[wi * kInd + 8 * (q / 2) + col + q % 2] = l;
    }

    fence_async_smem();
    named_sync(2 + w, 128);

    // P_c = e^T @ v over the chunk's points
    float p_acc[HD / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk) {
      wgmma_ss<HD>(p_acc, desc(et) + 2 * kk, desc(vt) + 2 * kk, kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(p_acc);

    const size_t base = ((size_t)b * nch + ch) * J + (size_t)h * kInd;
    if (wi == 0 && lane < 4) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int c = 8 * (q / 2) + col + q % 2;
        part_m[base + c] = cm[q];
        part_l[base + c] = red_l[c] + red_l[kInd + c] + red_l[2 * kInd + c] + red_l[3 * kInd + c];
      }
    }
    const int i0 = wi * 16 + lane / 4;
#pragma unroll
    for (int g = 0; g < HD / 8; ++g) {
      const int d = 8 * g + col;
      *reinterpret_cast<float2*>(part_p + (base + i0) * HD + d) =
          make_float2(p_acc[4 * g], p_acc[4 * g + 1]);
      *reinterpret_cast<float2*>(part_p + (base + i0 + 8) * HD + d) =
          make_float2(p_acc[4 * g + 2], p_acc[4 * g + 3]);
    }
  }
}

// Per (b, j, d): the clamped rescale of the chunks' partials, pooled, and
// the final column max and sum for the backward.
template <int HD>
__global__ void __launch_bounds__(kThreads)
pool_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                  const float* __restrict__ part_p, bf16* __restrict__ pooled,
                  float* __restrict__ macc, float* __restrict__ sacc, int B, int nch, int C,
                  int H) {
  const int J = H * kInd;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * J * HD) return;
  const int d = (int)(idx % HD), j = (int)(idx / HD % J), b = (int)(idx / ((long long)HD * J));
  const float* pm = part_m + (size_t)b * nch * J + j;
  const float* pl = part_l + (size_t)b * nch * J + j;
  const float* pp = part_p + ((size_t)b * nch * J + j) * HD + d;
  float M = -3.0e38f;
  for (int c = 0; c < nch; ++c) M = fmaxf(M, pm[(size_t)c * J]);
  float Lsum = 0.0f, P = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const float corr = expf(fmaxf(pm[(size_t)c * J] - M, -80.0f));
    Lsum += corr * pl[(size_t)c * J];
    P += corr * pp[(size_t)c * J * HD];
  }
  const int h = j / kInd, i = j % kInd;
  pooled[((size_t)b * kInd + i) * C + h * HD + d] = __float2bfloat16(P * (1.0f / Lsum));
  if (macc != nullptr && d == 0) {
    macc[(size_t)b * J + j] = M;
    sacc[(size_t)b * J + j] = Lsum;
  }
}

// The chunk and merge kernels of instance <HD, G>.
template <int HD, int G>
cudaError_t launch_chunks(const CUtensorMap& tm_x, const CUtensorMap& tm_q,
                          const CUtensorMap& tm_w, const float* se, const float* be,
                          float* part_m, float* part_l, float* part_p, bf16* pooled, float* macc,
                          float* sacc, int B, int N, int C, int H, int n_valid, cudaStream_t st) {
  const ChunkSmem<HD, G> L(C);
  const auto chunk = n_valid < N ? pool_chunk_kernel<HD, G, true> : pool_chunk_kernel<HD, G, false>;
  cudaError_t err = set_smem((const void*)chunk, L.total);
  if (err != cudaSuccess) return err;
  chunk<<<dim3(B * N / kTM, H / G), kChunkThreads, L.total, st>>>(
      tm_x, tm_q, tm_w, se, be, part_m, part_l, part_p, N, n_valid, C, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long elems = (long long)B * H * kInd * HD;
  pool_merge_kernel<HD><<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part_m, part_l, part_p, pooled, macc, sacc, B, N / kTM, C, H);
  return cudaGetLastError();
}

// Bytes of a chunk block of the instance these shapes take, 0 where none
// does (folded_attention.py _pool_ext_hopper_takes: change both together).
int chunk_smem(int C, int H, int I) {
  if (I != kInd || H < 1 || C % H != 0 || C % 64 != 0 || C > 768 || H % 4 != 0) return 0;
  const int D = C / H;
  const bool g8 = H % 8 == 0;
  int total = 0;
  switch (D) {
    case 16: total = g8 ? ChunkSmem<16, 8>(C).total : ChunkSmem<16, 4>(C).total; break;
    case 32: total = g8 ? ChunkSmem<32, 8>(C).total : ChunkSmem<32, 4>(C).total; break;
    case 48: total = g8 ? ChunkSmem<48, 8>(C).total : ChunkSmem<48, 4>(C).total; break;
    case 64: total = g8 ? ChunkSmem<64, 8>(C).total : ChunkSmem<64, 4>(C).total; break;
    default: return 0;
  }
  return total <= (int)kMaxSmem ? total : 0;
}

}  // namespace

extern "C" int pool_ext_launch(const void* x, const void* se, const void* be, const void* ind2,
                               const void* kvw, const void* wo, void* qft, void* part_m,
                               void* part_l, void* part_p, void* pooled, void* h0, void* macc,
                               void* sacc, int B, int N, int C, int H, int I, int n_valid,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk_smem(C, H, I) == 0) return (int)cudaErrorInvalidValue;
  const int D = C / H, J = H * I;
  if (N % kTM != 0 || n_valid < 1 || n_valid > N) return (int)cudaErrorInvalidValue;
  // 1/sqrt(D) rounded to fp32, as the plain fold's scalar
  const float scale = (float)(1.0 / sqrt((double)D));
  pool_fold_kernel<<<dim3(C / 64, H), kThreads, 0, st>>>((const bf16*)ind2, (const bf16*)kvw,
                                                         (bf16*)qft, C, D, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_x, tm_q, tm_w;
  if (encode_tiled(&tm_x, x, (uint64_t)B * N, C, kTM) != CUDA_SUCCESS ||
      encode_tiled(&tm_q, qft, J, C, kInd) != CUDA_SUCCESS ||
      encode_tiled(&tm_w, kvw, 2 * (uint64_t)C, C, D) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const auto chunks = [&](auto run) {
    return run(tm_x, tm_q, tm_w, (const float*)se, (const float*)be, (float*)part_m,
               (float*)part_l, (float*)part_p, (bf16*)pooled, (float*)macc, (float*)sacc, B, N,
               C, H, n_valid, st);
  };
  const bool g8 = H % 8 == 0;
  switch (D) {
    case 16: err = chunks(g8 ? launch_chunks<16, 8> : launch_chunks<16, 4>); break;
    case 32: err = chunks(g8 ? launch_chunks<32, 8> : launch_chunks<32, 4>); break;
    case 48: err = chunks(g8 ? launch_chunks<48, 8> : launch_chunks<48, 4>); break;
    default: err = chunks(g8 ? launch_chunks<64, 8> : launch_chunks<64, 4>); break;
  }
  if (err != cudaSuccess) return (int)err;
  linear_nt_kernel<<<dim3(C / 64, B * I / 64), kThreads, 0, st>>>(
      (const bf16*)pooled, (const bf16*)wo, (bf16*)h0, B * I, C, C);
  return (int)cudaGetLastError();
}
