// Fused h-side of a broadcasting layer, on the [I, C] inducer tokens: the
// Hopper body (TMA and wgmma), the flagship's.
//
// Replaces gecco_tpu/ops/pallas/hside.py:_hside_kernel (served by
// fused_h_side), with its algebra and roundings. Per token set (batch
// element) b, with set-level GroupNorm statistics in fp32 over its I tokens:
//   y1 = bf16((h0 - m1) * (i1 * s1) + b1n);  a = y1 @ w1t + b1
//   g = bf16(exp(-a^2 / 2));  hh = g @ w2t + b2 (fp32)
//   h = bf16((hh - m2) * (i2 * s2) + b2n);  k = bf16(h @ wk^T);  v = bf16(h @ wv^T)
// (alpha and the normalized-activation affine are folded into w1t/b1 and
// w2t/b2 by the caller).
//
// Bound on the H100: tensor-core operations, 4 I C W + 4 I C C FLOP per set
// (7.2 GFLOP at the flagship's batch 64: 7 us at the bf16 peak), against a
// few MB of tokens and weights. The WMMA body (csrc/hside_wmma.cu) ran one
// block per set, 64 blocks for 132 SMs, each walking the [I, W] hidden
// plane through shared memory. Here every product is one pass over all B I
// token rows at once (M = 4096 at batch 64), mlp_hopper.cuh's mlp_gemm with
// 128 x 128 output tiles (TMA rings in the 128-byte swizzle, wgmma with
// register accumulators, the algebra in the epilogue), and the operands
// cross memory between passes at the TPU kernel's rounding points (y1, g,
// h in bf16) or in fp32 (hh), five launches:
// 1. hside_norm_kernel<false>, one block per (set, 16 rows): the set's
//    channel sums of h0 and h0^2 (16-byte loads, row phases added in a
//    fixed order), each group's mean and inv, then y1 of its 16 rows;
// 2. hside_act_kernel (kAct): g = bf16(exp(-(y1 @ w1t + b1)^2 / 2));
// 3. hside_out_kernel (kHOut): hh = g @ w2t + b2 in fp32, and each warp's
//    16-row sums of hh and hh^2: a set is I / 16 such slabs;
// 4. hside_norm_kernel<true>: norm_2's statistics from those slabs (added
//    in order), then h of the block's 16 rows;
// 5. hside_kv_kernel (kKV): [k | v] = h @ [Wk; Wv]^T, one product of 2C
//    columns whose tiles read Wk or Wv by their column.
// Every sum is in a fixed order: every output is the same bits from call to
// call. Any I that is a multiple of 16 fits (the sets are 16-row aligned),
// and a ragged I comes zero-padded to one by the wrapper (i_valid: the
// statistics count and sum the set's rows before it); the row blocks run
// over B I padded to 128 rows (the padding rows' results are never read).
#include "mlp_hopper.cuh"

using namespace gecco;
using namespace gecco::mlp;

namespace {

constexpr int kBn = 128;     // column tile of the three products
constexpr int kStages = 4;
constexpr int kSlab = 16;    // rows of one statistics slab (one warp's)

MLP_GEMM_KERNEL(hside_act_kernel, kBn, 1, kAct, kStages)
MLP_GEMM_KERNEL(hside_out_kernel, kBn, 1, kHOut, kStages)
MLP_GEMM_KERNEL(hside_kv_kernel, kBn, 0, kKV, kStages)

__device__ __forceinline__ float ld_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld_f(const float* p) { return *p; }

// One block per (set b, slab q of 16 rows). The set's channel sums of z and
// z^2 over its first Iv of I rows (the rest a ragged I's zero padding): from
// z itself (FROM_PART false: h0, 8 channels per 16-byte load, rp row phases
// added in order; the padding rows are 0) or from the out pass's slab sums
// part [M / 16, 2, C] (added in slab order; a slab holding padding rows is
// summed from z's rows before Iv instead); then per group (C / G contiguous
// channels, in order) mean = g1 / count, inv = 1 / sqrt(max(g2 / count -
// mean^2, 0) + 1e-5), count = Iv C / G; then out = bf16((z - mean) * (inv *
// s) + bias) for the block's 16 rows, with the plain version's separate
// roundings (no fused multiply-add).
template <bool FROM_PART, class T>
__global__ void __launch_bounds__(kThreads)
hside_norm_kernel(const T* __restrict__ z, const float* __restrict__ part,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int I, int Iv, int C, int G) {
  __shared__ float red[2][2048];
  __shared__ float stat[2][2048];  // the channels' mean and inv * scale
  const int b = blockIdx.x, q = blockIdx.y, slabs = I / kSlab;
  const size_t set0 = (size_t)b * I;
  if constexpr (FROM_PART) {
    const int whole = Iv / kSlab;  // the slabs free of padding
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int k = 0; k < whole; ++k) {
        const float* pk = part + (set0 / kSlab + k) * 2 * C;
        s1 += pk[c];
        s2 += pk[C + c];
      }
      for (int r = whole * kSlab; r < Iv; ++r) {
        const float f = ld_f(z + (set0 + r) * C + c);
        s1 += f;
        s2 += f * f;
      }
      red[0][c] = s1;
      red[1][c] = s2;
    }
  } else {
    const int vecs = C / 8, rp = kThreads / vecs;
    const int v = threadIdx.x % vecs, r0 = threadIdx.x / vecs;
    if (r0 < rp) {
      float s1[8], s2[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.0f;
      for (int r = r0; r < I; r += rp) {
        int4 raw = __ldg(reinterpret_cast<const int4*>(z + (set0 + r) * C + v * 8));
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float f = __bfloat162float(e[k]);
          s1[k] += f;
          s2[k] += f * f;
        }
      }
      // row phase r0's sums, in stat until every phase is in
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        stat[0][r0 * C + v * 8 + k] = s1[k];
        stat[1][r0 * C + v * 8 + k] = s2[k];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < rp; ++r) {
        a1 += stat[0][r * C + c];
        a2 += stat[1][r * C + c];
      }
      red[0][c] = a1;
      red[1][c] = a2;
    }
  }
  __syncthreads();
  const int pg = C / G;
  const float count = (float)(Iv * pg);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float g1 = 0.0f, g2 = 0.0f;
    for (int c = g * pg; c < (g + 1) * pg; ++c) {
      g1 += red[0][c];
      g2 += red[1][c];
    }
    const float mean = g1 / count;
    const float inv = 1.0f / sqrtf(fmaxf(g2 / count - mean * mean, 0.0f) + 1e-5f);
    for (int c = g * pg; c < (g + 1) * pg; ++c) {
      stat[0][c] = mean;
      stat[1][c] = __fmul_rn(inv, scale[(size_t)b * C + c]);
    }
  }
  __syncthreads();
  const size_t row0 = set0 + (size_t)q * kSlab;
  for (int t = threadIdx.x; t < kSlab * C / 2; t += kThreads) {
    const int r = t / (C / 2), c = 2 * (t % (C / 2));
    const size_t e = (row0 + r) * C + c;
    float o[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      o[k] = __fadd_rn(__fmul_rn(__fsub_rn(ld_f(z + e + k), stat[0][c + k]), stat[1][c + k]),
                       bias[(size_t)b * C + c + k]);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(o[0], o[1]);
  }
}

}  // namespace

// The shapes this body takes (change _hside_hopper_takes in the wrapper
// with it): I a multiple of 16, C and W of 128, C at most 2048 (the norm
// kernel's shared sums), G dividing C.
static bool hopper_takes(int I, int C, int W, int G) {
  return I % kSlab == 0 && C % kBn == 0 && W % kBn == 0 && C <= 2048 && G > 0 && C % G == 0;
}

// i_valid: each set's rows before a ragged I's zero padding (I where none).
// Scratch from the wrapper: y1 and h [Mp, C] bf16 (h is an output: its
// first B I rows), g [Mp, W] bf16, hh [Mp, C] and part [Mp / 16, 2, C]
// fp32; k and v [Mp, C] bf16 (their first B I rows are the outputs). Mp is
// B I rounded up to the 128-row block.
extern "C" int hside_launch(const void* h0, const void* s1n, const void* b1n, const void* s2n,
                            const void* b2n, const void* w1t, const void* b1, const void* w2t,
                            const void* b2, const void* wk, const void* wv, void* y1, void* g,
                            void* hh, void* part, void* h, void* k, void* v, int B, int I, int C,
                            int W, int G, int i_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!hopper_takes(I, C, W, G) || i_valid < 1 || i_valid > I) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * I, Mp = (M + kRows - 1) / kRows * kRows;
  const dim3 norm_grid(B, I / kSlab);
  hside_norm_kernel<false, bf16><<<norm_grid, kThreads, 0, st>>>(
      (const bf16*)h0, nullptr, (const float*)s1n, (const float*)b1n, (bf16*)y1, I, i_valid, C,
      G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_y1, tm_w1, tm_g, tm_w2, tm_h, tm_wk, tm_wv;
  if (!tmap(&tm_y1, y1, Mp, C, 64) || !tmap(&tm_w1, w1t, C, W, 64) || !tmap(&tm_g, g, Mp, W, 64) ||
      !tmap(&tm_w2, w2t, W, C, 64) || !tmap(&tm_h, h, Mp, C, 64) ||
      !tmap(&tm_wk, wk, C, C, kBn) || !tmap(&tm_wv, wv, C, C, kBn)) {
    return (int)cudaErrorInvalidValue;
  }
  MlpEpi e{};
  e.K = C;
  e.N = W;
  e.rows_b = (int)Mp;
  e.bias = (const float*)b1;
  e.out = (bf16*)g;
  err = launch_gemm<kBn, kAct, kStages>(hside_act_kernel, tm_y1, tm_w1, tm_y1, tm_w1, e, Mp, st);
  if (err != cudaSuccess) return (int)err;
  e = MlpEpi{};
  e.K = W;
  e.N = C;
  e.rows_b = (int)Mp;
  e.bias = (const float*)b2;
  e.gp = (float*)hh;
  e.part = (float*)part;
  err = launch_gemm<kBn, kHOut, kStages>(hside_out_kernel, tm_g, tm_w2, tm_g, tm_w2, e, Mp, st);
  if (err != cudaSuccess) return (int)err;
  hside_norm_kernel<true, float><<<norm_grid, kThreads, 0, st>>>(
      (const float*)hh, (const float*)part, (const float*)s2n, (const float*)b2n, (bf16*)h, I,
      i_valid, C, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  e = MlpEpi{};
  e.K = C;
  e.N = 2 * C;
  e.rows_b = (int)Mp;
  e.split = C;
  e.out = (bf16*)k;
  e.out2 = (bf16*)v;
  return (int)launch_gemm<kBn, kKV, kStages>(hside_kv_kernel, tm_h, tm_wk, tm_h, tm_wv, e, Mp, st);
}
