// Fused pre-norm + Gaussian MLP + residual, with the output channel sums:
// the narrow Hopper body (TMA and wgmma), for C 128 and W 128 or 256 (the
// upsample demo's 3 x 128 model, W = 2C).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_mlp_kernel (served by
// fused_mlp_residual), with its algebra and roundings:
//   y = bf16(x * se + be);  h = y @ w1t + b1;  g = bf16(exp(-h^2 / 2))
//   o = (g @ w2t + b2) + x;  out = bf16(o);  sums[b] = [sum o | sum o^2]
// (alpha and the normalized-activation affine are folded into w1t/b1 and
// w2t/b2 by the caller).
//
// Bound on the H100: the stream (4 N C bytes in and out per batch element
// against 4 N C W FLOP: W = 256 FLOP per byte, under the bf16 ridge of
// about 295). The pass design of csrc/mlp.cu keeps the [B N, W] hidden
// plane in device memory because the flagship's weights do not fit in
// shared memory beside a ring; here both weights are 128 KB together, so
// they stay resident and the hidden plane never leaves the registers.
//
// Design: one persistent block a SM, 384 threads.
// - A producer warpgroup (one thread issues every load) brings w1t [C, W]
//   and w2t [W, C] once by TMA into shared memory, as 64 x 64 MN-major
//   panels in the 128-byte swizzle (the layout mlp_gemm reads with TB = 1),
//   then keeps a two-stage ring of x tiles [128, C] full, walking the
//   128-row tiles of [B N, C] in grid-stride order.
// - Two consumer warpgroups take 64 rows of the tile each. A thread forms
//   y = bf16(x se + be) (the FMA of prenorm_kernel, backward.cuh) straight
//   from the tile into the A fragments of the first product; for each
//   128-column half of W, h = y @ w1t[:, half] into a [64, 128] fp32
//   accumulator by wgmma (A from registers); g = bf16(exp(-(h + b1)^2 / 2))
//   packed in registers into the A fragments of the second product (the
//   accumulator-to-operand hand-off of csrc/induced_attention.cu's P V);
//   o += g @ w2t[half, :] into a [64, C] fp32 accumulator.
// - The epilogue from the registers: o = (acc + b2) + x (x read again from
//   the tile), out = bf16(o) stored, and the tile's column sums of o and
//   o^2 over the rows before n_valid (a ragged N's zero padding stays out)
//   in mlp_gemm's fixed order (the thread's two rows, shuffles over a
//   warp's rows, the eight warps in order) into the tile's own slot of
//   part[B N / 128, 2, C]; the slot belongs to the tile, not the block, so
//   the order does not depend on the schedule. mlp_colsum_kernel then adds
//   each batch element's tiles in order: no atomics, the same bits from
//   call to call.
// Shared memory: the weights 128 KB, the ring 2 x 32 KB, the sums' staging
// 2 x 8 KB (by tile parity), b1 and b2, the barriers: ~211 KB. Registers of
// a consumer thread: the y fragments (32), h (64), the g fragments (32) and
// o (64); setmaxnreg gives the consumers 240 and the producer 24.
// folded_attention.py's _mlp_narrow_takes repeats narrow_takes below:
// change both together.
#include "mlp_hopper.cuh"
#include "rect_hopper.cuh"

using namespace gecco;
using namespace gecco::hopper;

namespace {

constexpr int kC = 128;                    // channels
constexpr int kMaxW = 256;                 // hidden width
constexpr int kTileRows = 128;             // rows of a tile: two warpgroups of 64
constexpr int kHalf = 128;                 // hidden columns of one product pair
constexpr int kWPanel = 64 * 128;          // a 64 x 64 weight panel
constexpr int kXPanel = kTileRows * 128;   // 64 columns of a tile's 128 rows
constexpr int kCP = kC / 64;               // 64-column panels of C
constexpr int kStages = 2;
constexpr int kThreadsNarrow = 384;

// Shared memory, in bytes from a 1024-aligned base.
struct Smem {
  static constexpr int w1 = 0;                                  // [C / 64][W / 64] panels
  static constexpr int w2 = w1 + kC * kMaxW * 2;                // [W / 64][C / 64] panels
  static constexpr int ring = w2 + kMaxW * kC * 2;              // [kStages][kCP] x panels
  static constexpr int red = ring + kStages * kCP * kXPanel;    // [2][2 sums][8 warps][C] fp32
  static constexpr int b1 = red + 2 * 2 * 8 * kC * 4;           // [W] fp32
  static constexpr int b2 = b1 + kMaxW * 4;                     // [C] fp32
  static constexpr int bars = b2 + kC * 4;                      // wbar, full[2], empty[2]
  static constexpr int total = bars + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};
static_assert(Smem::total <= (int)kMaxSmem, "mlp_narrow: shared memory");

bool narrow_takes(int N, int C, int W) {
  return C == kC && (W == 128 || W == 256) && N % kTileRows == 0 && N >= kTileRows;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ const uint32_t (&kstep32(const uint32_t (&a)[32], int kk))[4] {
  return *reinterpret_cast<const uint32_t(*)[4]>(a + 4 * kk);
}

__global__ void __launch_bounds__(kThreadsNarrow, 1)
mlp_narrow_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w1,
                  const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ se,
                  const float* __restrict__ be,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  bf16* __restrict__ out, float* __restrict__ part, int tiles, int rows_b,
                  int n_valid, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* w1s = smem + Smem::w1;
  unsigned char* w2s = smem + Smem::w2;
  float* b1s = reinterpret_cast<float*>(smem + Smem::b1);
  float* b2s = reinterpret_cast<float*>(smem + Smem::b2);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + kStages;
  auto stage = [&](int s) { return smem + Smem::ring + s * kCP * kXPanel; };
  const int WP = W / 64;

  if (threadIdx.x == 0) {
    bar_init(wbar, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // the consumers' eight warps
    }
    fence_barrier_init();
  }
  for (int c = threadIdx.x; c < W; c += kThreadsNarrow) b1s[c] = b1[c];
  for (int c = threadIdx.x; c < kC; c += kThreadsNarrow) b2s[c] = b2[c];
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: the weights once, then the ring of x tiles
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      bar_expect(wbar, 2 * kC * W * 2);
      for (int kb = 0; kb < kCP; ++kb) {
        for (int p = 0; p < WP; ++p) {
          tma_load(w1s + (kb * WP + p) * kWPanel, &tm_w1, wbar, kb * 64, p * 64);
        }
      }
      for (int kb = 0; kb < WP; ++kb) {
        for (int p = 0; p < kCP; ++p) {
          tma_load(w2s + (kb * kCP + p) * kWPanel, &tm_w2, wbar, kb * 64, p * 64);
        }
      }
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const int s = it % kStages;
        if (it >= kStages) bar_wait(empty + s, ((it / kStages) - 1) & 1);
        bar_expect(full + s, kCP * kXPanel);
        for (int p = 0; p < kCP; ++p) {
          tma_load(stage(s) + p * kXPanel, &tm_x, full + s, tile * kTileRows, p * 64);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows 64 w ... 64 w + 63 of each tile
  setmaxnreg_inc<240>();
  const int w = wg, col = 2 * (lane % 4), r = (warp % 4) * 16 + lane / 4;
  const int lr0 = 64 * w + r, lr1 = lr0 + 8;  // the thread's two rows of the tile
  bar_wait(wbar, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int s = it % kStages;
    unsigned char* xs = stage(s);
    bar_wait(full + s, (it / kStages) & 1);
    const long long row0 = (long long)tile * kTileRows;
    const int bidx = (int)(row0 / rows_b);
    const float* seb = se + (size_t)bidx * kC;
    const float* beb = be + (size_t)bidx * kC;

    // y in the A fragments of the first product: k step kk holds columns
    // 16 kk + col + {0, 1} (+ 8) of rows lr0 and lr1
    uint32_t ya[kC / 4];
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 16 * kk + col + 8 * (j >> 1), lr = (j & 1) ? lr1 : lr0;
        const float2 xv = mlp::ld_bf2(reinterpret_cast<const bf16*>(xs + swz(lr, c, kXPanel)));
        const float2 sv = __ldg(reinterpret_cast<const float2*>(seb + c));
        const float2 bv = __ldg(reinterpret_cast<const float2*>(beb + c));
        ya[4 * kk + j] = pack2(__fmaf_rn(xv.x, sv.x, bv.x), __fmaf_rn(xv.y, sv.y, bv.y));
      }
    }

    float o[kC / 2];
    zero(o);
    for (int hh = 0; hh < W / kHalf; ++hh) {
      // h = y @ w1t[:, half]
      float h[kHalf / 2];
      zero(h);
      fence_regs(h);
      fence_u32(ya);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks) {
        rect::wgmma_rs_t(h, kstep32(ya, ks),
                         desc_mn(w1s + ((ks / 4) * WP + 2 * hh) * kWPanel + (ks % 4) * 2048,
                                 kWPanel),
                         1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(h);
      fence_u32(ya);
      // g = bf16(exp(-(h + b1)^2 / 2)) in the A fragments of the second
      // product: pair m holds h[2 m], h[2 m + 1] (columns 8 (m / 2) + col
      // + {0, 1} of row lr0 for even m, of lr1 for odd)
      uint32_t ga[kHalf / 4];
#pragma unroll
      for (int m = 0; m < kHalf / 4; ++m) {
        const float2 bb =
            *reinterpret_cast<const float2*>(b1s + kHalf * hh + 8 * (m / 2) + col);
        const float h0 = h[2 * m] + bb.x, h1 = h[2 * m + 1] + bb.y;
        ga[m] = pack2(expf(-0.5f * h0 * h0), expf(-0.5f * h1 * h1));
      }
      // o += g @ w2t[half, :]
      fence_u32(ga);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kHalf / 16; ++ks) {
        rect::wgmma_rs_t(o, kstep32(ga, ks),
                         desc_mn(w2s + ((2 * hh + ks / 4) * kCP) * kWPanel + (ks % 4) * 2048,
                                 kWPanel),
                         1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_u32(ga);
    }
    fence_u32(ya);

    // epilogue: o = (acc + b2) + x, out = bf16(o), the tile's column sums
    const long long grow0 = row0 + lr0;
    const int pt = (int)(grow0 - (long long)bidx * rows_b);  // the row's point in its element
    const bool ok0 = pt < n_valid, ok1 = pt + 8 < n_valid;
    float* red = reinterpret_cast<float*>(smem + Smem::red) + (it & 1) * 2 * 8 * kC;
#pragma unroll
    for (int gi = 0; gi < kC / 8; ++gi) {
      const int c = 8 * gi + col;
      const float2 bb = *reinterpret_cast<const float2*>(b2s + c);
      const float2 x0 = mlp::ld_bf2(reinterpret_cast<const bf16*>(xs + swz(lr0, c, kXPanel)));
      const float2 x1 = mlp::ld_bf2(reinterpret_cast<const bf16*>(xs + swz(lr1, c, kXPanel)));
      const float o0 = (o[4 * gi] + bb.x) + x0.x, o1 = (o[4 * gi + 1] + bb.y) + x0.y;
      const float o2 = (o[4 * gi + 2] + bb.x) + x1.x, o3 = (o[4 * gi + 3] + bb.y) + x1.y;
      const size_t i0 = (size_t)grow0 * kC + c;
      mlp::st_bf2(out + i0, o0, o1);
      mlp::st_bf2(out + i0 + 8 * kC, o2, o3);
      const float u0 = ok0 ? o0 : 0.0f, u1 = ok0 ? o1 : 0.0f;
      const float u2 = ok1 ? o2 : 0.0f, u3 = ok1 ? o3 : 0.0f;
      const float s00 = mlp::rows_sum(u0 + u2), s01 = mlp::rows_sum(u1 + u3);
      const float s10 = mlp::rows_sum(u0 * u0 + u2 * u2), s11 = mlp::rows_sum(u1 * u1 + u3 * u3);
      if (lane < 4) {
        red[warp * kC + c] = s00;
        red[warp * kC + c + 1] = s01;
        red[(8 + warp) * kC + c] = s10;
        red[(8 + warp) * kC + c + 1] = s11;
      }
    }
    // the warp is done with the tile: release its stage
    __syncwarp();
    if (lane == 0) bar_arrive(empty + s);
    named_sync(1, 256);
    for (int k = threadIdx.x; k < 2 * kC; k += 256) {
      const int q = k / kC, cc = k % kC;
      float t = 0.0f;
#pragma unroll
      for (int wp = 0; wp < 8; ++wp) t += red[(q * 8 + wp) * kC + cc];
      part[((size_t)tile * 2 + q) * kC + cc] = t;
    }
  }
}

}  // namespace

// Shared memory of one block (for the wrapper's mirror).
extern "C" int mlp_narrow_smem() { return Smem::total; }

// x [B, N, C] bf16 with N the padded point count (a multiple of 128; the
// points from n_valid on are zero padding); part [B N / 128, 2, C] fp32 is
// the wrapper's scratch; out [B, N, C] bf16, sums [B, 2, C] fp32 (written,
// not added to).
extern "C" int mlp_narrow_launch(const void* x, const void* se, const void* be, const void* w1t,
                                 const void* b1, const void* w2t, const void* b2, void* part,
                                 void* out, void* sums, int B, int N, int C, int W, int n_valid,
                                 void* stream) {
  if (!narrow_takes(N, C, W) || B < 1 || n_valid < 1 || n_valid > N) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long M = (long long)B * N;
  const int tiles = (int)(M / kTileRows);
  CUtensorMap tm_x, tm_w1, tm_w2;
  if (!mlp::tmap(&tm_x, x, M, C, kTileRows) || !mlp::tmap(&tm_w1, w1t, C, W, 64) ||
      !mlp::tmap(&tm_w2, w2t, W, C, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem((const void*)mlp_narrow_kernel, Smem::total);
  if (err != cudaSuccess) return (int)err;
  mlp_narrow_kernel<<<dim3((unsigned)(tiles < sms ? tiles : sms)), kThreadsNarrow, Smem::total,
                      st>>>(tm_x, tm_w1, tm_w2, (const float*)se,
                            (const float*)be, (const float*)b1, (const float*)b2, (bf16*)out,
                            (float*)part, tiles, N, n_valid, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)mlp::launch_colsum((const float*)part, (float*)sums, B, N / kTileRows, 2, C, st);
}
