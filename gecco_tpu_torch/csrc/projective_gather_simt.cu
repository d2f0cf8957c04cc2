// Projective gather, the SIMT bodies: bilinear lookup of every point in
// every level of a channels-last feature pyramid, forward and backward, one
// warp per point. The default bodies are projective_gather.cu's; these take
// every operand those do not: fp32 levels, a level's C not a multiple of 8
// (odd too), a level or the cotangent not 16-byte aligned, more than 4096
// points in the backward, more than four levels (the wrapper launches them
// in groups of kMaxLevels). They are forced by name
// (ops/kernels/projective_gather.py _gather_simt, _gather_bwd_simt).
//
// Replaces gecco_tpu/ops/pallas/projective_gather.py:_gather_kernel (the
// forward, served by projective_gather) and :_gather_bwd_kernel (the
// backward, served by projective_gather_bwd). For point n of batch element b
// and level l of size H x W x C, the pixel coordinate is (ch, cw) =
// hw01[b, n] * (H, W) with no half-pixel offset; the corners are floor and
// floor + 1, and a corner outside the image contributes zero:
//   out[b, n, off_l + c] = sum_corners w_k F_l[b, h_k, w_k, c]
//   dF_l[b, h_k, w_k, c] += w_k g[b, n, off_l + c]
//   dhw01[b, n] = sum_l (H dch_l, W dcw_l), dch_l = sum_k dw_k/dch (g . F_l[corner k])
// The TPU kernel wrote the lookup as a product with a one-hot [TN, H*W]
// weight matrix (TPUs gather badly); here each point reads its four
// corners directly.
//
// Bound on the H100: bytes. A point does about 8 operations per channel
// against 2 or 4 bytes of output and 8 or 16 bytes of corner reads, far
// below the card's ridge. Design: one warp per point, the lanes on
// neighbouring channel pairs where a level's pairs are aligned (C even, the
// level, the output or cotangent row and its column offset all on a pair's
// width), so each corner's C-vector (contiguous in channels-last order) is
// read by one coalesced load of a pair per lane, weighed in fp32 and
// written as one row into the concatenated [B, N, sum C] output; elsewhere
// the lanes take single channels, still coalesced. The kernels are
// templated on the element type: bf16 or fp32 levels, output and
// cotangent; the weights and the sums are fp32 in both. One launch serves
// up to kMaxLevels levels, writing its columns col .. col + sum C of rows
// ctot wide, so the concatenation costs no copy. The backward adds w_k g
// into an fp32 buffer with atomics (many points share a pixel; blocks run
// in no order), which the wrapper zeroes and casts to the levels' dtype;
// the coordinate gradient's per-corner dot products are summed across the
// warp with shuffles, F is read only when it is asked for, and a launch
// after a group's first starts each point's sum from what the earlier
// launch wrote (``accumulate``), so the levels are summed in order as in
// one launch.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // points per block

// element type codes of the C interface
constexpr int kBF16 = 0, kF32 = 1;

template <typename T>
struct Pyramid {
  const T* f[kMaxLevels];        // [B, H, W, C] per level
  long long dfoff[kMaxLevels];   // the level's offset in the fp32 dF buffer
  int h[kMaxLevels], w[kMaxLevels], c[kMaxLevels];
  bool pairs[kMaxLevels];        // the level's channels taken two a lane
  int levels;
  int col;   // the first level's column in a row of out or g
  int ctot;  // the row length of out and g
};

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// Corners (h0, w0), (h0, w0 + 1), (h0 + 1, w0), (h0 + 1, w0 + 1) of one
// point on one level: the flattened index h * W + w (0 outside), whether
// the corner lies in the image, and its bilinear weight (0 outside).
struct Corners {
  int idx[4];
  bool valid[4];
  float wt[4];
  float fh, fw;
};

__device__ __forceinline__ Corners corners(float ch, float cw, int H, int W) {
  Corners k;
  const float h0 = floorf(ch), w0 = floorf(cw);
  k.fh = ch - h0;
  k.fw = cw - w0;
  // clamp the floor before the int cast, so that NaN or huge coordinates
  // land outside the image and never index it
  const int h0i = (int)fminf(fmaxf(h0, -2.0f), (float)(H + 1));
  const int w0i = (int)fminf(fmaxf(w0, -2.0f), (float)(W + 1));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int hi = h0i + (q >> 1), wi = w0i + (q & 1);
    k.valid[q] = hi >= 0 && hi < H && wi >= 0 && wi < W;
    k.idx[q] = k.valid[q] ? hi * W + wi : 0;
    const float wh = (q >> 1) ? k.fh : 1.0f - k.fh;
    const float ww = (q & 1) ? k.fw : 1.0f - k.fw;
    k.wt[q] = k.valid[q] ? wh * ww : 0.0f;
  }
  return k;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const float* __restrict__ hw01, Pyramid<T> p, T* __restrict__ out, int N,
              int total) {
  const int point = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (point >= total) return;
  const int b = point / N;
  const float u = hw01[2 * (size_t)point], v = hw01[2 * (size_t)point + 1];
  T* orow = out + (size_t)point * p.ctot + p.col;
  int off = 0;
  // unrolled over the fixed level bound, so that the level's fields are
  // read from the parameter space and not from a local copy
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= p.levels) break;
    const int H = p.h[l], W = p.w[l], C = p.c[l];
    const Corners k = corners(u * (float)H, v * (float)W, H, W);
    const T* base = p.f[l] + (size_t)b * H * W * C;
    if (p.pairs[l]) {
      for (int c2 = lane; c2 < C / 2; c2 += 32) {
        float ax = 0.0f, ay = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!k.valid[q]) continue;
          const float2 f = load2(base + (size_t)k.idx[q] * C + 2 * c2);
          ax += k.wt[q] * f.x;
          ay += k.wt[q] * f.y;
        }
        store2(orow + off + 2 * c2, ax, ay);
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        float a = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!k.valid[q]) continue;
          a += k.wt[q] * load1(base + (size_t)k.idx[q] * C + c);
        }
        store1(orow + off + c, a);
      }
    }
    off += C;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gather_bwd_kernel(const float* __restrict__ hw01, Pyramid<T> p, const T* __restrict__ g,
                  float* __restrict__ df, float* __restrict__ dhw01, int accumulate, int N,
                  int total) {
  const int point = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (point >= total) return;
  const int b = point / N;
  const bool coords = dhw01 != nullptr;
  const float u = hw01[2 * (size_t)point], v = hw01[2 * (size_t)point + 1];
  const T* grow = g + (size_t)point * p.ctot + p.col;
  // every lane holds the point's sums (the shuffles below leave each
  // lane the warp's total), continued from an earlier group's
  float dh = 0.0f, dw = 0.0f;
  if (coords && accumulate) {
    dh = dhw01[2 * (size_t)point];
    dw = dhw01[2 * (size_t)point + 1];
  }
  int off = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= p.levels) break;
    const int H = p.h[l], W = p.w[l], C = p.c[l];
    const Corners k = corners(u * (float)H, v * (float)W, H, W);
    const size_t plane = (size_t)b * H * W * C;
    float* dbase = df + p.dfoff[l] + plane;
    const T* fbase = p.f[l] + plane;
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // g . F at each corner
    if (p.pairs[l]) {
      for (int c2 = lane; c2 < C / 2; c2 += 32) {
        const float2 gv = load2(grow + off + 2 * c2);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!k.valid[q]) continue;
          const size_t at = (size_t)k.idx[q] * C + 2 * c2;
          atomicAdd(dbase + at, k.wt[q] * gv.x);
          atomicAdd(dbase + at + 1, k.wt[q] * gv.y);
          if (coords) {
            const float2 f = load2(fbase + at);
            dot[q] += gv.x * f.x + gv.y * f.y;
          }
        }
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        const float gv = load1(grow + off + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!k.valid[q]) continue;
          const size_t at = (size_t)k.idx[q] * C + c;
          atomicAdd(dbase + at, k.wt[q] * gv);
          if (coords) dot[q] += gv * load1(fbase + at);
        }
      }
    }
    if (coords) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        for (int s = 16; s > 0; s /= 2) dot[q] += __shfl_xor_sync(0xffffffffu, dot[q], s);
      }
      // d w_k / d ch = -+(1 - fw or fw); d w_k / d cw = -+(1 - fh or fh);
      // in-image corners only (the floor's gradient is zero)
      float dch = 0.0f, dcw = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!k.valid[q]) continue;
        const float wh = (q >> 1) ? k.fh : 1.0f - k.fh;
        const float ww = (q & 1) ? k.fw : 1.0f - k.fw;
        dch += ((q >> 1) ? ww : -ww) * dot[q];
        dcw += ((q & 1) ? wh : -wh) * dot[q];
      }
      dh += (float)H * dch;
      dw += (float)W * dcw;
    }
    off += C;
  }
  if (coords && lane == 0) {
    dhw01[2 * (size_t)point] = dh;
    dhw01[2 * (size_t)point + 1] = dw;
  }
}

// whether a pointer lies on a boundary of two elements of T
template <typename T>
bool pair_aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (2 * sizeof(T)) == 0;
}

// ``row`` is out (the forward) or g (the backward): a level's pairs need
// it, the level and the level's first column aligned on a pair, and C and
// the row length even
template <typename T>
Pyramid<T> make_pyramid(const void* const* fs, const void* row, int B, int L, int col, int ctot,
                        const int* hwc) {
  Pyramid<T> p;
  long long dfoff = 0;
  int off = col;
  p.levels = L;
  p.col = col;
  p.ctot = ctot;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.f[l] = (const T*)fs[l];
    p.h[l] = hwc[3 * l];
    p.w[l] = hwc[3 * l + 1];
    p.c[l] = hwc[3 * l + 2];
    p.dfoff[l] = dfoff;
    p.pairs[l] = false;
    if (l < L) {
      p.pairs[l] = p.c[l] % 2 == 0 && ctot % 2 == 0 && off % 2 == 0 && pair_aligned<T>(fs[l])
                   && pair_aligned<T>(row);
      off += p.c[l];
      dfoff += (long long)B * p.h[l] * p.w[l] * p.c[l];
    }
  }
  return p;
}

bool shapes_ok(int dtype, int B, int N, int L, int col, int ctot, const int* hwc) {
  if ((dtype != kBF16 && dtype != kF32) || B < 1 || N < 1 || L < 1 || L > kMaxLevels
      || col < 0) {
    return false;
  }
  int sum = 0;
  for (int l = 0; l < L; ++l) {
    if (hwc[3 * l] < 1 || hwc[3 * l + 1] < 1 || hwc[3 * l + 2] < 1) return false;
    sum += hwc[3 * l + 2];
  }
  return col + sum <= ctot;
}

template <typename T>
void launch_fwd(const void* hw01, const void* const* fs, void* out, int B, int N, int L, int col,
                int ctot, const int* hwc, cudaStream_t stream) {
  const Pyramid<T> p = make_pyramid<T>(fs, out, B, L, col, ctot, hwc);
  const int total = B * N;
  gather_kernel<T><<<(total + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      (const float*)hw01, p, (T*)out, N, total);
}

template <typename T>
void launch_bwd(const void* hw01, const void* const* fs, const void* g, void* df, void* dhw01,
                int accumulate, int B, int N, int L, int col, int ctot, const int* hwc,
                cudaStream_t stream) {
  const Pyramid<T> p = make_pyramid<T>(fs, g, B, L, col, ctot, hwc);
  const int total = B * N;
  gather_bwd_kernel<T><<<(total + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      (const float*)hw01, p, (const T*)g, (float*)df, (float*)dhw01, accumulate, N, total);
}

}  // namespace

// hw01 [B, N, 2] fp32; f0..f3 up to four levels [B, H_l, W_l, C_l] (null
// past L), of the element type ``dtype`` (0 bf16, 1 fp32); out [B, N, ctot]
// of that type, whose columns col .. col + sum C_l this launch writes.
extern "C" int gather_launch(const void* hw01, const void* f0, const void* f1, const void* f2,
                             const void* f3, void* out, int dtype, int B, int N, int L, int col,
                             int ctot, int h0, int w0, int c0, int h1, int w1, int c1, int h2,
                             int w2, int c2, int h3, int w3, int c3, void* stream) {
  const int hwc[3 * kMaxLevels] = {h0, w0, c0, h1, w1, c1, h2, w2, c2, h3, w3, c3};
  if (!shapes_ok(dtype, B, N, L, col, ctot, hwc)) return (int)cudaErrorInvalidValue;
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  if (dtype == kBF16) {
    launch_fwd<bf16>(hw01, fs, out, B, N, L, col, ctot, hwc, (cudaStream_t)stream);
  } else {
    launch_fwd<float>(hw01, fs, out, B, N, L, col, ctot, hwc, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// g [B, N, ctot] of the levels' type, this launch's levels at columns col ..
// col + sum C_l; df these levels' fp32 gradients one after the other,
// zeroed by the caller; dhw01 [B, N, 2] fp32, or null for no coordinate
// gradient (then F is not read); ``accumulate`` continues each point's
// coordinate gradient from what dhw01 holds (an earlier launch's levels).
extern "C" int gather_bwd_launch(const void* hw01, const void* f0, const void* f1,
                                 const void* f2, const void* f3, const void* g, void* df,
                                 void* dhw01, int dtype, int accumulate, int B, int N, int L,
                                 int col, int ctot, int h0, int w0, int c0, int h1, int w1,
                                 int c1, int h2, int w2, int c2, int h3, int w3, int c3,
                                 void* stream) {
  const int hwc[3 * kMaxLevels] = {h0, w0, c0, h1, w1, c1, h2, w2, c2, h3, w3, c3};
  if (!shapes_ok(dtype, B, N, L, col, ctot, hwc)) return (int)cudaErrorInvalidValue;
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  if (dtype == kBF16) {
    launch_bwd<bf16>(hw01, fs, g, df, dhw01, accumulate, B, N, L, col, ctot, hwc,
                     (cudaStream_t)stream);
  } else {
    launch_bwd<float>(hw01, fs, g, df, dhw01, accumulate, B, N, L, col, ctot, hwc,
                      (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
