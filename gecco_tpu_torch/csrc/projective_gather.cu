// Projective gather: bilinear lookup of every point in every level of a
// channels-last feature pyramid, forward and backward.
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
// against 2 bytes of output and 8 bytes of corner reads, far below the
// card's ridge. Design: one warp per point, the lanes on neighbouring
// channel pairs, so each corner's C-vector (contiguous in channels-last
// order) is read by one coalesced 4-byte-per-lane load, weighed in fp32 and
// written as one bf16 row into the concatenated [B, N, sum C] output: one
// launch serves every level and the concatenation costs no copy. The
// backward adds w_k g into an fp32 buffer with atomics (many points share a
// pixel; blocks run in no order), which the wrapper zeroes and casts to
// bf16; the coordinate gradient's per-corner dot products are summed across
// the warp with shuffles, and F is read only when it is asked for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // points per block

struct Pyramid {
  const bf16* f[kMaxLevels];     // [B, H, W, C] per level
  long long dfoff[kMaxLevels];   // the level's offset in the fp32 dF buffer
  int h[kMaxLevels], w[kMaxLevels], c[kMaxLevels];
  int levels;
  int ctot;  // sum of C: the row length of out and g
};

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

__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const float* __restrict__ hw01, Pyramid p, bf16* __restrict__ out, int N,
              int total) {
  const int point = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (point >= total) return;
  const int b = point / N;
  const float u = hw01[2 * (size_t)point], v = hw01[2 * (size_t)point + 1];
  bf16* orow = out + (size_t)point * p.ctot;
  int off = 0;
  // unrolled over the fixed level bound, so that the level's fields are
  // read from the parameter space and not from a local copy
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= p.levels) break;
    const int H = p.h[l], W = p.w[l], C = p.c[l];
    const Corners k = corners(u * (float)H, v * (float)W, H, W);
    const bf16* base = p.f[l] + (size_t)b * H * W * C;
    for (int c2 = lane; c2 < C / 2; c2 += 32) {
      float ax = 0.0f, ay = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!k.valid[q]) continue;
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(base + (size_t)k.idx[q] * C + 2 * c2));
        ax += k.wt[q] * f.x;
        ay += k.wt[q] * f.y;
      }
      *reinterpret_cast<bf162*>(orow + off + 2 * c2) = __floats2bfloat162_rn(ax, ay);
    }
    off += C;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
gather_bwd_kernel(const float* __restrict__ hw01, Pyramid p, const bf16* __restrict__ g,
                  float* __restrict__ df, float* __restrict__ dhw01, int N, int total) {
  const int point = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (point >= total) return;
  const int b = point / N;
  const bool coords = dhw01 != nullptr;
  const float u = hw01[2 * (size_t)point], v = hw01[2 * (size_t)point + 1];
  const bf16* grow = g + (size_t)point * p.ctot;
  float dh = 0.0f, dw = 0.0f;
  int off = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= p.levels) break;
    const int H = p.h[l], W = p.w[l], C = p.c[l];
    const Corners k = corners(u * (float)H, v * (float)W, H, W);
    const size_t plane = (size_t)b * H * W * C;
    float* dbase = df + p.dfoff[l] + plane;
    const bf16* fbase = p.f[l] + plane;
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // g . F at each corner
    for (int c2 = lane; c2 < C / 2; c2 += 32) {
      const float2 gv = __bfloat1622float2(*reinterpret_cast<const bf162*>(grow + off + 2 * c2));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!k.valid[q]) continue;
        const size_t at = (size_t)k.idx[q] * C + 2 * c2;
        atomicAdd(dbase + at, k.wt[q] * gv.x);
        atomicAdd(dbase + at + 1, k.wt[q] * gv.y);
        if (coords) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(fbase + at));
          dot[q] += gv.x * f.x + gv.y * f.y;
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

Pyramid make_pyramid(const void* f0, const void* f1, const void* f2, const void* f3, int B,
                     int L, const int* hwc) {
  Pyramid p;
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  long long dfoff = 0;
  p.levels = L;
  p.ctot = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.f[l] = (const bf16*)fs[l];
    p.h[l] = hwc[3 * l];
    p.w[l] = hwc[3 * l + 1];
    p.c[l] = hwc[3 * l + 2];
    p.dfoff[l] = dfoff;
    if (l < L) {
      p.ctot += p.c[l];
      dfoff += (long long)B * p.h[l] * p.w[l] * p.c[l];
    }
  }
  return p;
}

bool shapes_ok(int B, int N, int L, const int* hwc) {
  if (B < 1 || N < 1 || L < 1 || L > kMaxLevels) return false;
  for (int l = 0; l < L; ++l) {
    if (hwc[3 * l] < 1 || hwc[3 * l + 1] < 1 || hwc[3 * l + 2] < 2 || hwc[3 * l + 2] % 2) {
      return false;
    }
  }
  return true;
}

}  // namespace

// hw01 [B, N, 2] fp32; f0..f3 the levels [B, H_l, W_l, C_l] bf16 (null past
// L); out [B, N, sum C_l] bf16.
extern "C" int gather_launch(const void* hw01, const void* f0, const void* f1, const void* f2,
                             const void* f3, void* out, int B, int N, int L, int h0, int w0,
                             int c0, int h1, int w1, int c1, int h2, int w2, int c2, int h3,
                             int w3, int c3, void* stream) {
  const int hwc[3 * kMaxLevels] = {h0, w0, c0, h1, w1, c1, h2, w2, c2, h3, w3, c3};
  if (!shapes_ok(B, N, L, hwc)) return (int)cudaErrorInvalidValue;
  const Pyramid p = make_pyramid(f0, f1, f2, f3, B, L, hwc);
  const int total = B * N;
  gather_kernel<<<(total + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)hw01, p, (bf16*)out, N, total);
  return (int)cudaGetLastError();
}

// g [B, N, sum C_l] bf16; df the levels' fp32 gradients one after the
// other, zeroed by the caller; dhw01 [B, N, 2] fp32, or null for no
// coordinate gradient (then F is not read).
extern "C" int gather_bwd_launch(const void* hw01, const void* f0, const void* f1,
                                 const void* f2, const void* f3, const void* g, void* df,
                                 void* dhw01, int B, int N, int L, int h0, int w0, int c0,
                                 int h1, int w1, int c1, int h2, int w2, int c2, int h3, int w3,
                                 int c3, void* stream) {
  const int hwc[3 * kMaxLevels] = {h0, w0, c0, h1, w1, c1, h2, w2, c2, h3, w3, c3};
  if (!shapes_ok(B, N, L, hwc)) return (int)cudaErrorInvalidValue;
  const Pyramid p = make_pyramid(f0, f1, f2, f3, B, L, hwc);
  const int total = B * N;
  gather_bwd_kernel<<<(total + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)hw01, p, (const bf16*)g, (float*)df, (float*)dhw01, N, total);
  return (int)cudaGetLastError();
}
