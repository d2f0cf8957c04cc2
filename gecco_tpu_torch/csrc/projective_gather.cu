// Projective gather, the Hopper bodies: bilinear lookup of every point in
// every level of a channels-last feature pyramid, forward and backward.
//
// Replaces gecco_tpu/ops/pallas/projective_gather.py:_gather_kernel (the
// forward, served by projective_gather) and :_gather_bwd_kernel (the
// backward, served by projective_gather_bwd). For point n of batch element b
// and level l of size H x W x C, the pixel coordinate is (ch, cw) =
// hw01[b, n] * (H, W) with no half-pixel offset; the corners are floor and
// floor + 1, and a corner outside the image contributes zero:
//   out[b, n, off_l + c] = sum_corners w_k F_l[b, h_k, w_k, c]
//   dF_l[b, h, w, c] = sum over the points with a corner at (h, w) of w_k g[b, n, off_l + c]
//   dhw01[b, n] = sum_l (H dch_l, W dcw_l), dch_l = sum_k dw_k/dch (g . F_l[corner k])
// The TPU kernels wrote the lookup as a product with a one-hot [TN, H*W]
// weight matrix (TPUs gather badly) and the backward as that product's
// transpose, summed across the sequential grid. Here the forward reads each
// corner directly, and the backward's scatter is turned into a gather, so
// that it needs neither atomics nor an fp32 buffer and gives the same bits
// on every call.
//
// Bound on the H100: bytes (about 8 operations per channel and point against
// 2 bytes of output and the corners' reads). Both bodies move 16 bytes (8
// channels) a thread per access, and a point's row of sum C channels is a run
// of 16-byte chunks (84 at the conditional model's C 96, 192, 384).
//
// Forward (gather_fwd_kernel): a block of 32 consecutive points (one batch
// element at N % 32 == 0, so their corners share L2) first forms every
// point's corners per level in shared memory, exactly as corners() does; its
// 256 threads then walk the block's 32 x (sum C / 8) output chunks in order,
// so that consecutive threads write consecutive 16 bytes of the block's
// contiguous output rows and no lane idles at any C. A chunk starts its four
// corner loads before its sums; the sums are fmaf over the valid corners in
// the order q = 0..3 from 0, rounded to bf16 once: the arithmetic of
// projective_gather_simt.cu's gather_kernel, so the output is the same bits.
//
// Backward, dF in two launches:
// 1. gather_bin_kernel, one block per (level, batch element): a stable
//    counting sort (CUB's block radix sort, which keeps the point order
//    among equal keys) of the N points by their floor cell (h0, w0) in
//    [-1, H-1] x [-1, W-1]; a point outside that range has no corner in the
//    image and sorts past the last cell. It writes the sorted point indices,
//    their coordinates, each cell's first position (a binary search of the
//    sorted keys) and, in pixel order, the list of crowded pixels (more than
//    kLight contributions), into scratch the wrapper allocates.
// 2. gather_pixel_kernel: pixel (h, w) is a corner of the points of cells
//    (h-1..h, w-1..w), whose sorted lists are two contiguous runs (cells
//    (h-1, w-1), (h-1, w) and (h, w-1), (h, w) are neighbours in the sort).
//    Each pixel sums w * g over its runs in their fixed order (the weight
//    formed exactly as corners() forms it) in fp32 and writes its bf16 row
//    once, zero where no point lands. Every thread owns 16 bytes of
//    channels of one pixel (consecutive threads on consecutive chunks and
//    pixels, so rows go out whole) and sums its pixel's runs alone, eight
//    loads in flight, with no barrier: the sparse levels' pixels hold a few
//    points, so the pass is a stream of short independent chains. A crowded
//    pixel (hundreds of points on an object's silhouette share one at 16^2)
//    would hold its threads for hundreds of steps and set the pace; so its
//    threads leave it, and the launch's first blocks (started first) take
//    the crowded lists in turn, each pixel by a whole block: its list
//    staged in shared memory, each of the G = 512 / (C / 8) thread groups a
//    fixed contiguous slice, the G partial sums added in group order.
// Every sum's order is fixed by the data, never by scheduling, and nothing
// is added atomically: the result is the same bits on every call.
// The coordinate gradient (gather_coord_kernel, only when asked for): one
// warp per point reads F at its corners as the forward does and sums g . F
// per corner across lanes with shuffles in a fixed order.
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kMaxLevels = 4;
constexpr int kChunk = 8;  // channels of one 16-byte access
constexpr int kFwdPoints = 32;
constexpr int kFwdThreads = 256;
constexpr int kBinThreads = 1024;
constexpr int kBinItems = 4;  // the bin pass holds N <= 4096 points
constexpr int kMaxPoints = kBinThreads * kBinItems;
constexpr int kPixThreads = 512;
constexpr int kPixBlocks = 2;  // resident blocks of the pixel pass a SM (registers)
constexpr int kPixUnroll = 8;  // loads in flight of a thread of the pixel pass
// the most contributions a pixel's own threads sum; a pixel with more is
// crowded. Uniform coordinates time alike from 32 up; on the conditional
// model's own, 64 was the fastest of 16-128, and with no crowded pixels at
// all (4096) the pass took ~45% longer (probes/gather.py's sweep).
constexpr int kLight = 64;
constexpr int kStage = 1024;  // a crowded pixel's contributions staged at a time
constexpr int kCrowdBlocks = 8;  // blocks of the crowded role per (level, batch element)
constexpr int kCoordWarps = 8;

struct Pyramid {
  const bf16* f[kMaxLevels];  // [B, H, W, C] per level
  bf16* df[kMaxLevels];       // the levels' gradients, [B, H, W, C] bf16
  long long offs[kMaxLevels];  // the level's first cell offset in the offsets scratch
  long long px[kMaxLevels];    // the level's first entry in the crowded-pixel lists
  int h[kMaxLevels], w[kMaxLevels], c[kMaxLevels];
  int kc[kMaxLevels];      // the level's first 16-byte chunk in a row of out and g
  int items[kMaxLevels];   // the pixel pass's first item (pixel and chunk) of the level
  int nitems[kMaxLevels];  // its items: B H W C / 8
  int levels, batch;
  int ctot;  // sum of C: the row length of out and g
};

// one level's fields, selected without indexing the parameter space at run
// time (which would copy the struct to local memory)
struct Level {
  const bf16* f;
  bf16* df;
  long long offs, px;
  int h, w, c, kc;
};

__device__ __forceinline__ Level level_of(const Pyramid& p, int l) {
  Level v{p.f[0], p.df[0], p.offs[0], p.px[0], p.h[0], p.w[0], p.c[0], p.kc[0]};
#pragma unroll
  for (int q = 1; q < kMaxLevels; ++q) {
    if (q == l) v = Level{p.f[q], p.df[q], p.offs[q], p.px[q], p.h[q], p.w[q], p.c[q], p.kc[q]};
  }
  return v;
}

// Corners (h0, w0), (h0, w0 + 1), (h0 + 1, w0), (h0 + 1, w0 + 1) of one
// point on one level: the flattened index h * W + w (0 outside), whether
// the corner lies in the image, and its bilinear weight (0 outside).
// projective_gather_simt.cu's, unchanged.
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

// the floor cell of a point on one level, as corners() clamps it: (h0 + 1)
// (W + 1) + w0 + 1 for (h0, w0) in [-1, H-1] x [-1, W-1], else ncell (no
// corner in the image)
__device__ __forceinline__ int cell_of(float2 uv, int H, int W) {
  const int h0 = (int)fminf(fmaxf(floorf(uv.x * (float)H), -2.0f), (float)(H + 1));
  const int w0 = (int)fminf(fmaxf(floorf(uv.y * (float)W), -2.0f), (float)(W + 1));
  const bool in = h0 >= -1 && h0 < H && w0 >= -1 && w0 < W;
  return in ? (h0 + 1) * (W + 1) + w0 + 1 : (H + 1) * (W + 1);
}

// the weight of a point at pixel (h, w), one of its corners: corners()'s
// wh * ww for q = 2 (h - h0) + (w - w0)
__device__ __forceinline__ float weight_at(float2 uv, int H, int W, int h, int w) {
  const float ch = uv.x * (float)H, cw = uv.y * (float)W;
  const float h0 = floorf(ch), w0 = floorf(cw);
  const float fh = ch - h0, fw = cw - w0;
  const float wh = (h != (int)h0) ? fh : 1.0f - fh;
  const float ww = (w != (int)w0) ? fw : 1.0f - fw;
  return wh * ww;
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& v, float x[8]) {
  const bf162* h = reinterpret_cast<const bf162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    x[2 * e] = t.x;
    x[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float a[8]) {
  uint4 v;
  bf162* h = reinterpret_cast<bf162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
  return v;
}

// ------------------------------------------------------------- forward --

__global__ void __launch_bounds__(kFwdThreads)
gather_fwd_kernel(const float* __restrict__ hw01, Pyramid p, bf16* __restrict__ out, int N,
                  int total) {
  __shared__ int s_pix[kFwdPoints * kMaxLevels * 4];  // b H W + h W + w, or -1 outside
  __shared__ float s_wt[kFwdPoints * kMaxLevels * 4];
  const int p0 = blockIdx.x * kFwdPoints;
  const int np = min(kFwdPoints, total - p0);
  for (int t = threadIdx.x; t < np * p.levels; t += kFwdThreads) {
    const int i = t / p.levels, l = t - (t / p.levels) * p.levels;
    const int point = p0 + i;
    const Level lv = level_of(p, l);
    const float u = hw01[2 * (size_t)point], v = hw01[2 * (size_t)point + 1];
    const Corners k = corners(u * (float)lv.h, v * (float)lv.w, lv.h, lv.w);
    const int plane = (point / N) * lv.h * lv.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_pix[(i * kMaxLevels + l) * 4 + q] = k.valid[q] ? plane + k.idx[q] : -1;
      s_wt[(i * kMaxLevels + l) * 4 + q] = k.wt[q];
    }
  }
  __syncthreads();
  const int row = p.ctot / kChunk;
  bf16* obase = out + (size_t)p0 * p.ctot;
  for (int i = threadIdx.x; i < np * row; i += kFwdThreads) {
    const int pt = i / row, k = i - (i / row) * row;
    int l = 0;
#pragma unroll
    for (int q = 1; q < kMaxLevels; ++q) {
      if (q < p.levels && k >= p.kc[q]) l = q;
    }
    const Level lv = level_of(p, l);
    const int* pix = s_pix + (pt * kMaxLevels + l) * 4;
    const float* wt = s_wt + (pt * kMaxLevels + l) * 4;
    const int c0 = (k - lv.kc) * kChunk;
    uint4 f[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[q] = pix[q] >= 0 ? ldg16(lv.f + (size_t)pix[q] * lv.c + c0) : make_uint4(0, 0, 0, 0);
    }
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (pix[q] < 0) continue;
      float x[8];
      unpack8(f[q], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt[q], x[e], acc[e]);
    }
    *reinterpret_cast<uint4*>(obase + (size_t)i * kChunk) = pack8(acc);
  }
}

// ------------------------------------------------- backward: the pixels' runs --

// the runs of pixel (h, w): cells (h-1, w-1..w) and (h, w-1..w), whose
// sorted lists are contiguous (cell (h0, w0) is key (h0 + 1)(W + 1) + w0 + 1)
struct Runs {
  int a0, na, b0, len;
  __device__ __forceinline__ int at(int j) const { return j < na ? a0 + j : b0 + j - na; }
};

__device__ __forceinline__ Runs runs_of(const int* start, int W, int h, int w) {
  const int ka = h * (W + 1) + w, kb = ka + W + 1;
  Runs r;
  r.a0 = start[ka];
  r.na = start[ka + 2] - r.a0;
  r.b0 = start[kb];
  r.len = r.na + start[kb + 2] - r.b0;
  return r;
}

// ----------------------------------------------------- backward: the bin --

using BinSort = cub::BlockRadixSort<unsigned, kBinThreads, kBinItems, int>;
using BinScan = cub::BlockScan<int, kBinThreads>;

__global__ void __launch_bounds__(kBinThreads)
gather_bin_kernel(const float2* __restrict__ hw01, Pyramid p, int* __restrict__ sidx,
                  float2* __restrict__ suv, int* offs, int* __restrict__ crowd,
                  int* __restrict__ crowd_n, int N) {
  __shared__ union {
    typename BinSort::TempStorage sort;
    typename BinScan::TempStorage scan;
    int keys[kMaxPoints];
  } s;
  const int l = blockIdx.x, b = blockIdx.y;
  const Level lv = level_of(p, l);
  const int ncell = (lv.h + 1) * (lv.w + 1);
  const float2* uv = hw01 + (size_t)b * N;
  // blocked: thread t holds points t * kBinItems + j, so that the stable
  // sort keeps the point order within a cell; padding sorts last
  unsigned key[kBinItems];
  int val[kBinItems];
#pragma unroll
  for (int j = 0; j < kBinItems; ++j) {
    const int n = threadIdx.x * kBinItems + j;
    key[j] = n < N ? cell_of(uv[n], lv.h, lv.w) : ncell;
    val[j] = n;
  }
  BinSort(s.sort).Sort(key, val, 0, 32 - __clz(ncell));
  __syncthreads();
  const size_t base = ((size_t)b * p.levels + l) * N;
#pragma unroll
  for (int j = 0; j < kBinItems; ++j) {
    const int r = threadIdx.x * kBinItems + j;
    s.keys[r] = (int)key[j];
    if (r < N && (int)key[j] < ncell) {
      sidx[base + r] = val[j];
      suv[base + r] = uv[val[j]];
    }
  }
  __syncthreads();
  // each cell's first position: the first sorted key >= the cell
  int* start = offs + lv.offs + (size_t)b * (ncell + 1);
  for (int c = threadIdx.x; c <= ncell; c += kBinThreads) {
    int lo = 0, hi = kMaxPoints;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (s.keys[mid] < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    start[c] = lo;
  }
  __syncthreads();  // start is written; the keys are no longer read
  // the crowded pixels (more than kLight contributions), in pixel order
  const int hw = lv.h * lv.w;
  int* list = crowd + lv.px + (size_t)b * hw;
  int total = 0;
  for (int p0 = 0; p0 < hw; p0 += kBinThreads) {
    const int px = p0 + threadIdx.x;
    const int flag = px < hw && runs_of(start, lv.w, px / lv.w, px % lv.w).len > kLight;
    int at, count;
    BinScan(s.scan).ExclusiveSum(flag, at, count);
    if (flag) list[total + at] = px;
    total += count;
    __syncthreads();  // the scan's storage is reused
  }
  if (threadIdx.x == 0) crowd_n[b * p.levels + l] = total;
}

// ---------------------------------------------------- backward: the pixels --

// acc += sum over staged entries [lo, hi) of w * g[n, chunk], in order; the
// loads of up to eight entries in flight at once
__device__ __forceinline__ void sum_staged(const int* s_n, const float* s_w, int lo, int hi,
                                           const bf16* gcol, int ctot, float acc[8]) {
  constexpr int kUnroll = 8;
  for (int j = lo; j < hi; j += kUnroll) {
    uint4 gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gv[u] = j + u < hi ? ldg16(gcol + (size_t)s_n[j + u] * ctot) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u >= hi) break;
      float x[8];
      unpack8(gv[u], x);
      const float wt = s_w[j + u];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
    }
  }
}

// dynamic shared memory of gather_pixel_kernel (its crowded role)
constexpr size_t kPixSmem =
    (size_t)kStage * (sizeof(int) + sizeof(float))   // staged point indices and weights
    + (size_t)kPixThreads * kChunk * sizeof(float);  // the G groups' partial sums [G][C]

// A crowded pixel: all G = kPixThreads / (C / 8) groups of the block, each
// a fixed contiguous slice of every kStage-long segment of its list, then
// the G partial sums added in group order.
__device__ void crowded_pixel(const int* idx, const float2* uv, const int* start,
                              const bf16* g, const Level& lv, int ctot, int b, int pix,
                              int* s_n, float* s_w, float* s_red) {
  const int K = lv.c / kChunk, G = kPixThreads / K;
  const int grp = threadIdx.x / K, k = threadIdx.x - grp * K;
  const int h = pix / lv.w, w = pix - (pix / lv.w) * lv.w;
  const Runs r = runs_of(start, lv.w, h, w);
  const bf16* gcol = g + (size_t)(lv.kc + k) * kChunk;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < r.len; s0 += kStage) {
    const int sn = min(kStage, r.len - s0);
    __syncthreads();  // the staging area is free
    for (int j = threadIdx.x; j < sn; j += kPixThreads) {
      const int at = r.at(s0 + j);
      s_n[j] = idx[at];
      s_w[j] = weight_at(uv[at], lv.h, lv.w, h, w);
    }
    __syncthreads();
    if (grp < G) sum_staged(s_n, s_w, sn * grp / G, sn * (grp + 1) / G, gcol, ctot, acc);
  }
  if (grp < G) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s_red[(grp * K + k) * kChunk + e] = acc[e];
  }
  __syncthreads();
  for (int c2 = threadIdx.x; c2 < lv.c / 2; c2 += kPixThreads) {
    float2 tot = make_float2(0.0f, 0.0f);
    for (int q = 0; q < G; ++q) {
      const float2 v = reinterpret_cast<const float2*>(s_red + q * lv.c)[c2];
      tot.x += v.x;
      tot.y += v.y;
    }
    reinterpret_cast<bf162*>(lv.df + ((size_t)b * lv.h * lv.w + pix) * lv.c)[c2] =
        __floats2bfloat162_rn(tot.x, tot.y);
  }
}

// Two roles by block. The first L B kCrowdBlocks blocks take the crowded
// pixels of their (level, batch element) in turn (started first, since
// they take longest); every other thread owns one 16-byte chunk of one
// pixel's row (consecutive threads on consecutive chunks and pixels) and,
// unless the pixel is crowded, sums its runs alone, eight loads in flight.
__global__ void __launch_bounds__(kPixThreads, kPixBlocks)
gather_pixel_kernel(const int* __restrict__ sidx, const float2* __restrict__ suv,
                    const int* __restrict__ offs, const int* __restrict__ crowd,
                    const int* __restrict__ crowd_n, const bf16* __restrict__ g, Pyramid p,
                    int N, int items) {
  const int crowd_blocks = p.levels * p.batch * kCrowdBlocks;
  if ((int)blockIdx.x < crowd_blocks) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* s_red = reinterpret_cast<float*>(smem);
    float* s_w = s_red + kPixThreads * kChunk;
    int* s_n = reinterpret_cast<int*>(s_w + kStage);
    const int l = blockIdx.x / (p.batch * kCrowdBlocks);
    const int b = blockIdx.x / kCrowdBlocks - l * p.batch;
    const Level lv = level_of(p, l);
    const int ncell = (lv.h + 1) * (lv.w + 1);
    const int* start = offs + lv.offs + (size_t)b * (ncell + 1);
    const size_t list = ((size_t)b * p.levels + l) * N;
    const int* pixels = crowd + lv.px + (size_t)b * lv.h * lv.w;
    const int count = crowd_n[b * p.levels + l];
    for (int c = blockIdx.x % kCrowdBlocks; c < count; c += kCrowdBlocks) {
      crowded_pixel(sidx + list, suv + list, start, g + (size_t)b * N * p.ctot, lv, p.ctot, b,
                    pixels[c], s_n, s_w, s_red);
    }
    return;
  }
  const int item = ((int)blockIdx.x - crowd_blocks) * kPixThreads + (int)threadIdx.x;
  if (item >= items) return;
  int l = 0;
#pragma unroll
  for (int q = 1; q < kMaxLevels; ++q) {
    if (q < p.levels && item >= p.items[q]) l = q;
  }
  const Level lv = level_of(p, l);
  const int K = lv.c / kChunk, hw = lv.h * lv.w;
  const int rest = item - p.items[l];
  const int px = rest / K, k = rest - px * K;
  const int b = px / hw, pix = px - b * hw;
  const int h = pix / lv.w, w = pix - h * lv.w;
  const int ncell = (lv.h + 1) * (lv.w + 1);
  const Runs r = runs_of(offs + lv.offs + (size_t)b * (ncell + 1), lv.w, h, w);
  if (r.len > kLight) return;  // the crowded role's
  const size_t list = ((size_t)b * p.levels + l) * N;
  const int* idx = sidx + list;
  const float2* uv = suv + list;
  const bf16* gcol = g + (size_t)b * N * p.ctot + (size_t)(lv.kc + k) * kChunk;
  constexpr int kUnroll = kPixUnroll;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < r.len; j += kUnroll) {
    int n[kUnroll];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j + u < r.len;
      const int at = r.at(in ? j + u : 0);
      n[u] = in ? idx[at] : 0;
      wt[u] = in ? weight_at(uv[at], lv.h, lv.w, h, w) : 0.0f;
    }
    uint4 gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gv[u] = j + u < r.len ? ldg16(gcol + (size_t)n[u] * p.ctot) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u >= r.len) break;
      float x[8];
      unpack8(gv[u], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt[u], x[e], acc[e]);
    }
  }
  *reinterpret_cast<uint4*>(lv.df + ((size_t)b * hw + pix) * lv.c + k * kChunk) = pack8(acc);
}

// ------------------------------------------- backward: the coordinates --

__global__ void __launch_bounds__(kCoordWarps * 32)
gather_coord_kernel(const float* __restrict__ hw01, Pyramid p, const bf16* __restrict__ g,
                    float* __restrict__ dhw01, int N, int total) {
  const int point = blockIdx.x * kCoordWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (point >= total) return;
  const int b = point / N;
  const float u = hw01[2 * (size_t)point], v = hw01[2 * (size_t)point + 1];
  const bf16* grow = g + (size_t)point * p.ctot;
  float dh = 0.0f, dw = 0.0f;
  int off = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= p.levels) break;
    const int H = p.h[l], W = p.w[l], C = p.c[l];
    const Corners k = corners(u * (float)H, v * (float)W, H, W);
    const bf16* fbase = p.f[l] + (size_t)b * H * W * C;
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // g . F at each corner
    for (int c8 = lane; c8 < C / kChunk; c8 += 32) {
      uint4 fv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fv[q] = k.valid[q] ? ldg16(fbase + (size_t)k.idx[q] * C + c8 * kChunk)
                           : make_uint4(0, 0, 0, 0);
      }
      float gx[8];
      unpack8(ldg16(grow + off + c8 * kChunk), gx);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float fx[8];
        unpack8(fv[q], fx);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[q] = fmaf(gx[e], fx[e], dot[q]);
      }
    }
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
    off += C;
  }
  if (lane == 0) {
    dhw01[2 * (size_t)point] = dh;
    dhw01[2 * (size_t)point + 1] = dw;
  }
}

// ----------------------------------------------------------- launches --

bool shapes_ok(int B, int N, int L, const int* hwc) {
  if (B < 1 || N < 1 || L < 1 || L > kMaxLevels) return false;
  long long items = 0;
  for (int l = 0; l < L; ++l) {
    const int c = hwc[3 * l + 2];
    if (hwc[3 * l] < 1 || hwc[3 * l + 1] < 1 || c < kChunk || c % kChunk ||
        c > kPixThreads / 2 * kChunk) {
      return false;
    }
    items += (long long)B * hwc[3 * l] * hwc[3 * l + 1] * (c / kChunk);
  }
  return items < (1LL << 31) - (long long)L * B * kCrowdBlocks * kPixThreads;
}

bool aligned(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

Pyramid make_pyramid(const void* const* fs, void* const* dfs, int B, int L, const int* hwc) {
  Pyramid p{};
  long long offs = 0, px = 0, items = 0;
  int kc = 0;
  p.levels = L;
  p.batch = B;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.f[l] = (const bf16*)fs[l];
    p.df[l] = dfs ? (bf16*)dfs[l] : nullptr;
    p.h[l] = hwc[3 * l];
    p.w[l] = hwc[3 * l + 1];
    p.c[l] = hwc[3 * l + 2];
    p.offs[l] = offs;
    p.px[l] = px;
    p.kc[l] = kc;
    p.items[l] = (int)items;
    if (l < L) {
      offs += (long long)B * ((p.h[l] + 1) * (p.w[l] + 1) + 1);
      px += (long long)B * p.h[l] * p.w[l];
      kc += p.c[l] / kChunk;
      p.nitems[l] = (int)((long long)B * p.h[l] * p.w[l] * (p.c[l] / kChunk));
      items += p.nitems[l];
    }
  }
  p.ctot = kc * kChunk;
  return p;
}

}  // namespace

// hw01 [B, N, 2] fp32; f0..f3 the levels [B, H_l, W_l, C_l]
// bf16, 16-byte aligned, C_l % 8 == 0 (null past L); out [B, N, sum C_l] bf16.
extern "C" int gather_launch(const void* hw01, const void* f0, const void* f1, const void* f2,
                             const void* f3, void* out, int B, int N, int L, int h0, int w0,
                             int c0, int h1, int w1, int c1, int h2, int w2, int c2, int h3,
                             int w3, int c3, void* stream) {
  const int hwc[3 * kMaxLevels] = {h0, w0, c0, h1, w1, c1, h2, w2, c2, h3, w3, c3};
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  if (!shapes_ok(B, N, L, hwc) || !aligned(out)) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    if (!aligned(fs[l])) return (int)cudaErrorInvalidValue;
  }
  const Pyramid p = make_pyramid(fs, nullptr, B, L, hwc);
  const int total = B * N;
  gather_fwd_kernel<<<(total + kFwdPoints - 1) / kFwdPoints, kFwdThreads, 0,
                      (cudaStream_t)stream>>>((const float*)hw01, p, (bf16*)out, N, total);
  return (int)cudaGetLastError();
}

// hw01 8-byte aligned; g [B, N, sum C_l] bf16, 16-byte aligned; N <= 4096;
// the scratch (int32 unless named): sidx [B, L, N], suv [B, L, N, 2] fp32,
// offs sum_l B ((H_l + 1)(W_l + 1) + 1), crowd sum_l B H_l W_l, crowd_n
// [B, L]; df0..df3 the levels' gradients [B, H_l, W_l, C_l] bf16, every
// element written; dhw01 [B, N, 2] fp32, or null for no coordinate gradient
// (then F is not read).
extern "C" int gather_bwd_launch(const void* hw01, const void* f0, const void* f1,
                                 const void* f2, const void* f3, const void* g, void* sidx,
                                 void* suv, void* offs, void* crowd, void* crowd_n, void* df0,
                                 void* df1, void* df2, void* df3, void* dhw01, int B, int N,
                                 int L, int h0, int w0, int c0, int h1, int w1, int c1, int h2,
                                 int w2, int c2, int h3, int w3, int c3, void* stream) {
  const int hwc[3 * kMaxLevels] = {h0, w0, c0, h1, w1, c1, h2, w2, c2, h3, w3, c3};
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  void* dfs[kMaxLevels] = {df0, df1, df2, df3};
  if (!shapes_ok(B, N, L, hwc) || N > kMaxPoints || (uintptr_t)hw01 % 8 ||
      !aligned(g) || (uintptr_t)suv % 8) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < L; ++l) {
    if (!aligned(fs[l]) || !aligned(dfs[l])) return (int)cudaErrorInvalidValue;
  }
  const Pyramid p = make_pyramid(fs, dfs, B, L, hwc);
  cudaStream_t st = (cudaStream_t)stream;
  gather_bin_kernel<<<dim3(L, B), kBinThreads, 0, st>>>(
      (const float2*)hw01, p, (int*)sidx, (float2*)suv, (int*)offs, (int*)crowd, (int*)crowd_n,
      N);
  const int items = p.items[L - 1] + p.nitems[L - 1];
  gather_pixel_kernel<<<L * B * kCrowdBlocks + (items + kPixThreads - 1) / kPixThreads,
                        kPixThreads, kPixSmem, st>>>(
      (const int*)sidx, (const float2*)suv, (const int*)offs, (const int*)crowd,
      (const int*)crowd_n, (const bf16*)g, p, N, items);
  if (dhw01) {
    const int total = B * N;
    gather_coord_kernel<<<(total + kCoordWarps - 1) / kCoordWarps, kCoordWarps * 32, 0, st>>>(
        (const float*)hw01, p, (const bf16*)g, (float*)dhw01, N, total);
  }
  return (int)cudaGetLastError();
}
