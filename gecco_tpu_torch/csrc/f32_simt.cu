// The fp32 route of the set transformer's kernels: five simple SIMT kernels
// in fp32 arithmetic (FFMA, fp32 accumulation, no tensor cores, so no TF32),
// from which ops/kernels/f32.py chains each fused function's fp32 instance
// in the order of its plain pieces.
//
// Replaces, for fp32 operands, the bodies of
// gecco_tpu/ops/pallas/induced_attention.py:_attn_kernel and :_bwd_kernel
// (rect_attention_fwd / _bwd) and of gecco_tpu/ops/pallas/folded_attention.py
// and hside.py's fused kernels (folded_pool_ext and its backward,
// folded_pool_layer and its backward, fused_h_side, folded_unpool and its
// backward, fused_mlp_residual and its backward, fused_unpool_mlp). The
// Pallas kernels are dtype-generic; the bf16 instances here are the Hopper
// and WMMA bodies, which take only bf16 operands.
//
// - gemm_kernel: out = epi(alpha * A @ B) over up to two batch dimensions,
//   every operand read and written through its own four strides (batch 1,
//   batch 2, row, column), so a transpose, a head split or a broadcast is a
//   view and no copy. Epilogue: + bias, then act 1 (exp(-v^2 / 2), the
//   Gaussian activation) or act 2 (r exp(-v^2 / 2) (-v), its derivative
//   times the operand r) or + r (a residual), then + out where
//   ``accumulate``. A 64 x 64 output tile a block of 256 threads, 4 x 4 a
//   thread, K in steps of 16 through shared memory. A long K with no
//   epilogue splits into ``splits`` ranges, each writing its own partial;
//   the wrapper sums the partials in order with reduce_kernel.
// - softmax_kernel: softmax along one axis of a [Z, L, I] view, one thread
//   a (z, i) line: its max and sum, p = exp(x - max) / sum, the statistics
//   (or max + log sum) written beside; or p = exp(x - m) / l from given
//   statistics (l absent: 1). Where the lines are rows (I 1, unit stride
//   along l: the attentions' softmax over keys or a head's inducers),
//   softmax_rows_kernel takes a warp a row, its lanes on every 32nd
//   element, the max and sum reduced across the warp by a butterfly
//   (every lane ends with the same bits).
// - softmax_bwd_kernel: ds = p (dp - t) along the same axis, t given per
//   line or sum_l p dp (softmax_bwd_rows_kernel for rows, as above).
// - reduce_kernel: out[z, i] = sum over a range of l of x, x y, x^2 or
//   x (y - mu), one thread a (z, i) column, the ranges' partials written
//   apart for a second, in-order pass.
// - affine_kernel: out = (x - mu) xs + y ys + bs over [Z, R, C], the
//   per-(z, c) vectors optional.
//
// Every sum runs in a fixed order (no atomics), a thread's long sums in
// runs of kRun terms: the same inputs give the same bits on every call. Bound on the H100: the products are bound by
// operations (67 TFLOP/s of fp32 FFMA at 700 W), the rest by bytes.
#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64, kTN = 64, kTK = 16;
// a long sum runs in two levels: runs of kRun terms, the runs' totals
// summed in order, so a chain of L terms rounds like one of kRun + L / kRun
// (a softmax's column sums over 2048 points, summed in one chain, left the
// bias gradients several times farther from exact than PyTorch's sums)
constexpr int kRun = 64;

using i64 = long long;

struct View {
  i64 s1, s2, r, c;  // strides of batch 1, batch 2, row, column
  __device__ __forceinline__ i64 at(int z1, int z2, int row, int col) const {
    return z1 * s1 + z2 * s2 + row * r + col * c;
  }
};

struct GemmArgs {
  const float* a;
  const float* b;
  float* out;
  const float* bias;
  const float* res;
  View va, vb, vo, vbias, vres;
  int z2, m, n, k, kc, splits;
  i64 split_stride;
  int act, accumulate;
  float alpha;
};

__global__ void __launch_bounds__(kThreads) gemm_kernel(const GemmArgs p) {
  __shared__ float as[kTK][kTM + 1];
  __shared__ float bs[kTK][kTN + 1];
  const int split = blockIdx.z % p.splits;
  const int z = blockIdx.z / p.splits;
  const int z1 = z / p.z2, z2 = z % p.z2;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int k_lo = split * p.kc;
  const int k_hi = min(p.k, k_lo + p.kc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* a = p.a + p.va.at(z1, z2, 0, 0);
  const float* b = p.b + p.vb.at(z1, z2, 0, 0);
  // the load order follows the operand's unit stride, so a warp's loads coalesce
  const bool a_k_fast = p.va.c == 1;
  const bool b_n_fast = p.vb.c == 1;
  float acc[4][4] = {}, run[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kTK) {
    for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
      const int mm = a_k_fast ? e / kTK : e % kTM;
      const int kk = a_k_fast ? e % kTK : e / kTM;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < p.m && gk < k_hi) ? a[gm * p.va.r + gk * p.va.c] : 0.f;
    }
    for (int e = threadIdx.x; e < kTN * kTK; e += kThreads) {
      const int nn = b_n_fast ? e % kTN : e / kTK;
      const int kk = b_n_fast ? e / kTN : e % kTK;
      const int gn = n0 + nn, gk = k0 + kk;
      bs[kk][nn] = (gn < p.n && gk < k_hi) ? b[gk * p.vb.r + gn * p.vb.c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        av[t] = as[kk][ty + 16 * t];
        bv[t] = bs[kk][tx + 16 * t];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) run[i][j] = fmaf(av[i], bv[j], run[i][j]);
    }
    __syncthreads();
    if ((k0 - k_lo + kTK) % kRun == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += run[i][j];
          run[i][j] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += run[i][j];
  float* out = p.out + split * p.split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= p.n) continue;
      float v = p.alpha * acc[i][j];
      if (p.bias) v += p.bias[p.vbias.at(z1, z2, gm, gn)];
      if (p.act == 1) {
        v = expf(-0.5f * v * v);
      } else if (p.act == 2) {
        v = p.res[p.vres.at(z1, z2, gm, gn)] * expf(-0.5f * v * v) * (-v);
      } else if (p.res) {
        v += p.res[p.vres.at(z1, z2, gm, gn)];
      }
      const i64 o = p.vo.at(z1, z2, gm, gn);
      out[o] = p.accumulate ? out[o] + v : v;
    }
  }
}

// a [Z, L, I] view: line (z, i) runs along l
struct Lines {
  i64 z, l, i;
  __device__ __forceinline__ i64 at(int zz, int ii) const { return zz * z + ii * i; }
};

// a thread's sum along a line in runs of kRun
struct RunSum {
  float total = 0.f, run = 0.f;
  int count = 0;
  __device__ __forceinline__ void add(float v) {
    run += v;
    if (++count == kRun) {
      total += run;
      run = 0.f;
      count = 0;
    }
  }
  __device__ __forceinline__ float value() const { return total + run; }
};

__global__ void __launch_bounds__(kThreads)
softmax_kernel(const float* x, float* p, float* m, float* l, Lines vx, Lines vp, int nz, int len,
               int inner, int given, int lse) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nz * inner) return;
  const int zz = t / inner, ii = t % inner;
  const float* xs = x + vx.at(zz, ii);
  float mx, sum;
  if (given) {
    mx = m[t];
    sum = l ? l[t] : 1.f;
  } else {
    mx = -INFINITY;
    for (int j = 0; j < len; ++j) mx = fmaxf(mx, xs[j * vx.l]);
    RunSum acc;
    for (int j = 0; j < len; ++j) acc.add(expf(xs[j * vx.l] - mx));
    sum = acc.value();
  }
  if (p) {
    float* ps = p + vp.at(zz, ii);
    for (int j = 0; j < len; ++j) ps[j * vp.l] = expf(xs[j * vx.l] - mx) / sum;
  }
  if (!given && m) {
    if (lse) {
      m[t] = mx + logf(sum);
    } else {
      m[t] = mx;
      if (l) l[t] = sum;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// softmax_kernel's rows (I 1, unit stride along l): a warp a row
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const float* x, float* p, float* m, float* l, i64 xz, i64 pz, int nz,
                    int len, int given, int lse) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nz) return;  // the whole warp
  const float* xs = x + row * xz;
  float mx, sum;
  if (given) {
    mx = m[row];
    sum = l ? l[row] : 1.f;
  } else {
    mx = -INFINITY;
    for (int j = lane; j < len; j += 32) mx = fmaxf(mx, xs[j]);
    mx = warp_max(mx);
    sum = 0.f;
    for (int j = lane; j < len; j += 32) sum += expf(xs[j] - mx);
    sum = warp_sum(sum);
  }
  if (p) {
    float* ps = p + row * pz;
    for (int j = lane; j < len; j += 32) ps[j] = expf(xs[j] - mx) / sum;
  }
  if (!given && m && lane == 0) {
    if (lse) {
      m[row] = mx + logf(sum);
    } else {
      m[row] = mx;
      if (l) l[row] = sum;
    }
  }
}

// softmax_bwd_kernel's rows: a warp a row
__global__ void __launch_bounds__(kThreads)
softmax_bwd_rows_kernel(const float* p, const float* dp, float* ds, const float* tl, i64 pz,
                        i64 dz, i64 sz, int nz, int len) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nz) return;
  const float* ps = p + row * pz;
  const float* dps = dp + row * dz;
  float s;
  if (tl) {
    s = tl[row];
  } else {
    s = 0.f;
    for (int j = lane; j < len; j += 32) s += dps[j] * ps[j];
    s = warp_sum(s);
  }
  float* out = ds + row * sz;
  for (int j = lane; j < len; j += 32) out[j] = ps[j] * (dps[j] - s);
}

__global__ void __launch_bounds__(kThreads)
softmax_bwd_kernel(const float* p, const float* dp, float* ds, const float* tl, Lines vp,
                   Lines vdp, Lines vds, int nz, int len, int inner) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nz * inner) return;
  const int zz = t / inner, ii = t % inner;
  const float* ps = p + vp.at(zz, ii);
  const float* dps = dp + vdp.at(zz, ii);
  float s;
  if (tl) {
    s = tl[t];
  } else {
    RunSum acc;
    for (int j = 0; j < len; ++j) acc.add(dps[j * vdp.l] * ps[j * vp.l]);
    s = acc.value();
  }
  float* out = ds + vds.at(zz, ii);
  for (int j = 0; j < len; ++j) out[j * vds.l] = ps[j * vp.l] * (dps[j * vdp.l] - s);
}

// reduce_kernel's modes
constexpr int kSum = 0, kDot = 1, kSquare = 2, kCentred = 3;

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* x, const float* y, const float* mu, float* out, Lines vx, Lines vy,
              int nz, int len, int inner, int chunk, int mode) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nz * inner) return;
  const int zz = t / inner, ii = t % inner;
  const int lo = blockIdx.y * chunk, hi = min(len, lo + chunk);
  const float* xs = x + vx.at(zz, ii);
  const float* ys = y ? y + vy.at(zz, ii) : nullptr;
  const float centre = mode == kCentred ? mu[t] : 0.f;
  RunSum acc;
  for (int j = lo; j < hi; ++j) {
    float v = xs[j * vx.l];
    if (mode == kDot) v *= ys[j * vy.l];
    if (mode == kSquare) v *= v;
    if (mode == kCentred) v *= ys[j * vy.l] - centre;
    acc.add(v);
  }
  out[(i64)blockIdx.y * nz * inner + t] = acc.value();
}

__global__ void __launch_bounds__(kThreads)
affine_kernel(const float* x, const float* mu, const float* xs, const float* y, const float* ys,
              const float* bs, float* out, i64 total, int rows, int cols, int vz) {
  const i64 t = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const i64 zz = t / ((i64)rows * cols);
  const i64 v = zz * vz + t % cols;
  float r = x[t];
  if (mu) r -= mu[v];
  if (xs) r *= xs[v];
  if (y) r += ys ? y[t] * ys[v] : y[t];
  if (bs) r += bs[v];
  out[t] = r;
}

int blocks(i64 threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

// Strides in elements; alpha passed as the bits of an fp32. The C functions
// return the launch's cudaGetLastError().
extern "C" int f32_gemm_launch(const float* a, const float* b, float* out, const float* bias,
                               const float* res, int z1, int z2, int m, int n, int k,
                               int a1, int a2, int ar, int ac, int b1, int b2, int br, int bc,
                               int o1, int o2, int orow, int ocol, int bias1, int bias2,
                               int biasr, int biasc, int r1, int r2, int rr, int rc, int act,
                               int accumulate, int alpha_bits, int splits, int kc,
                               int split_stride, void* stream) {
  if (z1 < 1 || z2 < 1 || m < 1 || n < 1 || k < 1 || splits < 1 || kc < 1) {
    return (int)cudaErrorInvalidValue;
  }
  GemmArgs p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.bias = bias;
  p.res = res;
  p.va = View{a1, a2, ar, ac};
  p.vb = View{b1, b2, br, bc};
  p.vo = View{o1, o2, orow, ocol};
  p.vbias = View{bias1, bias2, biasr, biasc};
  p.vres = View{r1, r2, rr, rc};
  p.z2 = z2;
  p.m = m;
  p.n = n;
  p.k = k;
  p.kc = kc;
  p.splits = splits;
  p.split_stride = split_stride;
  p.act = act;
  p.accumulate = accumulate;
  std::memcpy(&p.alpha, &alpha_bits, sizeof(float));
  dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM, z1 * z2 * splits);
  gemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// softmax along l of x [Z, L, I] (strides xz, xl, xi) into p (pz, pl, pi;
// null: no p), the statistics [Z, I] contiguous: computed (m, l; ``lse``: m
// takes max + log sum) or, where ``given``, read (l null: 1)
extern "C" int f32_softmax_launch(const float* x, float* p, float* m, float* l, int nz, int len,
                                  int inner, int xz, int xl, int xi, int pz, int pl, int pi,
                                  int given, int lse, void* stream) {
  if (nz < 1 || len < 1 || inner < 1 || (given && !m)) return (int)cudaErrorInvalidValue;
  if (inner == 1 && xl == 1 && (!p || pl == 1)) {
    softmax_rows_kernel<<<blocks((i64)nz * 32), kThreads, 0, (cudaStream_t)stream>>>(
        x, p, m, l, xz, pz, nz, len, given, lse);
  } else {
    softmax_kernel<<<blocks((i64)nz * inner), kThreads, 0, (cudaStream_t)stream>>>(
        x, p, m, l, Lines{xz, xl, xi}, Lines{pz, pl, pi}, nz, len, inner, given, lse);
  }
  return (int)cudaGetLastError();
}

// ds = p (dp - t) along l, t [Z, I] given (null: sum_l p dp)
extern "C" int f32_softmax_bwd_launch(const float* p, const float* dp, float* ds, const float* t,
                                      int nz, int len, int inner, int pz, int pl, int pi, int dz,
                                      int dl, int di, int sz, int sl, int si, void* stream) {
  if (nz < 1 || len < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  if (inner == 1 && pl == 1 && dl == 1 && sl == 1) {
    softmax_bwd_rows_kernel<<<blocks((i64)nz * 32), kThreads, 0, (cudaStream_t)stream>>>(
        p, dp, ds, t, pz, dz, sz, nz, len);
  } else {
    softmax_bwd_kernel<<<blocks((i64)nz * inner), kThreads, 0, (cudaStream_t)stream>>>(
        p, dp, ds, t, Lines{pz, pl, pi}, Lines{dz, dl, di}, Lines{sz, sl, si}, nz, len, inner);
  }
  return (int)cudaGetLastError();
}

// out[s, z, i] = the sum over l in [s chunk, (s + 1) chunk) of x, x y, x^2
// or x (y - mu[z, i]) (mode 0 to 3), one partial a range s
extern "C" int f32_reduce_launch(const float* x, const float* y, const float* mu, float* out,
                                 int nz, int len, int inner, int xz, int xl, int xi, int yz,
                                 int yl, int yi, int chunk, int mode, void* stream) {
  if (nz < 1 || len < 1 || inner < 1 || chunk < 1 || mode < kSum || mode > kCentred ||
      (mode != kSum && mode != kSquare && !y) || (mode == kCentred && !mu)) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(blocks((i64)nz * inner), (len + chunk - 1) / chunk);
  reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, mu, out, Lines{xz, xl, xi}, Lines{yz, yl, yi}, nz, len, inner, chunk, mode);
  return (int)cudaGetLastError();
}

// out = (x - mu) xs + y ys + bs over contiguous [Z, R, C], the vectors
// [Z, C] (vz = C) or [C] (vz = 0), each optional
extern "C" int f32_affine_launch(const float* x, const float* mu, const float* xs, const float* y,
                                 const float* ys, const float* bs, float* out, int nz, int rows,
                                 int cols, int vz, void* stream) {
  if (nz < 1 || rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const i64 total = (i64)nz * rows * cols;
  affine_kernel<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(x, mu, xs, y, ys, bs, out,
                                                                     total, rows, cols, vz);
  return (int)cudaGetLastError();
}
