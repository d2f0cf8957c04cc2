// Backward of the resident attention pool (folded_pool_layer): the WMMA
// body, kept for the shapes the Hopper body (pool_bwd.cu) does not take
// (a head width other than 48, H % 8 != 0: three heads' D 128 at C 384).
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_bwd_kernel, with
// its per-head algebra (no fold of Wv into the logit side). From the
// forward (pool.cu): mean_c, inv_c, the pre-normed stream y [B, N, C], the
// column max m and sum l [B, J] and the fp32 P [B, I, C]; per point tile
// p = bf16(exp(max(s - m, -80)) / l) and v = bf16(y Wv^T) are recomputed.
// Per batch element b, g = bf16(g_h0):
//   dpool = bf16(g @ Wo) [I, C];  merged = bf16(P);  dWo += g^T merged
//   t[hI+i] = sum_d dpool[i, hD+d] P[i, hD+d]   (= sum_n dp p, exactly)
//   per head h:  dp = v_h dpool_h^T [N, I];  dv_h = bf16(p_h dpool_h) [N, D]
//     ds_h = bf16(p_h (dp - t_h) [s - m > -80])  (the clamped forward's jacobian)
//     dy += ds_h qf_h^T + dv_h Wv_h
//   dqf += y^T ds;  dWv += dv^T y
// and with the pre-norm (xc = x - mean_c, w_c = inv_c scale, count = N C/G):
//   dscale = inv_c sum_n dy xc;  dbias = sum_n dy
//   dinv_c = scale sum_n dy xc + g_inv;  dmean_c = -w_c sum_n dy + g_mean
//   per group: dvar_g = -inv_g^3 / 2 sum_c dinv_c;
//              dmean_g = sum_c dmean_c - 2 mean_g dvar_g
//   dx = bf16(dy w_c + 2 x dvar_g / count + dmean_g / count)
// without it dx = bf16(dy), and scale and bias take no gradient.
//
// Bound on the H100: tensor-core operations (the six [N, C] x [C, J]-sized
// products of the gradient per batch element; the main kernel adds a
// seventh, the recompute of the logits). Design: the TPU kernel recomputed
// one batch element's whole forward in VMEM and ran the backward's gated
// reductions in order. Here the gates become launches:
//   1. fold: one block per (head, b) forms dpool_h and t_h and adds dWo's
//      block (fp32 atomics). t needs no pass over the points: sum_n dp p =
//      sum_d dpool P, from the forward's fp32 P;
//   2. main: one block per (point tile, b) walks the heads (64 points a
//      tile up to C 384, else 32, halved down to 16 where the tile's
//      [TN, I] planes would not fit; the fold's [I, D] blocks then bound I:
//      960 inducers at C 384 and D 48, 912 at C 768): the tile's logits
//      and values again, dp, dv, ds, and dy [TN, C] fp32 in
//      registers; it writes bf16(ds) [B, N, J] and bf16(dv) [B, N, C] for
//      the weight gradients; with the pre-norm the fp32 dy [B, N, C] and the
//      channel sums of dy xc and dy (fp32 atomics), without it dx;
//   3. dx (pre-norm only): each block forms the per-channel coefficients
//      from those sums (a group is a run of C/G channels), then dx of its
//      tile; the tile-0 blocks write dscale and dbias;
//   4. dqf = sum_b y^T ds and dWv^T = sum_b y^T dv: backward.cuh's
//      atb_kernel (fp32 atomics across the batch).
// A ragged N comes zero-padded to a multiple of 128 by the wrapper: p is
// zero on the points from n_valid on, so their ds, dv and dy are too, and
// count is n_valid C/G.
// The caller chains dqf to the inducers and Wk and transposes dWv^T
// (plain PyTorch on [C, J] and [C, C]).
#include <cmath>

#include "backward.cuh"

using namespace gecco;

namespace {

constexpr int kDxTile = 64;  // points per block of the dx kernel

// One block per (head h, batch element b). Shared memory: the product
// buffer, dpool_h and merged_h [I, D] bf16.
__global__ void __launch_bounds__(kThreads)
pool_layer_bwd_fold_kernel(const bf16* __restrict__ gh, const bf16* __restrict__ wo,
                           const float* __restrict__ pacc, bf16* __restrict__ dpool,
                           float* __restrict__ tacc, float* __restrict__ dwo, int C, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I, ldd = D + kPad;
  float* buf = reinterpret_cast<float*>(smem);
  bf16* dps = reinterpret_cast<bf16*>(smem + kBlockProductSmem);
  bf16* mrg = dps + (size_t)I * ldd;

  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* ghb = gh + (size_t)b * I * C;
  const float* pb = pacc + (size_t)b * I * C + h * D;
  bf16* dpb = dpool + (size_t)b * I * C + h * D;
  // dpool_h = bf16(g @ Wo[:, hD:(h+1)D])
  block_product<wmma::row_major, wmma::row_major>(
      ghb, C, wo + h * D, C, I, D, C, buf, [&](int r, int c, float v) {
        const bf16 q = __float2bfloat16(v);
        dps[r * ldd + c] = q;
        dpb[(size_t)r * C + c] = q;
      });
  // merged_h = bf16(P_h) and t_h: one warp per row
  for (int r = threadIdx.x / 32; r < I; r += kWarps) {
    float acc = 0.0f;
    for (int c = threadIdx.x % 32; c < D; c += 32) {
      const float p = pb[(size_t)r * C + c];
      acc += __bfloat162float(dps[r * ldd + c]) * p;
      mrg[r * ldd + c] = __float2bfloat16(p);
    }
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) tacc[(size_t)b * J + h * I + r] = acc;
  }
  __syncthreads();
  // dWo[:, hD:(h+1)D] += g^T merged_h
  block_product<wmma::col_major, wmma::row_major>(
      ghb, C, mrg, ldd, C, D, I, buf,
      [&](int r, int c, float v) { atomicAdd(dwo + (size_t)r * C + h * D + c, v); });
}

// Main kernel, one block per (TN-point tile, b). Shared memory: region0
// holds y [TN, C], later the fp32 dy tile; then the head's logits s and dp
// [TN, I] fp32, v and then dv [TN, D] fp32, bf16(p) and bf16(ds) [TN, I],
// bf16(v) and bf16(dv) [TN, D].
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
pool_layer_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ mean,
                      const bf16* __restrict__ yin, const bf16* __restrict__ qf,
                      const bf16* __restrict__ kvw, const float* __restrict__ macc,
                      const float* __restrict__ sacc, const float* __restrict__ tacc,
                      const bf16* __restrict__ dpool, bf16* __restrict__ ds_out,
                      bf16* __restrict__ dv_out,
                      float* __restrict__ dy_out, float* __restrict__ sdyxc,
                      float* __restrict__ sdy, bf16* __restrict__ dx, int N, int n_valid, int C,
                      int H, int I, int region0) {
  constexpr int TN = 16 * ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = C / H, J = H * I;
  const int ldy = C + kPad, ldo = C + kPadF, lds = I + kPadF, ldv = D + kPadF, ldp = I + kPad,
            ldvb = D + kPad;
  bf16* y = reinterpret_cast<bf16*>(smem);
  float* obuf = reinterpret_cast<float*>(smem);
  float* s = reinterpret_cast<float*>(smem + region0);
  float* dp = s + TN * lds;
  float* vt = dp + TN * lds;
  bf16* pb = reinterpret_cast<bf16*>(vt + TN * ldv);
  bf16* dsb = pb + TN * ldp;
  bf16* vb = dsb + TN * ldp;
  bf16* dvb = vb + TN * ldvb;

  const int b = blockIdx.y, n0 = blockIdx.x * TN;
  const size_t base = ((size_t)b * N + n0) * C, off = (size_t)b * C;
  stage(y, ldy, yin + base, C, TN, C);
  __syncthreads();
  const float* mrow = macc + (size_t)b * J;
  const float* lrow = sacc + (size_t)b * J;
  const float* trow = tacc + (size_t)b * J;
  FragC acc[ROWS][COLS];
  acc_zero(acc);
  for (int h = 0; h < H; ++h) {
    const bf16* qh = qf + h * I;                              // qf_h [C, I], row stride J
    const bf16* wv = kvw + (size_t)(C + h * D) * C;           // Wv_h [D, C]
    const bf16* dph = dpool + (size_t)b * I * C + h * D;      // dpool_h [I, D], row stride C
    const int j0 = h * I;
    gemm_to_smem<wmma::row_major, wmma::row_major>(y, ldy, qh, J, s, lds, TN, I, C);
    gemm_to_smem<wmma::row_major, wmma::col_major>(y, ldy, wv, C, vt, ldv, TN, D, C);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * I; t += kThreads) {
      const int r = t / I, i = t % I;
      const float z = s[r * lds + i] - mrow[j0 + i];
      // p, and so ds and dv, is zero on the padding rows from n_valid on
      pb[r * ldp + i] =
          __float2bfloat16(n0 + r < n_valid ? expf(fmaxf(z, -80.0f)) / lrow[j0 + i] : 0.0f);
    }
    for (int t = threadIdx.x; t < TN * D; t += kThreads) {
      vb[(t / D) * ldvb + t % D] = __float2bfloat16(vt[(t / D) * ldv + t % D]);
    }
    __syncthreads();
    // dp = bf16(v) dpool_h^T (dpool_h read as a column-major [D, I]
    // operand); dv = bf16(p) dpool_h, over v in vt
    gemm_to_smem<wmma::row_major, wmma::col_major>(vb, ldvb, dph, C, dp, lds, TN, I, D);
    gemm_to_smem<wmma::row_major, wmma::row_major>(pb, ldp, dph, C, vt, ldv, TN, D, I);
    __syncthreads();
    for (int t = threadIdx.x; t < TN * I; t += kThreads) {
      const int r = t / I, i = t % I;
      const float z = s[r * lds + i] - mrow[j0 + i];
      const float d =
          z > -80.0f ? __bfloat162float(pb[r * ldp + i]) * (dp[r * lds + i] - trow[j0 + i]) : 0.0f;
      const bf16 db = __float2bfloat16(d);
      dsb[r * ldp + i] = db;
      ds_out[((size_t)b * N + n0 + r) * J + j0 + i] = db;
    }
    for (int t = threadIdx.x; t < TN * D; t += kThreads) {
      const int r = t / D, d = t % D;
      const bf16 q = __float2bfloat16(vt[r * ldv + d]);
      dvb[r * ldvb + d] = q;
      dv_out[base + (size_t)r * C + h * D + d] = q;
    }
    __syncthreads();
    // dy += bf16(ds) qf_h^T + bf16(dv) Wv_h
    gemm_acc<ROWS, COLS, wmma::col_major>(acc, dsb, ldp, qh, J, C, I);
    gemm_acc<ROWS, COLS, wmma::row_major>(acc, dvb, ldvb, wv, C, C, D);
  }
  __syncthreads();  // obuf reuses y
  acc_store(acc, obuf, ldo, C);
  __syncthreads();
  if (dy_out == nullptr) {
    for (int t = threadIdx.x; t < TN * C; t += kThreads) {
      dx[base + t] = __float2bfloat16(obuf[(t / C) * ldo + t % C]);
    }
    return;
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float mc = mean[off + c];
    float s_xc = 0.0f, s_1 = 0.0f;
    for (int r = 0; r < TN; ++r) {
      const float d = obuf[(size_t)r * ldo + c];
      const size_t e = base + (size_t)r * C + c;
      dy_out[e] = d;
      s_xc += d * (__bfloat162float(x[e]) - mc);
      s_1 += d;
    }
    atomicAdd(sdyxc + off + c, s_xc);
    atomicAdd(sdy + off + c, s_1);
  }
}

// dx with the pre-norm, one block per (64-point tile, b); shared memory:
// the per-channel coefficients [3, C] of dx = dy a + x bx + c0.
__global__ void __launch_bounds__(kThreads)
pool_layer_bwd_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
                         const float* __restrict__ mean, const float* __restrict__ inv,
                         const float* __restrict__ scale, const float* __restrict__ gmean,
                         const float* __restrict__ ginv, const float* __restrict__ sdyxc,
                         const float* __restrict__ sdy, bf16* __restrict__ dx,
                         float* __restrict__ dscale, float* __restrict__ dbias, int N,
                         int n_valid, int C, int G) {
  extern __shared__ float coef[];
  const int b = blockIdx.y, pg = C / G;
  const float count = (float)n_valid * (float)pg;
  const size_t off = (size_t)b * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g0 = (c / pg) * pg;
    float dinv_g = 0.0f, dmean_g = 0.0f;
    for (size_t q = off + g0; q < off + g0 + pg; ++q) {
      dinv_g += sdyxc[q] * scale[q] + ginv[q];
      dmean_g += -sdy[q] * (inv[q] * scale[q]) + gmean[q];
    }
    const float inv_g = inv[off + c], mean_g = mean[off + c];
    const float dvar_g = -0.5f * inv_g * inv_g * inv_g * dinv_g;
    dmean_g -= 2.0f * mean_g * dvar_g;
    coef[c] = inv_g * scale[off + c];
    coef[C + c] = 2.0f * (dvar_g / count);
    coef[2 * C + c] = dmean_g / count;
    if (blockIdx.x == 0) {
      dscale[off + c] = sdyxc[off + c] * inv_g;
      dbias[off + c] = sdy[off + c];
    }
  }
  __syncthreads();
  const size_t base = ((size_t)b * N + (size_t)blockIdx.x * kDxTile) * C;
  for (int t = threadIdx.x; t < kDxTile * C; t += kThreads) {
    const int c = t % C;
    const size_t e = base + t;
    dx[e] = __float2bfloat16(dy[e] * coef[c] + __bfloat162float(x[e]) * coef[C + c] +
                             coef[2 * C + c]);
  }
}

// The main kernel's shared memory at a TN-point tile: region0 (the y tile,
// later the fp32 dy tile), then s and dp [TN, I] fp32, v / dv [TN, D]
// fp32, bf16 p and ds [TN, I], bf16 v and dv [TN, D]
// (folded_attention.py _pool_layer_bwd_smem: change both together).
inline size_t main_region0(int TN, int C) {
  size_t region0 = (size_t)TN * (C + kPad) * 2;
  const size_t out_tile = (size_t)TN * (C + kPadF) * 4;
  if (out_tile > region0) region0 = out_tile;
  return (region0 + 127) / 128 * 128;
}

inline size_t main_smem(int TN, int C, int I, int D) {
  return main_region0(TN, C) + (size_t)2 * TN * (I + kPadF) * 4 +
         (size_t)TN * (D + kPadF) * 4 + (size_t)2 * TN * (I + kPad) * 2 +
         (size_t)2 * TN * (D + kPad) * 2;
}

// The point tile of the main kernel: 64 points up to C 384, else 32, and
// half of that (down to 16) while the [TN, I] planes do not fit; 0 where
// none does.
inline int main_tile(int C, int I, int D) {
  for (int TN = C <= 384 ? 64 : 32; TN >= 16; TN /= 2) {
    if (main_smem(TN, C, I, D) <= kMaxSmem) return TN;
  }
  return 0;
}

}  // namespace

// y is the forward's pre-normed stream (x itself without the pre-norm).
// With the pre-norm (mean non-null): dy [B, N, C], sdyxc and sdy [B, C]
// (zeroed) are scratch and dscale/dbias are written; without, all of them
// are null and dx comes straight from the main kernel. dqf, dwvt and dwo
// are zeroed by the caller and accumulate over the batch.
extern "C" int pool_layer_bwd_wmma_launch(
    const void* x, const void* mean, const void* inv, const void* scale, const void* y,
    const void* qf, const void* kvw, const void* wo, const void* gh, const void* gmean,
    const void* ginv, const void* macc, const void* sacc, const void* pacc, void* dpool,
    void* tacc, void* ds, void* dv, void* dy, void* sdyxc, void* sdy, void* dx, void* dscale,
    void* dbias, void* dqf, void* dwvt, void* dwo, int B, int N, int C, int H, int I, int G,
    int n_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = H * I, D = C / H;
  const bool prenorm = mean != nullptr;
  if (C % 64 || C > 768 || D % 16 || I % 16 || N % 64 || J % 64 || (prenorm && C % G) ||
      n_valid < 1 || n_valid > N) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  // 1. fold
  {
    const size_t smem = kBlockProductSmem + (size_t)2 * I * (D + kPad) * 2;
    if ((err = set_smem((const void*)pool_layer_bwd_fold_kernel, smem)) != cudaSuccess) {
      return (int)err;
    }
    pool_layer_bwd_fold_kernel<<<dim3(H, B), kThreads, smem, st>>>(
        (const bf16*)gh, (const bf16*)wo, (const float*)pacc, (bf16*)dpool, (float*)tacc,
        (float*)dwo, C, H, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 2. main: the widest point tile whose block fits
  {
    const int TN = main_tile(C, I, D);
    if (TN == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = main_smem(TN, C, I, D);
    const bool narrow = C <= 384;
    const auto kernel = TN == 64   ? pool_layer_bwd_kernel<4, 3>
                        : TN == 32 ? (narrow ? pool_layer_bwd_kernel<2, 3>
                                             : pool_layer_bwd_kernel<2, 6>)
                                   : (narrow ? pool_layer_bwd_kernel<1, 3>
                                             : pool_layer_bwd_kernel<1, 6>);
    const size_t region0 = main_region0(TN, C);
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<dim3(N / TN, B), kThreads, smem, st>>>(
        (const bf16*)x, (const float*)mean, (const bf16*)y, (const bf16*)qf, (const bf16*)kvw,
        (const float*)macc, (const float*)sacc, (const float*)tacc, (const bf16*)dpool, (bf16*)ds,
        (bf16*)dv, (float*)dy, (float*)sdyxc, (float*)sdy, (bf16*)dx, N, n_valid, C, H, I,
        (int)region0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 3. dx from the sums over all N
  if (prenorm) {
    const size_t smem = (size_t)3 * C * 4;
    pool_layer_bwd_dx_kernel<<<dim3(N / kDxTile, B), kThreads, smem, st>>>(
        (const bf16*)x, (const float*)dy, (const float*)mean, (const float*)inv,
        (const float*)scale, (const float*)gmean, (const float*)ginv, (const float*)sdyxc,
        (const float*)sdy, (bf16*)dx, (float*)dscale, (float*)dbias, N, n_valid, C, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 4. dqf = sum_b y_b^T bf16(ds_b) [C, J];  dWv^T = sum_b y_b^T bf16(dv_b) [C, C]
  const bf16* yb = (const bf16*)y;
  err = launch_atb(yb, C, (size_t)N * C, nullptr, nullptr, (const bf16*)ds, J, (size_t)N * J,
                   (float*)dqf, J, 0, B, C, J, N, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_atb(yb, C, (size_t)N * C, nullptr, nullptr, (const bf16*)dv, C,
                         (size_t)N * C, (float*)dwvt, C, 0, B, C, C, N, st);
}
