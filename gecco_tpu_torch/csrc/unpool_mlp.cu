// Unpool + residual -> mlp_norm -> MLP + residual in one launch, with the
// output channel sums: the unpool + MLP megakernel.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_unpool_mlp_kernel
// (served by fused_unpool_mlp; opt-in on the sampler through
// GECCO_UNPOOL_MLP_MEGAKERNEL=1). The same function as folded_unpool, the
// mlp_norm statistics and fused_mlp_residual in turn:
//   x' = x + attn(x * se1 + be1)       as unpool.cu; x' rounded to bf16,
//   s1, s2 = sum_n x', sum_n x'^2      its channel sums in fp32
//   per group g of C / G channels, over n_tokens points:
//     mean = s1_g / count;  var = s2_g / count - mean^2
//     inv = rsqrt(max(var, 0) + 1e-5)
//   se2 = sc2 * inv;  be2 = bi2 - mean * se2   (sc2/bi2: the raw embed affine)
//   out = x' + mlp(x' * se2 + be2)     as mlp.cu, with its output sums.
//
// Bound on the H100: the unpool's and the MLP's tensor-core operations
// (4*N*C*(J + W) per batch element); the megakernel's saving over the two
// kernels is one write and one read of x' (4*N*C bytes per element).
// Design: the MLP of any point needs the statistics of all N points of its
// batch element. The TPU kept x' (1.5 MB per element at the flagship) in
// VMEM between its two passes; an SM has 227 KB. Here one cooperative
// launch runs one persistent block per SM (as many as fit), whose phases a
// grid-wide barrier separates: (1) be1 @ wq^T per batch element, (2) the
// fold of kft/vf/brow, (3) the unpool's point tiles (unpool.cuh), each
// writing its tile of x' to a scratch [B, N, C] in device memory and adding
// its channel sums with fp32 atomics, (4) the statistics collapse per (b,
// c) into se2/be2, (5) the MLP's point tiles (mlp.cuh) on x'. The device
// code of phases (1)-(3) and (5) is that of unpool.cu and mlp.cu, so the
// result is theirs up to the order of the fp32 atomics. x' goes through L2
// and device memory: this design keeps the launch single but not the
// stream's saving, which a cluster of blocks per batch element holding x'
// in distributed shared memory would.
#include <cmath>

#include <cooperative_groups.h>

#include "mlp.cuh"
#include "unpool.cuh"

using namespace gecco;
namespace cg = cooperative_groups;

namespace {

struct Args {
  const bf16* x;
  const float *se1, *be1;
  const bf16 *k, *v, *wq, *wo_t;
  const float *sc2, *bi2;
  const bf16* w1t;
  const float* b1;
  const bf16* w2t;
  const float* b2;
  float* bq;
  bf16 *kft, *vf;
  float* brow;
  bf16* xp;
  float *sums1, *se2, *be2;
  bf16* out;
  float* sums;
  int B, N, C, H, I, W, G, n_tokens;
  int dbl, region0_unpool, chunk, region0_mlp;
  float scale;
};

template <int ROWS>
__global__ void __launch_bounds__(kThreads) unpool_mlp_kernel(const Args a) {
  constexpr int TN = 16 * ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int J = a.H * a.I, tiles = a.B * (a.N / TN);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kThreads;

  // (1) bq = be1 @ wq^T, one warp per (b, o)
  const int warps = gridDim.x * kWarps;
  for (int u = blockIdx.x * kWarps + threadIdx.x / 32; u < a.B * a.C; u += warps) {
    unpool_bq_warp(a.be1, a.wq, a.bq, a.C, u / a.C, u % a.C);
  }
  grid.sync();
  // (2) the fold, one thread per output element
  const long long per_b = (long long)J * a.C + J;
  for (long long e = tid; e < a.B * per_b; e += threads) {
    unpool_fold_elem(a.se1, a.bq, a.k, a.v, a.wq, a.wo_t, a.kft, a.vf, a.brow, a.C, a.H, a.I,
                     a.scale, (int)(e / per_b), (int)(e % per_b));
  }
  grid.sync();
  // (3) the unpool's point tiles: x' and its sums
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();  // the last tile's epilogue is done with the shared memory
    unpool_tile<ROWS>(a.x, a.kft, a.brow, a.vf, a.xp, a.sums1, a.N, a.C, a.H, a.I, a.dbl,
                      a.region0_unpool, t / (a.N / TN), t % (a.N / TN), smem);
  }
  grid.sync();
  // (4) the mlp_norm statistics and the embed affine, one thread per (b, c)
  const int pg = a.C / a.G;
  const float count = (float)a.n_tokens * (float)pg;
  for (long long e = tid; e < (long long)a.B * a.C; e += threads) {
    const int b = (int)(e / a.C), c = (int)(e % a.C), c0 = (c / pg) * pg;
    const float* s1 = a.sums1 + (size_t)b * 2 * a.C;
    float g1 = 0.0f, g2 = 0.0f;
    for (int q = c0; q < c0 + pg; ++q) {
      g1 += s1[q];
      g2 += s1[a.C + q];
    }
    const float mean = g1 / count;
    const float var = g2 / count - mean * mean;
    const float inv = rsqrtf(fmaxf(var, 0.0f) + 1e-5f);
    const float se = a.sc2[e] * inv;
    a.se2[e] = se;
    a.be2[e] = a.bi2[e] - mean * se;
  }
  grid.sync();
  // (5) the MLP's point tiles on x'
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();
    mlp_tile<ROWS>(a.xp, a.se2, a.be2, a.w1t, a.b1, a.w2t, a.b2, a.out, a.sums, a.N, a.C, a.W,
                   a.chunk, a.region0_mlp, t / (a.N / TN), t % (a.N / TN), smem);
  }
}

// The block's bytes (the larger of the unpool's and the MLP's plans), or 0
// where a plan does not fit; fills the plans into ``a``.
size_t plan(Args& a, int TN) {
  size_t r0u = 0, r0m = 0;
  const size_t su = unpool_smem_plan(TN, a.C, a.I, &a.dbl, &r0u);
  const size_t sm = mlp_smem_plan(TN, a.C, a.W, &a.chunk, &r0m);
  if (su == 0 || sm == 0) return 0;
  a.region0_unpool = (int)r0u;
  a.region0_mlp = (int)r0m;
  return su > sm ? su : sm;
}

}  // namespace

// Shared memory one block of the megakernel needs at these shapes, or 0
// where the unpool's or the MLP's tile does not fit one SM.
extern "C" int unpool_mlp_smem(int C, int I, int W, int TN) {
  Args a{};
  a.C = C;
  a.I = I;
  a.W = W;
  return (int)plan(a, TN);
}

extern "C" int unpool_mlp_launch(const void* x, const void* se1, const void* be1, const void* k,
                                 const void* v, const void* wq, const void* wo_t, const void* sc2,
                                 const void* bi2, const void* w1t, const void* b1,
                                 const void* w2t, const void* b2, void* bq, void* kft, void* vf,
                                 void* brow, void* xp, void* sums1, void* se2, void* be2,
                                 void* out, void* sums, int B, int N, int C, int H, int I, int W,
                                 int G, int n_tokens, int TN, void* stream) {
  Args a{(const bf16*)x, (const float*)se1, (const float*)be1, (const bf16*)k, (const bf16*)v,
         (const bf16*)wq, (const bf16*)wo_t, (const float*)sc2, (const float*)bi2,
         (const bf16*)w1t, (const float*)b1, (const bf16*)w2t, (const float*)b2, (float*)bq,
         (bf16*)kft, (bf16*)vf, (float*)brow, (bf16*)xp, (float*)sums1, (float*)se2,
         (float*)be2, (bf16*)out, (float*)sums, B, N, C, H, I, W, G, n_tokens};
  // 1/sqrt(D) rounded once from double, as the JAX package's Python float
  a.scale = (float)(1.0 / sqrt((double)(C / H)));
  const size_t smem = plan(a, TN);
  if (smem == 0 || (TN != 64 && TN != 32) || C % G != 0) return (int)cudaErrorInvalidValue;
  const auto kernel = TN == 64 ? unpool_mlp_kernel<4> : unpool_mlp_kernel<2>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(kThreads),
                                    params, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
