// Backward of the tiled online-softmax attention pool (folded_pool_ext):
// the v2 and v2j bodies, under GECCO_POOL_BWD=v2 and v2j.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel
// (v2) and _pool_ext_bwd_kernel_v2j (v2j), the mid-round-5 two-pass body:
// 1/sacc folded into the placement matrix once per batch element (DMs),
// pass 0 only e^T v, T = rowsum(DMs pacc) / sacc at its end, and pass 1
// forming ds and dv from e. The two are one algebra: v2 forms 1/sacc in
// the kernel from sacc, v2j reads the [B, J] 1/sacc that its wrapper
// forms (the TPU body's [J, 1] operand), and both give the same bits. The
// algebra, the design and the bound: pool_bwd_twopass.cuh (its v2
// instances).
#include "pool_bwd_twopass.cuh"

using namespace gecco;

extern "C" int pool_ext_bwd_v2_launch(const void* x, const void* se, const void* be,
                                      const void* qft, const void* kvw, const void* wo,
                                      const void* gh, const void* macc, const void* sacc, void* y,
                                      void* dm, void* tacc, void* merged, void* ds, void* dv,
                                      void* colpart, void* wpart, void* dx, void* dsum, void* dqf,
                                      void* dwv, void* dwo, int B, int N, int C, int H, int I,
                                      int s_qf, int s_wv, int s_wo, int n_valid, void* stream) {
  return (int)twopass::launch<twopass::kV2, false>(
      x, se, be, qft, kvw, wo, gh, macc, sacc, y, dm, tacc, merged, ds, dv, colpart, wpart, dx,
      dsum, dqf, dwv, dwo, B, N, C, H, I, s_qf, s_wv, s_wo, n_valid, (cudaStream_t)stream);
}

// isc: the [B, J] 1/sacc
extern "C" int pool_ext_bwd_v2j_launch(const void* x, const void* se, const void* be,
                                       const void* qft, const void* kvw, const void* wo,
                                       const void* gh, const void* macc, const void* isc, void* y,
                                       void* dm, void* tacc, void* merged, void* ds, void* dv,
                                       void* colpart, void* wpart, void* dx, void* dsum,
                                       void* dqf, void* dwv, void* dwo, int B, int N, int C,
                                       int H, int I, int s_qf, int s_wv, int s_wo, int n_valid,
                                       void* stream) {
  return (int)twopass::launch<twopass::kV2, true>(
      x, se, be, qft, kvw, wo, gh, macc, isc, y, dm, tacc, merged, ds, dv, colpart, wpart, dx,
      dsum, dqf, dwv, dwo, B, N, C, H, I, s_qf, s_wv, s_wo, n_valid, (cudaStream_t)stream);
}
