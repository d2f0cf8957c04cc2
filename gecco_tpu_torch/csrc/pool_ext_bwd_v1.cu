// Backward of the tiled online-softmax attention pool (folded_pool_ext):
// the v1 body, under GECCO_POOL_BWD=v1.
//
// Replaces gecco_tpu/ops/pallas/folded_attention.py:_pool_ext_bwd_kernel_v1,
// the round-4 two-pass body: DM = bf16(g_h0 Wo) per head, unscaled; dp =
// v DM^T in both passes, t = sum_n e dp in pass 0; p = e / sacc and
// bf16(p) in pass 1. The algebra, the design and the bound:
// pool_bwd_twopass.cuh (its v1 instance).
#include "pool_bwd_twopass.cuh"

using namespace gecco;

extern "C" int pool_ext_bwd_v1_launch(const void* x, const void* se, const void* be,
                                      const void* qft, const void* kvw, const void* wo,
                                      const void* gh, const void* macc, const void* sacc, void* y,
                                      void* dm, void* tacc, void* merged, void* ds, void* dv,
                                      void* colpart, void* wpart, void* dx, void* dsum, void* dqf,
                                      void* dwv, void* dwo, int B, int N, int C, int H, int I,
                                      int s_qf, int s_wv, int s_wo, int n_valid, void* stream) {
  return (int)twopass::launch<twopass::kV1, false>(
      x, se, be, qft, kvw, wo, gh, macc, sacc, y, dm, tacc, merged, ds, dv, colpart, wpart, dx,
      dsum, dqf, dwv, dwo, B, N, C, H, I, s_qf, s_wv, s_wo, n_valid, (cudaStream_t)stream);
}
