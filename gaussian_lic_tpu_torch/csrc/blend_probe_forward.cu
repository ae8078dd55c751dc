// K3: substitution probes of the tile blend forward (K1), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_kernel.py: make_fwd(...).run (its
// pl.pallas_call at :235), the Pallas probe of blend_pallas.py's forward.
// As there, a probe is the production kernel with one cost centre swapped
// out, so that the time it removes from `base` is what that centre costs:
// every variant is an instantiation of K1's own kernel template
// (blend_forward.cuh, which lists them), and `base` is the instantiation K1
// launches (blend_forward.cu). The numbering is FORWARD_VARIANTS in
// ops/blend_probe.py.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_forward.cuh"

// `konst`: 9 host floats (x, y, A, B, C, opa, r, g, b), the splat of the
// noattr variant, or null. `walked`: (n_tiles,) int32 zeros, or null.
// `rows` must be 16-byte aligned.
extern "C" int glic_blend_probe_forward(int variant, const float* rows, long long m_pad,
                                        const int* tile_starts, const int* tile_lens,
                                        float* color, float* final_t, int* n_contrib,
                                        int* walked, int n_tx, int n_ty, int tile_w,
                                        int tile_h, const float* konst, void* stream) {
  using namespace glic;
  RawSplat k{};
  if (konst != nullptr) {
    for (int i = 0; i < 9; ++i) k.v[i] = konst[i];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GLIC_CASE(V)                                                                       \
  case V:                                                                                  \
    return static_cast<int>(launch_forward<V>(rows, m_pad, tile_starts, tile_lens, color,  \
                                              final_t, n_contrib, walked, n_tx, n_ty,      \
                                              tile_w, tile_h, 0, k, s));
    GLIC_CASE(kFwdBase)
    GLIC_CASE(kFwdNoCull)
    GLIC_CASE(kFwdNoExp)
    GLIC_CASE(kFwdNoAttr)
    GLIC_CASE(kFwdNoBlend)
    GLIC_CASE(kFwdBatch256)
    GLIC_CASE(kFwdDirect)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
