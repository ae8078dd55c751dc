// K4: substitution probes of the tile blend backward (K2), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_bwd.py: make_bwd(...).run (its
// pl.pallas_call at :354), the Pallas probe of blend_pallas.py's backward.
// As there, a probe is the production kernel with its pipeline, its
// reduction or its output stage swapped out: every variant is an
// instantiation of K2's own kernel template (blend_backward.cuh, which lists
// them), and `base` is the instantiation K2 launches (blend_backward.cu). The
// numbering is BACKWARD_VARIANTS in ops/blend_probe.py.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_backward.cuh"

// `out`: the (P+1, 12) per-Gaussian table, zeros (noatomic: (4, m_pad, 9)
// zeros), 16-byte aligned; `sorted_gauss` may be null for noatomic.
// `tile_order`: a permutation of the tiles, the launch order. `walked`:
// (n_tiles,) int32 zeros, or null. `rows` must be 16-byte aligned.
extern "C" int glic_blend_probe_backward(int variant, const float* rows, long long m_pad,
                                         const int* tile_starts, const int* tile_lens,
                                         const int* tile_order, const float* dl_dcolor,
                                         const float* final_t, const int* n_contrib,
                                         const int* sorted_gauss, float* out, int* walked,
                                         int n_tx, int n_ty, int tile_w, int tile_h,
                                         void* stream) {
  using namespace glic;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GLIC_CASE(V)                                                                         \
  case V:                                                                                    \
    return static_cast<int>(launch_backward<V>(rows, m_pad, tile_starts, tile_lens,          \
                                               tile_order, dl_dcolor, final_t, n_contrib,    \
                                               sorted_gauss, out, walked, n_tx, n_ty,        \
                                               tile_w, tile_h, s));
    GLIC_CASE(kBwdBase)
    GLIC_CASE(kBwdSbuf)
    GLIC_CASE(kBwdNoRed)
    GLIC_CASE(kBwdSmemAtomic)
    GLIC_CASE(kBwdNoAtomic)
    GLIC_CASE(kBwdNoCull)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
