// Timing variants of K12, the training loss's backward, hand-written for
// Hopper (sm_90a). Off the main path.
//
// Each variant is an instantiation of one of K12's kernel templates
// (ssim_backward.cuh, which lists them), and `base` is the instantiation K12
// launches (ssim_backward.cu). `t32x32`, `a4`, `sync`, the listed
// design's other geometries, `first` (the first design) and `first_lb5`
// compute K12's d bit for bit; nostage, novert, nohoriz, noepi,
// first_novert, first_nohoriz and first_noepi are timing only. The numbering is K12_VARIANTS in
// ops/losses.py, and K12_TILES there holds each variant's tile.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstring>

#include "ssim_backward.cuh"

// The arguments of glic_ssim_backward after the variant.
extern "C" int glic_ssim_backward_probe(int variant, const float* x, long long x_cs,
                                        long long x_rs, const float* y, long long y_cs,
                                        long long y_rs, int C, int H, int W, int r0, int r1,
                                        const float* konst, const float* partials,
                                        const float* grad, float* d, void* stream) {
  using namespace glic_k12;
  if (C < 1 || C > 65535 || H < 1 || W < 1 || r0 < 0 || r1 <= r0 || r1 > H || !konst)
    return static_cast<int>(cudaErrorInvalidValue);
  Konst k;
  std::memcpy(&k, konst, sizeof(Konst));
  const Args a{x, x_cs, x_rs, y, y_cs, y_rs, C, H, W, r0, r1, partials, grad, d, false};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GLIC_CASE(V) \
  case V:            \
    return static_cast<int>(launch_ssim_backward<V>(a, k, s));
    GLIC_CASE(kK12Base)
    GLIC_CASE(kK12T32x32)
    GLIC_CASE(kK12A4)
    GLIC_CASE(kK12Sync)
    GLIC_CASE(kK12R8)
    GLIC_CASE(kK12T32x16)
    GLIC_CASE(kK12T32x24)
    GLIC_CASE(kK12NoStage)
    GLIC_CASE(kK12NoVert)
    GLIC_CASE(kK12NoHoriz)
    GLIC_CASE(kK12NoEpi)
    GLIC_CASE(kK12First)
    GLIC_CASE(kK12FirstNoVert)
    GLIC_CASE(kK12FirstNoHoriz)
    GLIC_CASE(kK12FirstNoEpi)
    GLIC_CASE(kK12FirstLb5)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
