// Timing variants of K11, the training loss's forward, hand-written for
// Hopper (sm_90a). Off the main path.
//
// Each variant is an instantiation of one of K11's kernel templates
// (ssim_forward.cuh, which lists them), and `base` is the instantiation K11
// launches (ssim_forward.cu). The listed design's other geometries,
// `nofold`, `persist`, `first` (the first design) and `first_lb5` compute
// K11's partial maps bit for bit (their sums in their own block order);
// nomaps, nostage, novert, nohoriz, first_novert, first_nohoriz and
// first_hregs are timing only. The
// numbering is K11_VARIANTS in ops/losses.py, and K11_TILES there holds
// each variant's tile, K11_FOLDS those whose kernel sums its blocks.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstring>

#include "ssim_forward.cuh"

// The arguments of glic_ssim_forward after the variant; block_sums holds
// the variant's blocks (its tile, kK11Shapes[variant]) and, where the
// kernel sums them (kFolds<V>), one more row for their total.
extern "C" int glic_ssim_forward_probe(int variant, const float* x, long long x_cs,
                                       long long x_rs, const float* y, long long y_cs,
                                       long long y_rs, int C, int H, int W, int r0, int r1,
                                       const float* konst, float* partials, float* block_sums,
                                       void* stream) {
  using namespace glic_ssim;
  if (C < 1 || C > 65535 || H < 1 || W < 1 || r0 < 0 || r1 <= r0 || r1 > H || !konst)
    return static_cast<int>(cudaErrorInvalidValue);
  Konst k;
  std::memcpy(&k, konst, sizeof(Konst));
  const Images im{x, x_cs, x_rs, y, y_cs, y_rs, H, W, r0, r1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GLIC_CASE(V) \
  case V:            \
    return static_cast<int>(launch_ssim_forward<V>(im, C, k, partials, block_sums, s));
    GLIC_CASE(kK11Base)
    GLIC_CASE(kK11R8)
    GLIC_CASE(kK11T32x16)
    GLIC_CASE(kK11T64x16)
    GLIC_CASE(kK11NoFold)
    GLIC_CASE(kK11NoMaps)
    GLIC_CASE(kK11NoStage)
    GLIC_CASE(kK11NoVert)
    GLIC_CASE(kK11NoHoriz)
    GLIC_CASE(kK11T64x16R4)
    GLIC_CASE(kK11T128x8R4)
    GLIC_CASE(kK11Persist)
    GLIC_CASE(kK11First)
    GLIC_CASE(kK11FirstNoVert)
    GLIC_CASE(kK11FirstNoHoriz)
    GLIC_CASE(kK11FirstHRegs)
    GLIC_CASE(kK11FirstLb5)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
