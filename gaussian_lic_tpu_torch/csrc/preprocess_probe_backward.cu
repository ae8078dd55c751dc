// Timing variants of K6, the per-Gaussian preprocess backward, hand-written
// for Hopper (sm_90a). Off the main path.
//
// Each variant is an instantiation of K6's own kernel template
// (preprocess_backward.cuh, which lists them), and `base` is the
// instantiation K6 launches (preprocess_backward.cu): `direct` computes K6's
// outputs bit for bit through the first design's access pattern, `noshio`
// and `noproj` are timing only (their outputs are not K6's). The numbering
// is K6_VARIANTS in ops/preprocess.py.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "preprocess_backward.cuh"

// The arguments of glic_preprocess_backward after the variant; each
// variant in both input forms (`raw`).
extern "C" int glic_preprocess_probe_backward(
    int variant, const float* xyz, const float* scale, const float* quat,
    const float* opa_logit, const float* dc, const float* sh_rest, const float* R_cw,
    const float* t_cw, const float* full_proj, const float* cam_center, const float* d_attrs,
    long long d_stride, long long P, int S, int deg, int raw, float W, float H, float fx,
    float fy, float limx_neg, float limx_pos, float limy_neg, float limy_pos, float* d_xyz,
    float* d_scale, float* d_quat, float* d_opacity, float* d_dc, float* d_sh, void* stream) {
  using namespace glic_pre;
  switch (2 * variant + (raw ? 1 : 0)) {
#define GLIC_CASE(V, R)                                                                     \
  case 2 * V + R:                                                                           \
    return static_cast<int>(launch_preprocess_backward<V, R>(                               \
        xyz, scale, quat, opa_logit, dc, sh_rest, R_cw, t_cw, full_proj, cam_center,        \
        d_attrs, d_stride, P, S, deg, W, H, fx, fy, limx_neg, limx_pos, limy_neg, limy_pos, \
        d_xyz, d_scale, d_quat, d_opacity, d_dc, d_sh, static_cast<cudaStream_t>(stream)));
    GLIC_CASE(kK6Base, false)
    GLIC_CASE(kK6Base, true)
    GLIC_CASE(kK6Direct, false)
    GLIC_CASE(kK6Direct, true)
    GLIC_CASE(kK6NoShIo, false)
    GLIC_CASE(kK6NoShIo, true)
    GLIC_CASE(kK6NoProj, false)
    GLIC_CASE(kK6NoProj, true)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
