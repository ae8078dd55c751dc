// K5: the per-Gaussian preprocess forward, hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/models/gaussians.py:84-94 activations (scaling = exp,
// rotation = q / (|q| + 1e-12), opacity = sigmoid), ops/projection.py:77
// project_gaussians, ops/sh.py:47 eval_sh_color and ops/rasterize.py:78
// _pack_rows (the reference's preprocessCUDA, forward.cu:232-319). In
// PyTorch that chain was ~100 separate (P,) kernels, two concatenations and
// a pad, and the activations five more.
//
// What bounds it on this card: device memory. Per Gaussian it reads 59
// floats (xyz, scale, quat, opacity, dc, 45 of sh_rest) and writes a
// 16-float splat row, depth, radius and a flag (and, from the stored
// parameters, the activated opacity); ~0.10 ms at 2^20 Gaussians at 3.35
// TB/s; its per-Gaussian arithmetic is far below the card's rate. One
// thread per Gaussian keeps every term in registers and stores its row as
// four float4s straight into the (P + 1, 16) table that K1's gather
// indexes; thread P writes the zero row of the sorted list's dead id. The
// arithmetic is preprocess_common.cuh's, the plain chain's float operations
// in its order.
//
// Two input forms, one kernel body (template parameter kRaw): the stored
// parameters log_scale, quat and opa_logit, activated in registers as
// CUDA's torch.exp, the norm chain and torch.sigmoid compute them (the
// train step, the renders of a map), or values already activated (the
// dense oracle's and the probes' scenes).
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "preprocess_common.cuh"

namespace {

using namespace glic_pre;

// kRaw: scale, quat and opacity hold log_scale, quat and opa_logit as
// stored, and the activated opacity is written to opa_out.
template <bool kRaw>
__global__ void preprocess_forward_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scale,
    const float* __restrict__ quat, const float* __restrict__ opacity,
    const float* __restrict__ dc, const float* __restrict__ sh_rest,
    const bool* __restrict__ active, Camera cam, Intr in, long long P, int S, int deg,
    int no_color, float* __restrict__ table, float* __restrict__ depth,
    float* __restrict__ radius, bool* __restrict__ base_active,
    float* __restrict__ opa_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i > P) return;
  float4* row = reinterpret_cast<float4*>(table + i * 16);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i == P) {
    for (int k = 0; k < 4; ++k) row[k] = zero;
    return;
  }
  const float X[3] = {xyz[i * 3], xyz[i * 3 + 1], xyz[i * 3 + 2]};
  float s[3] = {scale[i * 3], scale[i * 3 + 1], scale[i * 3 + 2]};
  float q[4] = {quat[i * 4], quat[i * 4 + 1], quat[i * 4 + 2], quat[i * 4 + 3]};
  float opa = opacity[i];
  if constexpr (kRaw) {
    activate(s, q, opa);
    opa_out[i] = opa;
  }
  Terms T;
  project(X, s, q, cam, in, T);
  const bool base = T.in_front && T.det_valid && opa >= kOpacityThreshold &&
                    (active == nullptr || active[i]);
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (!no_color) {
    float dirs[3], d[3];
    view_dir(X, cam, dirs, d);
    sh_unclamped(deg, dc + i * 3, sh_rest + i * S * 3, d, rgb);
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = clamp_min(rgb[ch], 0.0f);
  }
  row[0] = make_float4(T.xy[0], T.xy[1], T.conic[0], T.conic[1]);
  row[1] = make_float4(T.conic[2], opa, rgb[0], rgb[1]);
  row[2] = make_float4(rgb[2], 0.0f, 0.0f, 0.0f);
  row[3] = zero;
  depth[i] = T.depth;
  radius[i] = base ? T.radius : 0.0f;
  base_active[i] = base;
}

}  // namespace

// K5. `table` is (P + 1, 16) float32 (16-byte aligned rows); `active` may be
// null (every Gaussian active); dc and sh_rest are unread with no_color.
// With `raw` != 0, scale, quat and opacity are log_scale, quat and
// opa_logit as stored and `opa_out` (P,) receives the activated opacity
// (it is unwritten, and may be null, otherwise).
extern "C" int glic_preprocess_forward(
    const float* xyz, const float* scale, const float* quat, const float* opacity,
    const float* dc, const float* sh_rest, const bool* active, const float* R_cw,
    const float* t_cw, const float* full_proj, const float* cam_center, long long P, int S,
    int deg, int no_color, int raw, float W, float H, float fx, float fy, float limx_neg,
    float limx_pos, float limy_neg, float limy_pos, float* table, float* depth,
    float* radius, bool* base_active, float* opa_out, void* stream) {
  using namespace glic_pre;
  constexpr int kThreads = 256;
  const long long blocks = (P + 1 + kThreads - 1) / kThreads;
  auto kernel = raw ? preprocess_forward_kernel<true> : preprocess_forward_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, scale, quat, opacity, dc, sh_rest, active, Camera{R_cw, t_cw, full_proj, cam_center},
      Intr{W, H, fx, fy, limx_neg, limx_pos, limy_neg, limy_pos}, P, S, deg, no_color, table,
      depth, radius, base_active, opa_out);
  return static_cast<int>(cudaGetLastError());
}
