// K6: the per-Gaussian preprocess backward, hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the autodiff of the JAX
// package's gaussian_lic_tpu/ops/projection.py:77 project_gaussians,
// ops/sh.py:47 eval_sh_color and ops/rasterize.py:78 _pack_rows (the
// reference's BACKWARD::preprocess and its preprocessCUDA,
// backward.cu:312-377, 599-657). In PyTorch that was autograd's backward
// of ~100 (P,) kernels, with a zero-filled (P, 15, 3) tensor for each of
// the 15 SH coefficient selects.
//
// What bounds it on this card: device memory. Per Gaussian it reads the
// nine row gradients of K2's output as K2 left them (a (P, 9) view of its
// 12-float table: no pad or copy between K2 and K6) and the 236 B of inputs,
// and writes the six gradients (236 B); ~0.16 ms at 2^20 Gaussians at 3.35
// TB/s. It recomputes the forward terms with K5's arithmetic
// (preprocess_common.cuh) instead of reading saved ones, which would move
// more bytes than it computes. The closed form is ops/preprocess.py's
// preprocess_backward_plain line for line, with autograd's masks on the
// plain chain: tx/ty's clamp passes inside its closed bounds, the selects on
// tz and det != 0 pass where they took the computed value, the colour's
// clamp at 0 where the colour is >= 0, coefficients above the active degree
// get zero.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "preprocess_common.cuh"

namespace {

using namespace glic_pre;

// d v of v / (|v| + 1e-12) for the cotangent g (0 where |v| = 0, as
// autograd's norm backward)
template <int N>
__device__ __forceinline__ void norm_backward(const float* v, float n, const float* g,
                                              float* out) {
  const float D = n + 1e-12f;
  float dot = 0.0f;
  for (int k = 0; k < N; ++k) dot += g[k] * v[k];
  const float sc = n == 0.0f ? 0.0f : dot / (D * D * n);
  for (int k = 0; k < N; ++k) out[k] = g[k] / D - v[k] * sc;
}

// The 15 rest basis functions B_k at the unit direction (x, y, z) and
// their derivatives dB_k / d(x, y, z).
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* B, float (*dB)[3]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float C1 = kSH_C1;
  B[0] = -C1 * y;  dB[0][0] = 0.0f;  dB[0][1] = -C1;  dB[0][2] = 0.0f;
  B[1] = C1 * z;   dB[1][0] = 0.0f;  dB[1][1] = 0.0f; dB[1][2] = C1;
  B[2] = -C1 * x;  dB[2][0] = -C1;   dB[2][1] = 0.0f; dB[2][2] = 0.0f;
  B[3] = kSH_C2_0 * x * y;
  dB[3][0] = kSH_C2_0 * y;  dB[3][1] = kSH_C2_0 * x;  dB[3][2] = 0.0f;
  B[4] = kSH_C2_1 * y * z;
  dB[4][0] = 0.0f;  dB[4][1] = kSH_C2_1 * z;  dB[4][2] = kSH_C2_1 * y;
  B[5] = kSH_C2_2 * (2.0f * zz - xx - yy);
  dB[5][0] = -2.0f * kSH_C2_2 * x;  dB[5][1] = -2.0f * kSH_C2_2 * y;
  dB[5][2] = 4.0f * kSH_C2_2 * z;
  B[6] = kSH_C2_3 * x * z;
  dB[6][0] = kSH_C2_3 * z;  dB[6][1] = 0.0f;  dB[6][2] = kSH_C2_3 * x;
  B[7] = kSH_C2_4 * (xx - yy);
  dB[7][0] = 2.0f * kSH_C2_4 * x;  dB[7][1] = -2.0f * kSH_C2_4 * y;  dB[7][2] = 0.0f;
  B[8] = kSH_C3_0 * y * (3.0f * xx - yy);
  dB[8][0] = kSH_C3_0 * 6.0f * x * y;  dB[8][1] = kSH_C3_0 * (3.0f * xx - 3.0f * yy);
  dB[8][2] = 0.0f;
  B[9] = kSH_C3_1 * x * y * z;
  dB[9][0] = kSH_C3_1 * y * z;  dB[9][1] = kSH_C3_1 * x * z;  dB[9][2] = kSH_C3_1 * x * y;
  B[10] = kSH_C3_2 * y * (4.0f * zz - xx - yy);
  dB[10][0] = kSH_C3_2 * -2.0f * x * y;  dB[10][1] = kSH_C3_2 * (4.0f * zz - xx - 3.0f * yy);
  dB[10][2] = kSH_C3_2 * 8.0f * y * z;
  B[11] = kSH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  dB[11][0] = kSH_C3_3 * -6.0f * x * z;  dB[11][1] = kSH_C3_3 * -6.0f * y * z;
  dB[11][2] = kSH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
  B[12] = kSH_C3_4 * x * (4.0f * zz - xx - yy);
  dB[12][0] = kSH_C3_4 * (4.0f * zz - 3.0f * xx - yy);  dB[12][1] = kSH_C3_4 * -2.0f * x * y;
  dB[12][2] = kSH_C3_4 * 8.0f * x * z;
  B[13] = kSH_C3_5 * z * (xx - yy);
  dB[13][0] = kSH_C3_5 * 2.0f * x * z;  dB[13][1] = kSH_C3_5 * -2.0f * y * z;
  dB[13][2] = kSH_C3_5 * (xx - yy);
  B[14] = kSH_C3_6 * x * (xx - 3.0f * yy);
  dB[14][0] = kSH_C3_6 * (3.0f * xx - 3.0f * yy);  dB[14][1] = kSH_C3_6 * -6.0f * x * y;
  dB[14][2] = 0.0f;
}

__global__ void preprocess_backward_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scale,
    const float* __restrict__ quat, const float* __restrict__ dc,
    const float* __restrict__ sh_rest, Camera cam, Intr in,
    const float* __restrict__ d_attrs, long long d_stride, long long P, int S, int deg,
    float* __restrict__ d_xyz, float* __restrict__ d_scale, float* __restrict__ d_quat,
    float* __restrict__ d_opacity, float* __restrict__ d_dc, float* __restrict__ d_sh) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const float X[3] = {xyz[i * 3], xyz[i * 3 + 1], xyz[i * 3 + 2]};
  const float s[3] = {scale[i * 3], scale[i * 3 + 1], scale[i * 3 + 2]};
  const float q[4] = {quat[i * 4], quat[i * 4 + 1], quat[i * 4 + 2], quat[i * 4 + 3]};
  Terms T;
  project(X, s, q, cam, in, T);
  const float* g = d_attrs + i * d_stride;
  const float gx = g[0], gy = g[1], gA = g[2], gB = g[3], gC = g[4];
  const float* Rc = cam.R;
  const float* Fp = cam.F;

  // pixel mean: xy = ((ph * inv_w + 1) * S - 1) / 2
  const float ax = gx * (0.5f * in.W);
  const float ay = gy * (0.5f * in.H);
  const float d_phx = ax * T.inv_w;
  const float d_phy = ay * T.inv_w;
  const float d_inv_w = ax * T.phx + ay * T.phy;
  const float d_pw = -d_inv_w * T.inv_w * T.inv_w;

  // conic = (c, -b, a) / det, det = a c - b^2 where det != 0
  float d_a = gC * T.inv_det;
  float d_b = -gB * T.inv_det;
  float d_c = gA * T.inv_det;
  const float d_inv_det = gA * T.c - gB * T.b + gC * T.a;
  const float d_det = T.det_valid ? -d_inv_det * T.inv_det * T.inv_det : 0.0f;
  d_a = d_a + d_det * T.c;
  d_c = d_c + d_det * T.a;
  d_b = d_b - 2.0f * T.b * d_det;

  // a = m0 S m0 + 0.3, b = m1 S m0, c = m1 S m1 + 0.3 (S symmetric)
  const float* m0 = T.m0;
  const float* m1 = T.m1;
  float dS[3][3];
  for (int a = 0; a < 3; ++a) {
    dS[a][a] = d_a * m0[a] * m0[a] + d_b * m1[a] * m0[a] + d_c * m1[a] * m1[a];
    for (int b = a + 1; b < 3; ++b) {
      dS[a][b] = 2.0f * d_a * m0[a] * m0[b] + d_b * (m1[a] * m0[b] + m1[b] * m0[a]) +
                 2.0f * d_c * m1[a] * m1[b];
      dS[b][a] = dS[a][b];
    }
  }
  float d_m0[3], d_m1[3];
  for (int j = 0; j < 3; ++j) {
    d_m0[j] = 2.0f * d_a * T.t[j] + d_b * T.u[j];
    d_m1[j] = d_b * T.t[j] + 2.0f * d_c * T.u[j];
  }

  // m0 = J00 Rc[0] + J02 Rc[2], m1 = J11 Rc[1] + J12 Rc[2]
  const float d_J00 = d_m0[0] * Rc[0] + d_m0[1] * Rc[1] + d_m0[2] * Rc[2];
  const float d_J02 = d_m0[0] * Rc[6] + d_m0[1] * Rc[7] + d_m0[2] * Rc[8];
  const float d_J11 = d_m1[0] * Rc[3] + d_m1[1] * Rc[4] + d_m1[2] * Rc[5];
  const float d_J12 = d_m1[0] * Rc[6] + d_m1[1] * Rc[7] + d_m1[2] * Rc[8];

  // J00 = fx / tz, J02 = -fx tx / tz^2 (and y)
  const float d_inv_tz2 = -in.fx * T.tx * d_J02 - in.fy * T.ty * d_J12;
  const float d_inv_tz = in.fx * d_J00 + in.fy * d_J11 + 2.0f * T.inv_tz * d_inv_tz2;
  const float d_tx = -in.fx * T.inv_tz2 * d_J02;
  const float d_ty = -in.fy * T.inv_tz2 * d_J12;
  // tx = clamp(pvx / tz) tz
  const float d_rx = (T.rx >= in.limx_neg && T.rx <= in.limx_pos) ? d_tx * T.tz : 0.0f;
  const float d_ry = (T.ry >= in.limy_neg && T.ry <= in.limy_pos) ? d_ty * T.tz : 0.0f;
  const float d_tz = -d_inv_tz * T.inv_tz * T.inv_tz + d_tx * T.cx + d_ty * T.cy -
                     (d_rx * T.rx + d_ry * T.ry) / T.tz;
  const float d_pvx = d_rx / T.tz;
  const float d_pvy = d_ry / T.tz;
  const float d_depth = T.tz_kept ? d_tz : 0.0f;
  float gX[3];
  for (int k = 0; k < 3; ++k)
    gX[k] = d_pvx * Rc[k] + d_pvy * Rc[3 + k] + d_depth * Rc[6 + k] + d_phx * Fp[k] +
            d_phy * Fp[4 + k] + d_pw * Fp[12 + k];

  // S_ij = sum_k s_k^2 R_ik R_jk
  float dR[3][3];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) {
      const float M0 = a == 0 ? 2.0f * dS[0][0] : dS[a][0];
      const float M1 = a == 1 ? 2.0f * dS[1][1] : dS[a][1];
      const float M2 = a == 2 ? 2.0f * dS[2][2] : dS[a][2];
      dR[a][k] = T.sig[k] * (M0 * T.R[0][k] + M1 * T.R[1][k] + M2 * T.R[2][k]);
    }
  for (int k = 0; k < 3; ++k) {
    const float d_sig = dS[0][0] * T.R[0][k] * T.R[0][k] + dS[1][1] * T.R[1][k] * T.R[1][k] +
                        dS[2][2] * T.R[2][k] * T.R[2][k] + dS[0][1] * T.R[0][k] * T.R[1][k] +
                        dS[0][2] * T.R[0][k] * T.R[2][k] + dS[1][2] * T.R[1][k] * T.R[2][k];
    d_scale[i * 3 + k] = 2.0f * s[k] * d_sig;
  }

  // R of the normalised quaternion (r, x, y, z)
  const float qr = T.q[0], qx = T.q[1], qy = T.q[2], qz = T.q[3];
  float dq[4];
  dq[0] = 2.0f * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0] - qx * dR[1][2] -
                  qy * dR[2][0] + qx * dR[2][1]);
  dq[1] = 2.0f * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0] - 2.0f * qx * dR[1][1] -
                  qr * dR[1][2] + qz * dR[2][0] + qr * dR[2][1] - 2.0f * qx * dR[2][2]);
  dq[2] = 2.0f * (-2.0f * qy * dR[0][0] + qx * dR[0][1] + qr * dR[0][2] + qx * dR[1][0] +
                  qz * dR[1][2] - qr * dR[2][0] + qz * dR[2][1] - 2.0f * qy * dR[2][2]);
  dq[3] = 2.0f * (-2.0f * qz * dR[0][0] - qr * dR[0][1] + qx * dR[0][2] + qr * dR[1][0] -
                  2.0f * qz * dR[1][1] + qy * dR[1][2] + qx * dR[2][0] + qy * dR[2][1]);
  float dquat[4];
  norm_backward<4>(q, T.qnorm, dq, dquat);
  for (int k = 0; k < 4; ++k) d_quat[i * 4 + k] = dquat[k];

  // SH: rgb = clamp_min(C0 dc + sum_k B_k(d) sh_k + 0.5, 0), d = dirs / |dirs|
  const float* sh = sh_rest + i * S * 3;
  float dirs[3], d[3], raw[3];
  const float n = view_dir(X, cam, dirs, d);
  sh_unclamped(deg, dc + i * 3, sh, d, raw);
  float dr[3];
  for (int ch = 0; ch < 3; ++ch) {
    dr[ch] = raw[ch] >= 0.0f ? g[6 + ch] : 0.0f;
    d_dc[i * 3 + ch] = kSH_C0 * dr[ch];
  }
  const int n_active = deg >= 3 ? 15 : (deg + 1) * (deg + 1) - 1;
  float B[15], dB[15][3];
  sh_basis(d[0], d[1], d[2], B, dB);
  float d_d[3] = {0.0f, 0.0f, 0.0f};
  float* dsh = d_sh + i * S * 3;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    if (k < n_active) {
      float w = 0.0f;
      for (int ch = 0; ch < 3; ++ch) {
        dsh[k * 3 + ch] = B[k] * dr[ch];
        w += dr[ch] * sh[k * 3 + ch];
      }
      for (int a = 0; a < 3; ++a) d_d[a] += w * dB[k][a];
    }
  }
  for (int k = n_active * 3; k < S * 3; ++k) dsh[k] = 0.0f;
  float d_dirs[3];
  norm_backward<3>(dirs, n, d_d, d_dirs);
  for (int k = 0; k < 3; ++k) d_xyz[i * 3 + k] = gX[k] + d_dirs[k];
  d_opacity[i] = g[5];
}

}  // namespace

// K6. `d_attrs` is (P, 9) with row stride `d_stride` floats; S is the
// sh_rest coefficient count (>= the active degree's).
extern "C" int glic_preprocess_backward(
    const float* xyz, const float* scale, const float* quat, const float* dc,
    const float* sh_rest, const float* R_cw, const float* t_cw, const float* full_proj,
    const float* cam_center, const float* d_attrs, long long d_stride, long long P, int S,
    int deg, float W, float H, float fx, float fy, float limx_neg, float limx_pos,
    float limy_neg, float limy_pos, float* d_xyz, float* d_scale, float* d_quat,
    float* d_opacity, float* d_dc, float* d_sh, void* stream) {
  using namespace glic_pre;
  if (P == 0) return 0;
  constexpr int kThreads = 128;
  const long long blocks = (P + kThreads - 1) / kThreads;
  preprocess_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      xyz, scale, quat, dc, sh_rest, Camera{R_cw, t_cw, full_proj, cam_center},
      Intr{W, H, fx, fy, limx_neg, limx_pos, limy_neg, limy_pos}, d_attrs, d_stride, P, S,
      deg, d_xyz, d_scale, d_quat, d_opacity, d_dc, d_sh);
  return static_cast<int>(cudaGetLastError());
}
