// K6's kernel, templated on its timing variant and its input form: the
// production entry (preprocess_backward.cu, which says why the design is
// what it is) launches kK6Base, the probe entry (preprocess_probe_backward.cu)
// every variant. One source, so the probe's `base` is K6. With kRaw the
// inputs are the stored parameters (log_scale, quat, opa_logit): the kernel
// recomputes their activations as K5 does and writes the gradients of the
// stored parameters, chained through exp, the norm chain and the sigmoid.
//
// A block owns 128 consecutive Gaussians, one a thread. It copies their
// inputs into shared memory with cp.async, neighbouring threads on
// neighbouring words (16 B a thread where the slab is 16-byte aligned, a
// word where it is not: a row shard may start at any row), each thread
// computes its row from shared memory and writes its gradients over its
// inputs there, and the block stores the slabs back with neighbouring
// threads on neighbouring words. The camera's 31 floats are staged once a
// block, so no store reloads them.
//
// The variants (ops/preprocess.py K6_VARIANTS, in this order):
//   kK6Base    K6
//   kK6Direct  no staging: each thread reads its rows from device memory
//              and writes its gradients there (the first design's access
//              pattern); outputs K6's bit for bit
//   kK6NoShIo  timing only: the SH slab is neither loaded nor stored, the
//              arithmetic runs on whatever shared memory holds and d_sh is
//              not written
//   kK6NoProj  timing only: no projection recompute and no EWA backward;
//              d_xyz is the SH direction's part alone, d_scale and d_quat
//              are written as zeros
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "preprocess_common.cuh"

namespace glic_pre {
namespace {

enum K6Variant : int {
  kK6Base = 0,
  kK6Direct = 1,
  kK6NoShIo = 2,
  kK6NoProj = 3,
};

constexpr int kK6Threads = 128;     // Gaussians (threads) a block
constexpr int kK6MinBlocks = 6;     // blocks an SM's shared memory holds at S = 15
constexpr int kK6SmallFloats = 22;  // xyz 3, scale 3, quat 4, dc 3, row gradients 9
constexpr int kCamFloats = 31;      // R_cw 9, t_cw 3, full_proj 16, centre 3

// Dynamic shared memory of a staging block for S rest coefficients: the
// slabs quat | sh_rest | xyz | scale | dc | row gradients, 128 x (3 S + 22)
// floats (34,304 B at S = 15). Each slab is a multiple of 512 B, so each
// starts 16-byte aligned. A thread reads its row of sh_rest at a stride of
// 3 S words: for odd S (15, 3) the 32 lanes of a warp hit 32 banks, for
// even S gcd(3 S, 32) lanes share one.
__host__ __device__ constexpr int k6_smem_bytes(int S) {
  return kK6Threads * (3 * S + kK6SmallFloats) * 4;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats from device memory at src (4-byte aligned) into shared memory at
// dst (16-byte aligned), the block's threads on neighbouring words.
__device__ __forceinline__ void stage_in(float* dst, const float* src, int n) {
  int k = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (; k < n4; k += kK6Threads) cp_async16(dst + 4 * k, src + 4 * k);
    k = 4 * n4 + threadIdx.x;
  }
  for (; k < n; k += kK6Threads) cp_async4(dst + k, src + k);
}

// The nine row gradients of n rows `stride` floats apart, packed 9 a row.
__device__ __forceinline__ void stage_grads(float* dst, const float* src, long long stride,
                                            int n) {
  for (int k = threadIdx.x; k < 9 * n; k += kK6Threads) {
    const int r = k / 9;
    cp_async4(dst + k, src + r * stride + (k - 9 * r));
  }
}

// n floats from shared memory at src (16-byte aligned) to device memory at
// dst (4-byte aligned), the block's threads on neighbouring words.
__device__ __forceinline__ void stage_out(float* dst, const float* src, int n) {
  int k = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (; k < n4; k += kK6Threads)
      reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(src)[k];
    k = 4 * n4 + threadIdx.x;
  }
  for (; k < n; k += kK6Threads) dst[k] = src[k];
}

// d v of v / (|v| + 1e-12) for the cotangent g (0 where |v| = 0, as
// autograd's norm backward), each division one reciprocal
template <int N>
__device__ __forceinline__ void norm_backward(const float* v, float n, const float* g,
                                              float* out) {
  const float D = n + 1e-12f;
  const float inv_D = __frcp_rn(D);
  float dot = 0.0f;
  for (int k = 0; k < N; ++k) dot += g[k] * v[k];
  const float sc = n == 0.0f ? 0.0f : dot * __frcp_rn(D * D * n);
  for (int k = 0; k < N; ++k) out[k] = g[k] * inv_D - v[k] * sc;
}

// Rest basis function B_k at the unit direction (x, y, z) and its
// derivative dB_k / d(x, y, z); k is a constant once the caller's loop
// is unrolled.
__device__ __forceinline__ void sh_term(int k, float x, float y, float z, float& B,
                                        float* dB) {
  const float xx = x * x, yy = y * y, zz = z * z;
  switch (k) {
    case 0: B = -kSH_C1 * y; dB[0] = 0.0f; dB[1] = -kSH_C1; dB[2] = 0.0f; break;
    case 1: B = kSH_C1 * z; dB[0] = 0.0f; dB[1] = 0.0f; dB[2] = kSH_C1; break;
    case 2: B = -kSH_C1 * x; dB[0] = -kSH_C1; dB[1] = 0.0f; dB[2] = 0.0f; break;
    case 3:
      B = kSH_C2_0 * x * y;
      dB[0] = kSH_C2_0 * y; dB[1] = kSH_C2_0 * x; dB[2] = 0.0f;
      break;
    case 4:
      B = kSH_C2_1 * y * z;
      dB[0] = 0.0f; dB[1] = kSH_C2_1 * z; dB[2] = kSH_C2_1 * y;
      break;
    case 5:
      B = kSH_C2_2 * (2.0f * zz - xx - yy);
      dB[0] = -2.0f * kSH_C2_2 * x; dB[1] = -2.0f * kSH_C2_2 * y; dB[2] = 4.0f * kSH_C2_2 * z;
      break;
    case 6:
      B = kSH_C2_3 * x * z;
      dB[0] = kSH_C2_3 * z; dB[1] = 0.0f; dB[2] = kSH_C2_3 * x;
      break;
    case 7:
      B = kSH_C2_4 * (xx - yy);
      dB[0] = 2.0f * kSH_C2_4 * x; dB[1] = -2.0f * kSH_C2_4 * y; dB[2] = 0.0f;
      break;
    case 8:
      B = kSH_C3_0 * y * (3.0f * xx - yy);
      dB[0] = kSH_C3_0 * 6.0f * x * y; dB[1] = kSH_C3_0 * (3.0f * xx - 3.0f * yy);
      dB[2] = 0.0f;
      break;
    case 9:
      B = kSH_C3_1 * x * y * z;
      dB[0] = kSH_C3_1 * y * z; dB[1] = kSH_C3_1 * x * z; dB[2] = kSH_C3_1 * x * y;
      break;
    case 10:
      B = kSH_C3_2 * y * (4.0f * zz - xx - yy);
      dB[0] = kSH_C3_2 * -2.0f * x * y; dB[1] = kSH_C3_2 * (4.0f * zz - xx - 3.0f * yy);
      dB[2] = kSH_C3_2 * 8.0f * y * z;
      break;
    case 11:
      B = kSH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      dB[0] = kSH_C3_3 * -6.0f * x * z; dB[1] = kSH_C3_3 * -6.0f * y * z;
      dB[2] = kSH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      break;
    case 12:
      B = kSH_C3_4 * x * (4.0f * zz - xx - yy);
      dB[0] = kSH_C3_4 * (4.0f * zz - 3.0f * xx - yy); dB[1] = kSH_C3_4 * -2.0f * x * y;
      dB[2] = kSH_C3_4 * 8.0f * x * z;
      break;
    case 13:
      B = kSH_C3_5 * z * (xx - yy);
      dB[0] = kSH_C3_5 * 2.0f * x * z; dB[1] = kSH_C3_5 * -2.0f * y * z;
      dB[2] = kSH_C3_5 * (xx - yy);
      break;
    default:
      B = kSH_C3_6 * x * (xx - 3.0f * yy);
      dB[0] = kSH_C3_6 * (3.0f * xx - 3.0f * yy); dB[1] = kSH_C3_6 * -6.0f * x * y;
      dB[2] = 0.0f;
      break;
  }
}

// The SH colour's backward of one Gaussian: writes d_dc and d_sh (zero
// above the active degree) and returns d xyz through the view direction in
// d_dirs. The mask raw >= 0 comes from sh_unclamped, K5's arithmetic. sh
// and o_sh may be one row (read before written).
__device__ __forceinline__ void sh_backward(const float* X, const float* dc, const float* sh,
                                            const float* g, const Camera& cam, int S,
                                            int deg, float* o_dc, float* o_sh,
                                            float* d_dirs) {
  float dirs[3], d[3], raw[3];
  const float n = view_dir(X, cam, dirs, d);
  sh_unclamped(deg, dc, sh, d, raw);
  float dr[3];
  for (int ch = 0; ch < 3; ++ch) {
    dr[ch] = raw[ch] >= 0.0f ? g[6 + ch] : 0.0f;
    o_dc[ch] = kSH_C0 * dr[ch];
  }
  const int n_active = deg >= 3 ? 15 : (deg + 1) * (deg + 1) - 1;
  float d_d[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    if (k < n_active) {
      float B, dB[3];
      sh_term(k, d[0], d[1], d[2], B, dB);
      float w = 0.0f;
      for (int ch = 0; ch < 3; ++ch) {
        w += dr[ch] * sh[k * 3 + ch];
        o_sh[k * 3 + ch] = B * dr[ch];
      }
      for (int a = 0; a < 3; ++a) d_d[a] += w * dB[a];
    }
  }
  for (int k = n_active * 3; k < S * 3; ++k) o_sh[k] = 0.0f;
  norm_backward<3>(dirs, n, d_d, d_dirs);
}

// The projection's and EWA conic's backward of one Gaussian: writes d xyz
// (through the projection, plus d_dirs), d_scale and d_quat. The forward
// terms come from project(), K5's arithmetic, so every mask is K5's: tx/ty's
// clamp passes inside its closed bounds, the selects on tz and det != 0 pass
// where they took the computed value. The rotation, the squared scales and
// the normalised quaternion decide no mask: they are recomputed where the
// rotation's backward needs them, so they are not held through the rest.
__device__ __forceinline__ void projection_backward(const float* X, const float* s,
                                                    const float* q, const float* g,
                                                    const float* d_dirs, const Camera& cam,
                                                    const Intr& in, float* o_xyz,
                                                    float* o_scale, float* o_quat) {
  Terms T;
  project(X, s, q, cam, in, T);
  const float* Rc = cam.R;
  const float* Fp = cam.F;

  // pixel mean: xy = ((ph * inv_w + 1) * S - 1) / 2
  const float ax = g[0] * (0.5f * in.W);
  const float ay = g[1] * (0.5f * in.H);
  const float d_phx = ax * T.inv_w;
  const float d_phy = ay * T.inv_w;
  const float d_pw = -(ax * T.phx + ay * T.phy) * T.inv_w * T.inv_w;
  float gX[3];
  for (int k = 0; k < 3; ++k)
    gX[k] = d_dirs[k] + d_phx * Fp[k] + d_phy * Fp[4 + k] + d_pw * Fp[12 + k];

  // conic = (c, -b, a) / det, det = a c - b^2 where det != 0
  const float gA = g[2], gB = g[3], gC = g[4];
  const float d_inv_det = gA * T.c - gB * T.b + gC * T.a;
  const float d_det = T.det_valid ? -d_inv_det * T.inv_det * T.inv_det : 0.0f;
  const float d_a = gC * T.inv_det + d_det * T.c;
  const float d_c = gA * T.inv_det + d_det * T.a;
  const float d_b = -gB * T.inv_det - 2.0f * T.b * d_det;

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
                     (d_rx * T.rx + d_ry * T.ry) * T.inv_tz;
  const float d_pvx = d_rx * T.inv_tz;
  const float d_pvy = d_ry * T.inv_tz;
  const float d_depth = T.tz_kept ? d_tz : 0.0f;
  for (int k = 0; k < 3; ++k)
    o_xyz[k] = gX[k] + d_pvx * Rc[k] + d_pvy * Rc[3 + k] + d_depth * Rc[6 + k];

  // S_ij = sum_k s_k^2 R_ik R_jk, R of the normalised quaternion (r, x, y, z)
  const float inv_n = __frcp_rn(T.qnorm + 1e-12f);
  const float qr = q[0] * inv_n, qx = q[1] * inv_n, qy = q[2] * inv_n, qz = q[3] * inv_n;
  const float R[3][3] = {
      {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qr * qz), 2.0f * (qx * qz + qr * qy)},
      {2.0f * (qx * qy + qr * qz), 1.0f - 2.0f * (qx * qx + qz * qz), 2.0f * (qy * qz - qr * qx)},
      {2.0f * (qx * qz - qr * qy), 2.0f * (qy * qz + qr * qx), 1.0f - 2.0f * (qx * qx + qy * qy)}};
  float dR[3][3];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) {
      const float M0 = a == 0 ? 2.0f * dS[0][0] : dS[a][0];
      const float M1 = a == 1 ? 2.0f * dS[1][1] : dS[a][1];
      const float M2 = a == 2 ? 2.0f * dS[2][2] : dS[a][2];
      dR[a][k] = s[k] * s[k] * (M0 * R[0][k] + M1 * R[1][k] + M2 * R[2][k]);
    }
  for (int k = 0; k < 3; ++k) {
    const float d_sig = dS[0][0] * R[0][k] * R[0][k] + dS[1][1] * R[1][k] * R[1][k] +
                        dS[2][2] * R[2][k] * R[2][k] + dS[0][1] * R[0][k] * R[1][k] +
                        dS[0][2] * R[0][k] * R[2][k] + dS[1][2] * R[1][k] * R[2][k];
    o_scale[k] = 2.0f * s[k] * d_sig;
  }
  float dq[4];
  dq[0] = 2.0f * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0] - qx * dR[1][2] -
                  qy * dR[2][0] + qx * dR[2][1]);
  dq[1] = 2.0f * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0] - 2.0f * qx * dR[1][1] -
                  qr * dR[1][2] + qz * dR[2][0] + qr * dR[2][1] - 2.0f * qx * dR[2][2]);
  dq[2] = 2.0f * (-2.0f * qy * dR[0][0] + qx * dR[0][1] + qr * dR[0][2] + qx * dR[1][0] +
                  qz * dR[1][2] - qr * dR[2][0] + qz * dR[2][1] - 2.0f * qy * dR[2][2]);
  dq[3] = 2.0f * (-2.0f * qz * dR[0][0] - qr * dR[0][1] + qx * dR[0][2] + qr * dR[1][0] -
                  2.0f * qz * dR[1][1] + qy * dR[1][2] + qx * dR[2][0] + qy * dR[2][1]);
  norm_backward<4>(q, T.qnorm, dq, o_quat);
}

// One Gaussian's six gradients. The inputs may be rows of shared memory and
// the outputs the same rows (each input is read before its row is written).
// With kRaw, scale and quat are log_scale and quat as stored and opa_logit
// the stored opacity logit (unread otherwise).
template <int V, bool kRaw>
__device__ __forceinline__ void k6_row(const float* xyz, const float* scale, const float* quat,
                                       const float* opa_logit, const float* dc, const float* sh,
                                       const float* g, const Camera& cam, const Intr& in, int S,
                                       int deg, float* o_xyz, float* o_scale, float* o_quat,
                                       float* o_opacity, float* o_dc, float* o_sh) {
  const float X[3] = {xyz[0], xyz[1], xyz[2]};
  float d_dirs[3];
  sh_backward(X, dc, sh, g, cam, S, deg, o_dc, o_sh, d_dirs);
  float s[3] = {scale[0], scale[1], scale[2]};
  float q[4] = {quat[0], quat[1], quat[2], quat[3]};
  // the stored quaternion, for the first normalisation's backward (o_quat
  // may be the row quat was read from)
  const float stored[4] = {q[0], q[1], q[2], q[3]};
  float opa = 0.0f, n0 = 0.0f;
  if constexpr (kRaw) {
    opa = *opa_logit;
    n0 = activate(s, q, opa);   // K5's activations, recomputed
    // CUDA's sigmoid_backward(grad, result): grad (1 - result) result
    *o_opacity = mul(mul(g[5], sub(1.0f, opa)), opa);
  } else {
    *o_opacity = g[5];
  }
  if constexpr (V == kK6NoProj) {
    for (int k = 0; k < 3; ++k) o_xyz[k] = d_dirs[k];
    for (int k = 0; k < 3; ++k) o_scale[k] = 0.0f;
    for (int k = 0; k < 4; ++k) o_quat[k] = 0.0f;
  } else {
    const float gp[5] = {g[0], g[1], g[2], g[3], g[4]};
    if constexpr (kRaw) {
      // exp's backward (d s times s) and the first normalisation's (the
      // projection's own is the second)
      float d_s[3], d_q[4];
      projection_backward(X, s, q, gp, d_dirs, cam, in, o_xyz, d_s, d_q);
      for (int k = 0; k < 3; ++k) o_scale[k] = mul(d_s[k], s[k]);
      norm_backward<4>(stored, n0, d_q, o_quat);
    } else {
      projection_backward(X, s, q, gp, d_dirs, cam, in, o_xyz, o_scale, o_quat);
    }
  }
}

template <int V, bool kRaw>
__global__ void __launch_bounds__(kK6Threads, kK6MinBlocks) preprocess_backward_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scale,
    const float* __restrict__ quat, const float* __restrict__ opa_logit,
    const float* __restrict__ dc,
    const float* __restrict__ sh_rest, Camera cam_g, Intr in,
    const float* __restrict__ d_attrs, long long d_stride, long long P, int S, int deg,
    float* __restrict__ d_xyz, float* __restrict__ d_scale, float* __restrict__ d_quat,
    float* __restrict__ d_opacity, float* __restrict__ d_dc, float* __restrict__ d_sh) {
  __shared__ float cam_s[kCamFloats];
  extern __shared__ __align__(16) float slab[];
  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kK6Threads;
  const int nb = static_cast<int>(P - row0 < kK6Threads ? P - row0 : kK6Threads);
  const int W = 3 * S;
  if (t < kCamFloats)
    cam_s[t] = t < 9 ? cam_g.R[t] : t < 12 ? cam_g.t[t - 9] : t < 28 ? cam_g.F[t - 12]
                                                                     : cam_g.c[t - 28];
  const Camera cam{cam_s, cam_s + 9, cam_s + 12, cam_s + 28};
  float* s_quat = slab;
  float* s_sh = s_quat + 4 * kK6Threads;
  float* s_xyz = s_sh + W * kK6Threads;
  float* s_scale = s_xyz + 3 * kK6Threads;
  float* s_dc = s_scale + 3 * kK6Threads;
  float* s_g = s_dc + 3 * kK6Threads;
  if constexpr (V != kK6Direct) {
    stage_in(s_quat, quat + row0 * 4, nb * 4);
    if constexpr (V != kK6NoShIo) stage_in(s_sh, sh_rest + row0 * W, nb * W);
    stage_in(s_xyz, xyz + row0 * 3, nb * 3);
    stage_in(s_scale, scale + row0 * 3, nb * 3);
    stage_in(s_dc, dc + row0 * 3, nb * 3);
    stage_grads(s_g, d_attrs + row0 * d_stride, d_stride, nb);
    cp_async_wait_all();
  }
  __syncthreads();

  if (t < nb) {
    const long long i = row0 + t;
    if constexpr (V == kK6Direct) {
      k6_row<V, kRaw>(xyz + i * 3, scale + i * 3, quat + i * 4, opa_logit + i, dc + i * 3,
                      sh_rest + i * W, d_attrs + i * d_stride, cam, in, S, deg, d_xyz + i * 3,
                      d_scale + i * 3, d_quat + i * 4, d_opacity + i, d_dc + i * 3,
                      d_sh + i * W);
    } else {
      // the opacity logit and its gradient are one word a thread: read and
      // written in place, neighbouring threads on neighbouring words
      k6_row<V, kRaw>(s_xyz + 3 * t, s_scale + 3 * t, s_quat + 4 * t, opa_logit + i,
                      s_dc + 3 * t, s_sh + W * t, s_g + 9 * t, cam, in, S, deg, s_xyz + 3 * t,
                      s_scale + 3 * t, s_quat + 4 * t, d_opacity + i, s_dc + 3 * t,
                      s_sh + W * t);
    }
  }

  if constexpr (V != kK6Direct) {
    __syncthreads();
    stage_out(d_quat + row0 * 4, s_quat, nb * 4);
    if constexpr (V != kK6NoShIo) stage_out(d_sh + row0 * W, s_sh, nb * W);
    stage_out(d_xyz + row0 * 3, s_xyz, nb * 3);
    stage_out(d_scale + row0 * 3, s_scale, nb * 3);
    stage_out(d_dc + row0 * 3, s_dc, nb * 3);
  }
}

// opa_logit is read with kRaw only (it may be null otherwise).
template <int V, bool kRaw>
cudaError_t launch_preprocess_backward(
    const float* xyz, const float* scale, const float* quat, const float* opa_logit,
    const float* dc,
    const float* sh_rest, const float* R_cw, const float* t_cw, const float* full_proj,
    const float* cam_center, const float* d_attrs, long long d_stride, long long P, int S,
    int deg, float W, float H, float fx, float fy, float limx_neg, float limx_pos,
    float limy_neg, float limy_pos, float* d_xyz, float* d_scale, float* d_quat,
    float* d_opacity, float* d_dc, float* d_sh, cudaStream_t stream) {
  if (P == 0) return cudaSuccess;
  const int smem = V == kK6Direct ? 0 : k6_smem_bytes(S);
  if (smem > 48 * 1024) {   // only past S = 24: the opt-in above the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        preprocess_backward_kernel<V, kRaw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (P + kK6Threads - 1) / kK6Threads;
  preprocess_backward_kernel<V, kRaw>
      <<<static_cast<unsigned>(blocks), kK6Threads, smem, stream>>>(
      xyz, scale, quat, opa_logit, dc, sh_rest, Camera{R_cw, t_cw, full_proj, cam_center},
      Intr{W, H, fx, fy, limx_neg, limx_pos, limy_neg, limy_pos}, d_attrs, d_stride, P, S,
      deg, d_xyz, d_scale, d_quat, d_opacity, d_dc, d_sh);
  return cudaGetLastError();
}

}  // namespace
}  // namespace glic_pre
