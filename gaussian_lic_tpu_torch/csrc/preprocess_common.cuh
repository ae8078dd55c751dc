// The per-Gaussian forward terms shared by K5 (preprocess_forward.cu) and K6
// (preprocess_backward.cu): projection, EWA conic, radius and SH colour,
// each float operation of the plain chain (gaussian_lic_tpu_torch/ops/
// projection.py:projection_terms, ops/sh.py:sh_color_unclamped) in its order
// and rounded once, as PyTorch's one-op-at-a-time kernels round it: the
// *_rn intrinsics keep nvcc from contracting a product and a sum into one
// FMA. Python scalars enter as PyTorch passes them to a float32 kernel,
// rounded to float. The two norms (of the quaternion and of the view
// direction) follow the order of PyTorch's CUDA reduction (normalize).

#pragma once

#include <cuda_runtime.h>

namespace glic_pre {

constexpr float kFrustumNear = 0.2f;        // ops/projection.py FRUSTUM_NEAR
constexpr float kDilation = 0.3f;           // COV2D_DILATION
constexpr float kOpacityThreshold = static_cast<float>(1.0 / 255.0);
constexpr float kSH_C0 = static_cast<float>(0.28209479177387814);
constexpr float kSH_C1 = static_cast<float>(0.4886025119029199);
constexpr float kSH_C2_0 = static_cast<float>(1.0925484305920792);
constexpr float kSH_C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kSH_C2_2 = static_cast<float>(0.31539156525252005);
constexpr float kSH_C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kSH_C2_4 = static_cast<float>(0.5462742152960396);
constexpr float kSH_C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kSH_C3_1 = static_cast<float>(2.890611442640554);
constexpr float kSH_C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kSH_C3_3 = static_cast<float>(0.3731763325901154);
constexpr float kSH_C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kSH_C3_5 = static_cast<float>(1.445305721320277);
constexpr float kSH_C3_6 = static_cast<float>(-0.5900435899266435);

// The camera as the kernels read it: device pointers (a CUDA graph's step
// indexes its keyframe on the device) and the intrinsics' static floats.
struct Camera {
  const float* R;  // R_cw (3, 3) row-major
  const float* t;  // t_cw (3,)
  const float* F;  // full_proj (4, 4) row-major
  const float* c;  // camera centre (3,)
};

struct Intr {
  float W, H, fx, fy, limx_neg, limx_pos, limy_neg, limy_pos;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp / clamp_min: a NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// x M[row, 0] + y M[row, 1] + z M[row, 2] + t (ops/projection.py:_affine3)
__device__ __forceinline__ float affine3(float x, float y, float z, const float* M,
                                         float t) {
  return add(add(add(mul(x, M[0]), mul(y, M[1])), mul(z, M[2])), t);
}
// v / (|v| + 1e-12) of a 3- or 4-vector; returns |v|. The sum of squares
// in the order of PyTorch's CUDA reduction (torch.linalg.norm over a last
// dim of 3 or 4 sums the even and the odd elements apart, then the two:
// (v0^2 + v2^2) + (v1^2 + v3^2); it agreed bit for bit on every row of 1M
// quaternions and view directions on the H100), so K5's norms are its.
template <int N>
__device__ __forceinline__ float normalize(const float* v, float* out) {
  static_assert(N == 3 || N == 4, "a 3- or 4-vector");
  const float even = add(mul(v[0], v[0]), mul(v[2], v[2]));
  const float s = add(even, N == 4 ? add(mul(v[1], v[1]), mul(v[3], v[3])) : mul(v[1], v[1]));
  const float n = __fsqrt_rn(s);
  const float d = add(n, 1e-12f);
  for (int k = 0; k < N; ++k) out[k] = fdiv(v[k], d);
  return n;
}

// torch.sigmoid on CUDA, as PyTorch's kernel computes it: 1 / (1 + exp(-x)),
// its exp CUDA's expf (torch.exp's; NaN and +-inf pass as they do there)
__device__ __forceinline__ float sigmoid(float x) { return fdiv(1.0f, add(1.0f, expf(-x))); }

// GaussianMap's activations (models/gaussians.py: scaling = exp(log_scale),
// rotation = q / (|q| + 1e-12), opacity = sigmoid(opa_logit)), in place on
// the stored parameters of one Gaussian, each as CUDA's torch.exp, the norm
// chain and torch.sigmoid compute it; returns |q| of the stored quaternion.
// The projection then normalises the rotation once more, as the JAX package
// does (ops/projection.py:138).
__device__ __forceinline__ float activate(float* s, float* q, float& opa) {
  for (int k = 0; k < 3; ++k) s[k] = expf(s[k]);
  const float stored[4] = {q[0], q[1], q[2], q[3]};
  opa = sigmoid(opa);
  return normalize<4>(stored, q);
}

// Every forward term the backward reads (ops/projection.py's names).
struct Terms {
  float pvx, pvy, depth, phx, phy, pw, inv_w, xy[2];
  bool tz_kept;
  float tz, rx, ry, cx, cy, tx, ty, inv_tz, inv_tz2;
  float m0[3], m1[3];
  float qnorm, q[4];  // |quat| and the normalised (r, x, y, z)
  float R[3][3], sig[3];
  float S00, S01, S02, S11, S12, S22;
  float t[3], u[3];
  float a, b, c, det, inv_det, conic[3];
  bool det_valid, in_front;
  float radius;       // ceil'd, 0 unless in front with det != 0
};

__device__ __forceinline__ void project(const float* X, const float* s, const float* quat,
                                        const Camera& cam, const Intr& in, Terms& T) {
  const float* R = cam.R;
  const float* F = cam.F;
  T.pvx = affine3(X[0], X[1], X[2], R + 0, cam.t[0]);
  T.pvy = affine3(X[0], X[1], X[2], R + 3, cam.t[1]);
  T.depth = affine3(X[0], X[1], X[2], R + 6, cam.t[2]);
  T.in_front = T.depth > kFrustumNear;

  T.phx = affine3(X[0], X[1], X[2], F + 0, F[3]);
  T.phy = affine3(X[0], X[1], X[2], F + 4, F[7]);
  T.pw = affine3(X[0], X[1], X[2], F + 12, F[15]);
  T.inv_w = fdiv(1.0f, add(T.pw, 1e-7f));
  T.xy[0] = mul(sub(mul(add(mul(T.phx, T.inv_w), 1.0f), in.W), 1.0f), 0.5f);
  T.xy[1] = mul(sub(mul(add(mul(T.phy, T.inv_w), 1.0f), in.H), 1.0f), 0.5f);

  T.tz_kept = fabsf(T.depth) > 1e-8f;
  T.tz = T.tz_kept ? T.depth : 1e-8f;
  T.rx = fdiv(T.pvx, T.tz);
  T.ry = fdiv(T.pvy, T.tz);
  T.cx = clamp(T.rx, in.limx_neg, in.limx_pos);
  T.cy = clamp(T.ry, in.limy_neg, in.limy_pos);
  T.tx = mul(T.cx, T.tz);
  T.ty = mul(T.cy, T.tz);

  T.inv_tz = fdiv(1.0f, T.tz);
  T.inv_tz2 = mul(T.inv_tz, T.inv_tz);
  const float J00 = mul(in.fx, T.inv_tz);
  const float J11 = mul(in.fy, T.inv_tz);
  const float J02 = mul(mul(-in.fx, T.tx), T.inv_tz2);
  const float J12 = mul(mul(-in.fy, T.ty), T.inv_tz2);
  for (int j = 0; j < 3; ++j) {
    T.m0[j] = add(mul(J00, R[j]), mul(J02, R[6 + j]));
    T.m1[j] = add(mul(J11, R[3 + j]), mul(J12, R[6 + j]));
  }

  T.qnorm = normalize<4>(quat, T.q);
  const float qr = T.q[0], qx = T.q[1], qy = T.q[2], qz = T.q[3];
  T.R[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  T.R[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qr, qz)));
  T.R[0][2] = mul(2.0f, add(mul(qx, qz), mul(qr, qy)));
  T.R[1][0] = mul(2.0f, add(mul(qx, qy), mul(qr, qz)));
  T.R[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  T.R[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qr, qx)));
  T.R[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qr, qy)));
  T.R[2][1] = mul(2.0f, add(mul(qy, qz), mul(qr, qx)));
  T.R[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  for (int k = 0; k < 3; ++k) T.sig[k] = mul(s[k], s[k]);
  // S_ij = s0 R_i0 R_j0 + s1 R_i1 R_j1 + s2 R_i2 R_j2, left to right
  auto S = [&](int i, int j) {
    float acc = mul(mul(T.sig[0], T.R[i][0]), T.R[j][0]);
    acc = add(acc, mul(mul(T.sig[1], T.R[i][1]), T.R[j][1]));
    return add(acc, mul(mul(T.sig[2], T.R[i][2]), T.R[j][2]));
  };
  T.S00 = S(0, 0);
  T.S01 = S(0, 1);
  T.S02 = S(0, 2);
  T.S11 = S(1, 1);
  T.S12 = S(1, 2);
  T.S22 = S(2, 2);
  const float* m0 = T.m0;
  const float* m1 = T.m1;
  T.t[0] = add(add(mul(T.S00, m0[0]), mul(T.S01, m0[1])), mul(T.S02, m0[2]));
  T.t[1] = add(add(mul(T.S01, m0[0]), mul(T.S11, m0[1])), mul(T.S12, m0[2]));
  T.t[2] = add(add(mul(T.S02, m0[0]), mul(T.S12, m0[1])), mul(T.S22, m0[2]));
  T.a = add(add(add(mul(m0[0], T.t[0]), mul(m0[1], T.t[1])), mul(m0[2], T.t[2])), kDilation);
  T.b = add(add(mul(m1[0], T.t[0]), mul(m1[1], T.t[1])), mul(m1[2], T.t[2]));
  T.u[0] = add(add(mul(T.S00, m1[0]), mul(T.S01, m1[1])), mul(T.S02, m1[2]));
  T.u[1] = add(add(mul(T.S01, m1[0]), mul(T.S11, m1[1])), mul(T.S12, m1[2]));
  T.u[2] = add(add(mul(T.S02, m1[0]), mul(T.S12, m1[1])), mul(T.S22, m1[2]));
  T.c = add(add(add(mul(m1[0], T.u[0]), mul(m1[1], T.u[1])), mul(m1[2], T.u[2])), kDilation);

  T.det = sub(mul(T.a, T.c), mul(T.b, T.b));
  T.det_valid = T.det != 0.0f;
  T.inv_det = fdiv(1.0f, T.det_valid ? T.det : 1.0f);
  T.conic[0] = mul(T.c, T.inv_det);
  T.conic[1] = mul(-T.b, T.inv_det);
  T.conic[2] = mul(T.a, T.inv_det);

  const float mid = mul(0.5f, add(T.a, T.c));
  const float lambda1 = add(mid, __fsqrt_rn(clamp_min(sub(mul(mid, mid), T.det), 0.1f)));
  const float r = ceilf(mul(3.0f, __fsqrt_rn(clamp_min(lambda1, 0.0f))));
  T.radius = (T.in_front && T.det_valid) ? r : 0.0f;
}

// eval_sh_color before its clamp at 0 (ops/sh.py:sh_color_unclamped) of
// one Gaussian: dc (3,), sh (S, 3), unit direction d; raw (3,).
__device__ __forceinline__ void sh_unclamped(int deg, const float* dc, const float* sh,
                                             const float* d, float* raw) {
  const float x = d[0], y = d[1], z = d[2];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
  // the (P, 1) factors of each term, as the plain chain forms them
  const float b0 = mul(kSH_C1, y), b1 = mul(kSH_C1, z), b2 = mul(kSH_C1, x);
  const float b3 = mul(kSH_C2_0, xy), b4 = mul(kSH_C2_1, yz);
  const float b5 = mul(kSH_C2_2, sub(sub(mul(2.0f, zz), xx), yy));
  const float b6 = mul(kSH_C2_3, xz), b7 = mul(kSH_C2_4, sub(xx, yy));
  const float b8 = mul(mul(kSH_C3_0, y), sub(mul(3.0f, xx), yy));
  const float b9 = mul(mul(kSH_C3_1, xy), z);
  const float four_zz_xx_yy = sub(sub(mul(4.0f, zz), xx), yy);
  const float b10 = mul(mul(kSH_C3_2, y), four_zz_xx_yy);
  const float b11 = mul(mul(kSH_C3_3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
  const float b12 = mul(mul(kSH_C3_4, x), four_zz_xx_yy);
  const float b13 = mul(mul(kSH_C3_5, z), sub(xx, yy));
  const float b14 = mul(mul(kSH_C3_6, x), sub(xx, mul(3.0f, yy)));
  for (int ch = 0; ch < 3; ++ch) {
    float r = mul(kSH_C0, dc[ch]);
    if (deg > 0) {
      r = sub(r, mul(b0, sh[0 * 3 + ch]));
      r = add(r, mul(b1, sh[1 * 3 + ch]));
      r = sub(r, mul(b2, sh[2 * 3 + ch]));
      if (deg > 1) {
        r = add(r, mul(b3, sh[3 * 3 + ch]));
        r = add(r, mul(b4, sh[4 * 3 + ch]));
        r = add(r, mul(b5, sh[5 * 3 + ch]));
        r = add(r, mul(b6, sh[6 * 3 + ch]));
        r = add(r, mul(b7, sh[7 * 3 + ch]));
        if (deg > 2) {
          r = add(r, mul(b8, sh[8 * 3 + ch]));
          r = add(r, mul(b9, sh[9 * 3 + ch]));
          r = add(r, mul(b10, sh[10 * 3 + ch]));
          r = add(r, mul(b11, sh[11 * 3 + ch]));
          r = add(r, mul(b12, sh[12 * 3 + ch]));
          r = add(r, mul(b13, sh[13 * 3 + ch]));
          r = add(r, mul(b14, sh[14 * 3 + ch]));
        }
      }
    }
    raw[ch] = add(r, 0.5f);
  }
}

// The unit view direction of Gaussian mean X; returns |X - c|.
__device__ __forceinline__ float view_dir(const float* X, const Camera& cam, float* dirs,
                                          float* d) {
  for (int k = 0; k < 3; ++k) dirs[k] = sub(X[k], cam.c[k]);
  return normalize<3>(dirs, d);
}

}  // namespace glic_pre
