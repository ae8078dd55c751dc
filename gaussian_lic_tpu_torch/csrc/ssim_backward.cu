// K12: the training loss's backward, d loss / d img of SSIM and L1 over a
// window of rows, hand-written for Hopper (sm_90a).
//
// Replaces the autodiff of the program XLA fuses on the TPU from the JAX
// package's gaussian_lic_tpu/ops/losses.py:91-130 (`training_loss`,
// `training_loss_band_part`). In PyTorch that was autograd's ~100
// image-sized launches a step: the slice, pad and add backward of every
// shifted multiply-add of the five blurs.
//
// With g = (g_m, g_d), the incoming gradients of K11's two sums (read on the
// device: no host sync, so a CUDA graph captures it), w = 1 on the window's
// rows [r0, r1) and 0 elsewhere, and K11's partial maps P1 = dm/dmu1, P2 =
// dm/dsigma1^2, P3 = dm/dsigma12 (zero outside the window), it writes for
// every row of the (C, H, W) image, the halo rows of a band included,
//
//   d = g_m (blur(P1) + 2 x blur(P2) + y blur(P3)) + g_d sgn(x - y) w
//
// where blur is the same zero-padded separable blur as the forward's: its
// taps are symmetric, so the blur is its own adjoint. sgn is 0 at x == y,
// as autograd's abs backward. Every operation is rounded on its own in the
// order of ops/losses.py `ssim_backward_plain`, which it equals on the card
// (up to the sign of a zero).
//
// What bounds it on this card: operations and memory alike. Per pixel it
// does ~140 separate FP32 multiplies and adds (3 maps x 11 taps x 2 passes x
// 2, the combination) and moves 24 bytes (x, y, three partial maps, d): at
// 3 x 512 x 640, ~4.1 us of FP32 lanes and ~7.0 us of device memory. The
// design is K11's (csrc/ssim_common.cuh): the three maps staged once with
// their apron, the vertical segments in registers, the horizontal taps
// conflict-free, x and y read coalesced in the epilogue.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstring>

#include "ssim_common.cuh"

namespace glic_ssim {

constexpr int kMaps = 3;

__global__ void __launch_bounds__(kThreads, 4) ssim_backward_kernel(
    const float* __restrict__ x, long long x_cs, long long x_rs, const float* __restrict__ y,
    long long y_cs, long long y_rs, int H, int W, int r0, int r1, Konst k,
    const float* __restrict__ partials, const float* __restrict__ grad,
    float* __restrict__ d) {
  __shared__ float ps[kMaps][kSpan][kSpan];
  __shared__ float vs[kMaps][kTile][kSpan];
  const int c = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const long long plane = static_cast<long long>(r1 - r0) * W;
  const long long stride = plane * gridDim.z;
  const float* pc = partials + c * plane;
  for (int i = tid; i < kSpan * kSpan; i += kThreads) {
    const int r = i / kSpan, q = i - r * kSpan;
    const int gr = row0 - kR + r, gc = col0 - kR + q;
    const bool in = gr >= r0 && gr < r1 && gc >= 0 && gc < W;
    const long long o = static_cast<long long>(gr - r0) * W + gc;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) ps[m][r][q] = in ? __ldg(pc + m * stride + o) : 0.f;
  }
  __syncthreads();

  for (int s = tid; s < kSegments; s += kThreads) {
    const int g = s / kSpan, q = s - g * kSpan;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
      float p[kSeg];
#pragma unroll
      for (int i = 0; i < kSeg; ++i) p[i] = ps[m][g * kPerThread + i][q];
      vertical(p, &vs[m][g * kPerThread][q], k);
    }
  }
  __syncthreads();

  const float g_m = __ldg(grad), g_d = __ldg(grad + 1);
  const int tx = threadIdx.x;
  const int gc = col0 + tx;
  if (gc >= W) return;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int lr = threadIdx.y * kPerThread + j;
    const int gr = row0 + lr;
    if (gr >= H) break;
    const float b1 = blur11(&vs[0][lr][tx], 1, k);
    const float b2 = blur11(&vs[1][lr][tx], 1, k);
    const float b3 = blur11(&vs[2][lr][tx], 1, k);
    const float xv = __ldg(x + c * x_cs + gr * x_rs + gc);
    const float yv = __ldg(y + c * y_cs + gr * y_rs + gc);
    const float inner = __fadd_rn(__fadd_rn(b1, __fmul_rn(__fmul_rn(2.f, xv), b2)),
                                  __fmul_rn(yv, b3));
    const float sgn = static_cast<float>((xv > yv) - (xv < yv));
    const float l1 = gr >= r0 && gr < r1 ? __fmul_rn(g_d, sgn) : 0.f;
    d[(static_cast<long long>(c) * H + gr) * W + gc] = __fadd_rn(__fmul_rn(g_m, inner), l1);
  }
}

}  // namespace glic_ssim

// K12: d (C, H, W) for x and y (C, H, W), K11's partial maps (3, C, r1 - r0,
// W) of the window [r0, r1), and grad (2,), the gradients of K11's two sums,
// on the device. konst: 13 host floats, the 11 taps, C1 and C2.
extern "C" int glic_ssim_backward(const float* x, long long x_cs, long long x_rs, const float* y,
                                  long long y_cs, long long y_rs, int C, int H, int W, int r0,
                                  int r1, const float* konst, const float* partials,
                                  const float* grad, float* d, void* stream) {
  using namespace glic_ssim;
  if (C < 1 || C > 65535 || H < 1 || W < 1 || r0 < 0 || r1 <= r0 || r1 > H || !konst)
    return static_cast<int>(cudaErrorInvalidValue);
  Konst k;
  std::memcpy(&k, konst, sizeof(Konst));
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, C);
  ssim_backward_kernel<<<grid, dim3(kTile, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_cs, x_rs, y, y_cs, y_rs, H, W, r0, r1, k, partials, grad, d);
  return static_cast<int>(cudaGetLastError());
}
