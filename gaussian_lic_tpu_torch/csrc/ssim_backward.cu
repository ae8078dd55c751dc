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
// What bounds it on this card: memory, then operations. Per pixel it
// does ~134 separate FP32 multiplies and adds (3 maps x 11 taps x 2 passes
// x 2, the combination) and moves 24 bytes (x, y, three partial maps, d):
// at 3 x 512 x 640, ~3.9 us of FP32 lanes and ~7.0 us of device memory.
// Every shared load and address instruction comes on top of those
// operations in the SM's issue slots. The design stages the three maps of a
// 64 x 16 tile once with their apron by 16-byte cp.async copies (all of a
// thread's in flight at once), keeps a vertical segment's running sums in
// registers,
// reads the horizontal taps 16 bytes at a time, 4 outputs a thread, and
// reads x and y and writes d 16 bytes at a time: ssim_backward.cuh holds
// it, with the first design (33 shared loads a pixel) among its timing
// variants (ssim_backward_probe.cu); this entry launches its base
// instantiation.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstring>

#include "ssim_backward.cuh"

// K12: d (C, H, W) for x and y (C, H, W), K11's partial maps (3, C, r1 - r0,
// W) of the window [r0, r1), and grad (2,), the gradients of K11's two sums,
// on the device. konst: 13 host floats, the 11 taps, C1 and C2.
extern "C" int glic_ssim_backward(const float* x, long long x_cs, long long x_rs, const float* y,
                                  long long y_cs, long long y_rs, int C, int H, int W, int r0,
                                  int r1, const float* konst, const float* partials,
                                  const float* grad, float* d, void* stream) {
  using namespace glic_k12;
  if (C < 1 || C > 65535 || H < 1 || W < 1 || r0 < 0 || r1 <= r0 || r1 > H || !konst)
    return static_cast<int>(cudaErrorInvalidValue);
  Konst k;
  std::memcpy(&k, konst, sizeof(Konst));
  const Args a{x, x_cs, x_rs, y, y_cs, y_rs, C, H, W, r0, r1, partials, grad, d, false};
  return static_cast<int>(
      launch_ssim_backward<kK12Base>(a, k, static_cast<cudaStream_t>(stream)));
}
