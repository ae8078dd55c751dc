// K11: the training loss's forward, SSIM and L1 over a window of rows,
// hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/ops/losses.py:45-97 (`_blur`, `ssim_map`, `ssim`, and the
// L1 of `training_loss`) and :103-130 (`training_loss_band_part`). In
// PyTorch that was ~60 image-sized launches a step: five separable blurs of
// 2 x 11 shifted multiply-adds, the map's arithmetic and two reductions.
//
// For the rows [r0, r1) of a (C, H, W) float32 image `x` and its target `y`
// (each with its own channel and row stride, unit column stride) it writes,
// per block, the sums of the SSIM map and of |x - y| over its pixels, and,
// with `partials`, the three partial maps of SURVEY C14 that K12 blurs back:
// dm/dmu1 (with blur(x^2) and blur(xy) held, so it carries the -2 mu1 dm/ds1
// and -mu2 dm/ds12 terms), dm/dsigma1^2 and dm/dsigma12, each (C, r1 - r0, W)
// at partials[q]. The map and the partial maps are bit for bit the plain
// chain's on the card (ops/losses.py `ssim_forward_plain`: one rounded
// operation each, in its order; csrc/ssim_common.cuh). The blocks' sums are
// reduced by the wrapper in a fixed order (no float atomics: the loss is the
// same from run to run and between eager steps and graph replays).
//
// What bounds it on this card: operations. Per window pixel it does ~270
// separate FP32 multiplies and adds (5 quantities x 11 taps x 2 passes x 2,
// the map, the partial maps, four IEEE divisions) and moves 20 bytes (two
// reads, three partial-map writes): at 3 x 512 x 640, ~7.9 us of FP32 lanes
// against ~5.9 us of device memory. Every shared load and address
// instruction comes on top of those operations in the SM's issue slots. The
// design stages each input once in shared memory (the apron costs about
// (42 / 32)^2 of the reads, from L2), keeps a vertical segment's running
// sums in registers and reads the horizontal taps 16 bytes at a time, 4
// outputs a thread: ssim_forward.cuh holds it, with the first design (55
// shared loads a pixel) among its timing variants (ssim_forward_probe.cu);
// this entry launches its base instantiation.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstring>

#include "ssim_forward.cuh"

// K11 over rows [r0, r1) of x and y (C, H, W): block_sums (n_blocks + 1, 2)
// of (sum of the map, sum of |x - y|), each block's and, in row n_blocks,
// their total, n_blocks = C * ceil((r1 - r0) / tile_h) * ceil(W / tile_w)
// for the base geometry (kK11Shapes[kK11Base]); with `partials` (3, C, r1 -
// r0, W) not null, the partial maps. konst: 13 host floats, the 11 taps, C1
// and C2.
extern "C" int glic_ssim_forward(const float* x, long long x_cs, long long x_rs, const float* y,
                                 long long y_cs, long long y_rs, int C, int H, int W, int r0,
                                 int r1, const float* konst, float* partials, float* block_sums,
                                 void* stream) {
  using namespace glic_ssim;
  if (C < 1 || C > 65535 || H < 1 || W < 1 || r0 < 0 || r1 <= r0 || r1 > H || !konst)
    return static_cast<int>(cudaErrorInvalidValue);
  Konst k;
  std::memcpy(&k, konst, sizeof(Konst));
  const Images im{x, x_cs, x_rs, y, y_cs, y_rs, H, W, r0, r1};
  return static_cast<int>(launch_ssim_forward<kK11Base>(im, C, k, partials, block_sums,
                                                         static_cast<cudaStream_t>(stream)));
}
