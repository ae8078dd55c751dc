// What K11 (csrc/ssim_forward.cu) and K12 (csrc/ssim_backward.cu) share: the
// tile geometry, the constants, and the separable 11-tap blur in the plain
// chain's order (gaussian_lic_tpu_torch/ops/losses.py `_blur`).
//
// A block owns a kTile x kTile tile of one channel's output pixels. It stages
// its inputs with a kR-pixel apron in shared memory (zeros outside the image,
// and outside the loss's window rows for K12's partial maps: `_blur`'s zero
// "same" padding), runs the vertical pass into shared memory (one thread a
// column segment of kPerThread rows, its kSeg inputs in registers), then the
// horizontal pass (one thread a column, kPerThread rows; a warp reads 32
// neighbouring words, no bank conflict).
//
// Every product and every sum is its own __fmul_rn / __fadd_rn, taps k = 0..10
// in order, out = tap0 * x0 then out + tapk * xk: the plain chain is separate
// PyTorch launches, which never contract a multiply and an add into an FMA,
// so the blurred values are bit for bit the plain chain's on the card. The
// taps, C1 and C2 are the float32 values PyTorch uses for the Python scalars
// (the wrapper passes them as host floats; the launch copies them into the
// kernel's parameters).

#pragma once

#include <cuda_runtime.h>

namespace glic_ssim {

constexpr int kR = 5;                       // apron: the window's radius
constexpr int kTaps = 2 * kR + 1;           // 11
constexpr int kTile = 32;                   // output tile: kTile x kTile pixels
constexpr int kRows = 8;                    // threads: kTile x kRows
constexpr int kThreads = kTile * kRows;     // 256
constexpr int kPerThread = kTile / kRows;   // output rows a thread: 4
constexpr int kSpan = kTile + 2 * kR;       // staged rows and columns: 42
constexpr int kSeg = kPerThread + 2 * kR;   // staged rows a vertical segment reads: 14
constexpr int kSegments = kSpan * kRows;    // vertical segments of a tile: 336

struct Konst {
  float tap[kTaps];
  float c1, c2;
};

// the 11-tap blur of p[0], p[stride], ..., p[10 * stride]
__device__ __forceinline__ float blur11(const float* p, int stride, const Konst& k) {
  float acc = __fmul_rn(k.tap[0], p[0]);
#pragma unroll
  for (int i = 1; i < kTaps; ++i) acc = __fadd_rn(acc, __fmul_rn(k.tap[i], p[i * stride]));
  return acc;
}

// the vertical pass of one column segment: out[j * kSpan] = blur of
// p[j .. j + 10], j < kPerThread
__device__ __forceinline__ void vertical(const float (&p)[kSeg], float* out, const Konst& k) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    float acc = __fmul_rn(k.tap[0], p[j]);
#pragma unroll
    for (int i = 1; i < kTaps; ++i) acc = __fadd_rn(acc, __fmul_rn(k.tap[i], p[j + i]));
    out[j * kSpan] = acc;
  }
}

}  // namespace glic_ssim
