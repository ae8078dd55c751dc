// Shared constants and per-(entry, pixel) arithmetic of the blend kernels.
//
// The alpha of an entry at a pixel decides whether the entry is applied, and
// the forward kernel, the backward kernel and the plain PyTorch versions in
// ops/blend.py must take the same decision. So the power/alpha/transmittance
// arithmetic is written with the round-to-nearest intrinsics, which nvcc
// never contracts into FMAs: each step rounds exactly as the separate
// PyTorch elementwise ops do, in the same order. expf is the accurate libm
// exp (no --use_fast_math), as PyTorch's exp is.
#pragma once

#include <cuda_runtime.h>

namespace glic {

constexpr int kThreads = 256;          // threads per block (one block per tile)
constexpr int kTilePix = 1024;         // pixels per tile (tile_h * tile_w)
constexpr int kPixPerThread = kTilePix / kThreads;
constexpr int kRowFloats = 16;         // floats per gathered splat row
constexpr float kAlphaCap = 0.99f;     // forward.cu:436
constexpr float kTEps = 1e-4f;         // forward.cu:439
constexpr float kOpacityThreshold = 1.0f / 255.0f;

struct Splat {
  float x, y, nA, B, nC, opa, r, g, b;
};

// power = (-A/2 dx - B dy) dx + (-C/2 dy) dy, as ops/blend.py:_alpha computes it
__device__ __forceinline__ float splat_power(const Splat& s, float dx, float dy) {
  const float u = __fsub_rn(__fmul_rn(s.nA, dx), __fmul_rn(s.B, dy));
  return __fadd_rn(__fmul_rn(u, dx), __fmul_rn(__fmul_rn(s.nC, dy), dy));
}

__device__ __forceinline__ float splat_alpha(const Splat& s, float g) {
  return fminf(kAlphaCap, __fmul_rn(s.opa, g));
}

__device__ __forceinline__ bool contributes(float alpha, float power) {
  return alpha >= kOpacityThreshold && power <= 0.0f;
}

// Load row e of the gathered list; the conic halves are pre-negated as in
// the Pallas kernels (exact: a multiply by -0.5).
__device__ __forceinline__ Splat load_splat(const float* __restrict__ rows, long long e) {
  const float* p = rows + e * kRowFloats;
  Splat s;
  s.x = p[0];
  s.y = p[1];
  s.nA = -0.5f * p[2];
  s.B = p[3];
  s.nC = -0.5f * p[4];
  s.opa = p[5];
  s.r = p[6];
  s.g = p[7];
  s.b = p[8];
  return s;
}

}  // namespace glic
