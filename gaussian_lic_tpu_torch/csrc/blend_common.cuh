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

#include <cstdint>

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

// min(0.99, opa g) that keeps a NaN, as torch.clamp_max and jnp.minimum do
// (fminf would return 0.99): contributes() then rejects the entry. The same
// float as fminf for every other input.
__device__ __forceinline__ float splat_alpha(const Splat& s, float g) {
  const float a = __fmul_rn(s.opa, g);
  return a > kAlphaCap ? kAlphaCap : a;
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

// 1-D bulk copies (cp.async.bulk) into shared memory, completed on an
// mbarrier: K1 and K2 stage their batches of gathered rows with these.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Start copying `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global `src` to shared `dst`; completion is reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace glic
