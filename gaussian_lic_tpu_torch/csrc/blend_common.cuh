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
constexpr int kWarpPix = 32 * kPixPerThread;  // pixels of one warp: K1's warp block
constexpr unsigned kAllLanes = 0xffffffffu;

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

// Row j of a staged batch `p` (16 floats a row, 16-byte aligned), as
// load_splat makes it: two vector loads and one scalar.
__device__ __forceinline__ Splat row_splat(const float* p) {
  const float4 r0 = *reinterpret_cast<const float4*>(p);
  const float4 r1 = *reinterpret_cast<const float4*>(p + 4);
  Splat s;
  s.x = r0.x;
  s.y = r0.y;
  s.nA = -0.5f * r0.z;
  s.B = r0.w;
  s.nC = -0.5f * r1.x;
  s.opa = r1.y;
  s.r = r1.z;
  s.g = r1.w;
  s.b = p[8];
  return s;
}

// K1's warp pixel blocks (ops/blend.py k1_block): 128 pixels, block_w wide.
// 8x16 in tiles of 16 rows or more and 8 columns or more; in a tile of
// fewer rows, one block row spans 128 / tile_h columns (16x8, 32x4, 64x2,
// 128x1); in a tile of fewer columns, the block is as wide as the tile
// (4x32, 2x64, 1x128). 0 for a tile that does not hold 1024 pixels.
__host__ __device__ constexpr int k1_block_w(int tile_h, int tile_w) {
  return (tile_h <= 0 || tile_w <= 0 || tile_h * tile_w != kTilePix) ? 0
         : tile_h < 16 ? kWarpPix / tile_h
         : tile_w < 8  ? tile_w
                       : 8;
}

// Pixel k of lane `lane` in warp block `wblock` (numbered row-major in its
// tile) of a tile whose top-left pixel is (tile_col, tile_row): lanes run
// along a block row (up to 32 of them), and a thread's pixels lie 32 / block_w
// rows apart in blocks up to 32 wide, 32 columns apart along the row in
// wider ones.
struct WarpBlock {
  int col0, row0, block_w, block_h;
};

__device__ __forceinline__ WarpBlock warp_block(int wblock, int tile_col, int tile_row, int tile_w,
                                                int block_w) {
  const int block_h = kWarpPix / block_w;
  const int per_row = tile_w / block_w;
  return WarpBlock{tile_col + (wblock % per_row) * block_w,
                   tile_row + (wblock / per_row) * block_h, block_w, block_h};
}

__device__ __forceinline__ void block_pixel(const WarpBlock& wb, int lane, int k, int& col,
                                            int& row) {
  const int lanes_w = min(wb.block_w, 32);   // lanes along one block row
  const int per_lane = wb.block_w / lanes_w;  // a thread's pixels along one row
  row = wb.row0 + lane / lanes_w + (k / per_lane) * (32 / lanes_w);
  col = wb.col0 + lane % lanes_w + (k % per_lane) * 32;
}

// The footprint box (K1's cull). A pair's computed power (splat_power on
// rounded dx, dy: 7 roundings) differs from the exact -q(d), q(d) = (A dx^2
// + C dy^2) / 2 + B dx dy, by at most 6u S(d), u = 2^-24, S(d) = (A dx^2 +
// 2|B dx dy| + C dy^2) / 2 <= kappa q(d) with kappa = (A + C)^2 / det: below
// kPowerRel kappa q(d). A pair passes only if opa * expf(power) rounds to >=
// 1/255 (expf within 2 ulp, the product within half of one), i.e. power >=
// -ln(255 opa) - 3e-7; kPowerAbs covers it with a margin (ln(255 opa) is
// taken in double, whatever opa is). K3 noexp's linear stand-in G = 0.1
// power + 0.9 passes where power >= (1/255 / opa - 0.9) / 0.1 to within
// ~2e-6 (three roundings, each scaled by 1 / 0.1): kLinearAbs covers it.
constexpr double kPowerRel = 1e-6;
constexpr double kPowerAbs = 2e-6;
constexpr double kLinearAbs = 1e-5;
// A further relative and absolute widening of the box (half-widths), far
// above the rounding of the box's own double arithmetic.
constexpr double kBoxRel = 1e-3;
constexpr double kBoxAbs = 0.01;

__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= 3.402823466e38f; }

// (x_lo, x_hi, y_lo, y_hi) of pixel centres outside which the entry applies
// nowhere: the bounding box of q(d) <= t', t' = (t + kPowerAbs) / (1 -
// kPowerRel kappa) with t = ln(255 opa) (kLinear: (0.9 - (1/255) / opa) /
// 0.1 + kLinearAbs in place of t + kPowerAbs), where q(d) > t' means the
// pair fails the alpha >= 1/255 test after rounding. Every pixel when the
// conic is not positive definite, an attribute is not finite or kappa is too
// large for the bound; no pixel when alpha < 1/255 at every pixel with a
// margin (opa < 1/255, or 0.9 opa < 1/255 for kLinear).
template <bool kLinear = false>
__device__ __forceinline__ float4 cull_box(float x, float y, float A, float B, float C,
                                           float opa) {
  const float inf = __int_as_float(0x7f800000);
  const float4 every = make_float4(-inf, inf, -inf, inf);
  if (!(finite(x) && finite(y) && finite(A) && finite(B) && finite(C) && finite(opa)))
    return every;
  const double o = opa;
  if (kLinear ? o * static_cast<double>(0.9f) * (1.0 + 1e-5) < static_cast<double>(kOpacityThreshold)
              : o * 255.0 * (1.0 + 1e-6) < 1.0)
    return make_float4(inf, -inf, inf, -inf);
  const double a = A, b = B, c = C;
  const double det = a * c - b * b;
  if (!(det > 0.0 && a > 0.0)) return every;
  const double shrink = 1.0 - kPowerRel * (a + c) * (a + c) / det;
  if (!(shrink >= 0.5)) return every;
  const double q = kLinear ? (static_cast<double>(0.9f) - static_cast<double>(kOpacityThreshold) / o)
                                     / static_cast<double>(0.1f) + kLinearAbs
                           : log(255.0 * o) + kPowerAbs;
  const double t = fmax(q, 0.0) / shrink;
  const double s = 2.0 * t / det;
  const double wx = sqrt(s * c) * (1.0 + kBoxRel) + kBoxAbs;
  const double wy = sqrt(s * a) * (1.0 + kBoxRel) + kBoxAbs;
  return make_float4(__double2float_rd(x - wx), __double2float_ru(x + wx),
                     __double2float_rd(y - wy), __double2float_ru(y + wy));
}

// The box of the gathered row `p`.
template <bool kLinear = false>
__device__ __forceinline__ float4 cull_box(const float* p) {
  return cull_box<kLinear>(p[0], p[1], p[2], p[3], p[4], p[5]);
}

__device__ __forceinline__ bool box_meets(const float4& box, float bx0, float bx1, float by0,
                                          float by1) {
  return box.y >= bx0 && box.x <= bx1 && box.w >= by0 && box.z <= by1;
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
