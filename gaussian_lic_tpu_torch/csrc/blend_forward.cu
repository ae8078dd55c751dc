// K1: tile blend forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_lic_tpu/ops/blend_pallas.py:
// _forward_kernel / blend_forward (the reference's renderCUDA,
// forward.cu:321-481).
//
// What bounds it on this card: per (entry, pixel) pair it tests, one expf
// and ~20 float ops; device memory is no limit (each entry's 64-byte row is
// read once per tile). The first design (kept line for line as K3 `base`,
// blend_probe_forward.cu) tested every entry of a tile at every pixel, 1.39e9
// pairs at the 1M-Gaussian train step, of which 1.8% apply: the tests and
// their expf were its time. This design tests only the pairs that can apply:
//  (a) each warp owns a compact kBlockW x (128 / kBlockW) block of the
//      tile, 4 pixels per thread. Once per CUDA block, one thread per
//      staged entry computes the bounding box of the entry's alpha >= 1/255
//      ellipse (cull_box), widened so that it holds every pixel at which the
//      float arithmetic of blend_common.cuh could apply the entry. Each warp
//      tests 32 boxes against its block at a time (one ballot) and walks only
//      the entries whose box meets it, in order. A skipped pair is one that
//      the per-pixel test would reject, so color, final_T and n_contrib are
//      the first design's bit for bit;
//  (b) batches of kBatch gathered rows arrive by a 1-D bulk copy
//      (cp.async.bulk + mbarrier, blend_common.cuh) into a double buffer:
//      batch b+1 lands while b is walked. The block leaves the walk once
//      every pixel of its band has stopped (__syncthreads_count per batch);
//  (c) a tile is split into kBands pixel bands of whole warp blocks, one
//      CUDA block each. The forward walk is independent per pixel, so bands
//      need no sum between blocks.
// K1's warp blocks are 8x16 pixels, 2 bands a tile, launched in tile order:
// the fastest of the layouts timed at the 1M-Gaussian train step (16x8 and
// 32x4 blocks; 1, 2 or 4 bands; tile order or longest first, with the argsort
// it needs on every call counted; PERF.md). The 8x128 tile, which the
// multi-GPU band geometry falls back to (parallel/sharded.py), has no room
// for 16 rows: there the blocks are 16x8, the one instantiation that differs.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace glic {
namespace {

constexpr int kBatch = 128;               // entries staged per round
constexpr int kBands = 2;                 // bands per tile
constexpr int kWarpPix = 32 * kPixPerThread;
constexpr int kBandThreads = kThreads / kBands;
constexpr int kBandWarps = kBandThreads / 32;
constexpr unsigned kAllLanes = 0xffffffffu;

// Error bounds of the per-pixel test, for cull_box. The computed power of a
// pair (splat_power on rounded dx, dy: 7 roundings) differs from the exact
// -q(d), q(d) = (A dx^2 + C dy^2) / 2 + B dx dy, by at most 6u S(d), u =
// 2^-24, S(d) = (A dx^2 + 2|B dx dy| + C dy^2) / 2 <= kappa q(d) with kappa =
// (A + C)^2 / det: below kPowerRel kappa q(d). A pair passes only if
// opa * expf(power) rounds to >= 1/255 (expf within 2 ulp, the product
// within half of one), i.e. power >= -ln(255 opa) - 3e-7; kPowerAbs covers
// it with a margin (ln(255 opa) is taken in double, whatever opa is).
constexpr double kPowerRel = 1e-6;
constexpr double kPowerAbs = 2e-6;
// A further relative and absolute widening of the box (half-widths), far
// above the rounding of the box's own double arithmetic.
constexpr double kBoxRel = 1e-3;
constexpr double kBoxAbs = 0.01;

// (x_lo, x_hi, y_lo, y_hi) of pixel centres outside which the entry of row
// `p` applies nowhere: the bounding box of q(d) <= t', t' = (ln(255 opa) +
// kPowerAbs) / (1 - kPowerRel kappa), where q(d) > t' means power < -ln(255
// opa) - 3e-7 after rounding. Every pixel when the conic is not positive
// definite, an attribute is not finite or kappa is too large for the bound;
// no pixel when opa < 1/255 with a margin (alpha < 1/255 everywhere).
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= 3.402823466e38f; }

__device__ __forceinline__ float4 cull_box(const float* p) {
  const float x = p[0], y = p[1], A = p[2], B = p[3], C = p[4], opa = p[5];
  const float inf = __int_as_float(0x7f800000);
  const float4 every = make_float4(-inf, inf, -inf, inf);
  if (!(finite(x) && finite(y) && finite(A) && finite(B) && finite(C) && finite(opa)))
    return every;
  if (static_cast<double>(opa) * 255.0 * (1.0 + 1e-6) < 1.0)
    return make_float4(inf, -inf, inf, -inf);
  const double a = A, b = B, c = C;
  const double det = a * c - b * b;
  if (!(det > 0.0 && a > 0.0)) return every;
  const double shrink = 1.0 - kPowerRel * (a + c) * (a + c) / det;
  if (!(shrink >= 0.5)) return every;
  const double t = fmax(log(255.0 * static_cast<double>(opa)) + kPowerAbs, 0.0) / shrink;
  const double s = 2.0 * t / det;
  const double wx = sqrt(s * c) * (1.0 + kBoxRel) + kBoxAbs;
  const double wy = sqrt(s * a) * (1.0 + kBoxRel) + kBoxAbs;
  return make_float4(__double2float_rd(x - wx), __double2float_ru(x + wx),
                     __double2float_rd(y - wy), __double2float_ru(y + wy));
}

// kBlockW is the width of a warp's pixel block: 8 (8x16 blocks) for tiles
// whose height is a multiple of 16, 16 (16x8 blocks) for the 8x128 tile.
template <int kBlockW>
__global__ void __launch_bounds__(kBandThreads)
blend_forward_kernel(const float* __restrict__ rows, long long m_pad,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_lens,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib, int n_tx, int tile_w,
                     int tile_h, int width_p, int height_p, int no_color) {
  constexpr int kBlockH = kWarpPix / kBlockW;
  constexpr int kRowStep = 32 / kBlockW;  // rows between a thread's pixels
  __shared__ __align__(128) float s_buf[2][kBatch * kRowFloats];
  __shared__ float4 s_box[kBatch];
  __shared__ __align__(8) uint64_t s_bar[2];

  const int band = blockIdx.x % kBands;
  const int tile = blockIdx.x / kBands;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);
  len = max(len, 0);
  const int lane = threadIdx.x & 31;
  const int wblock = band * kBandWarps + (threadIdx.x >> 5);  // the warp's block in the tile
  const int col0 = tx * tile_w + (wblock % (tile_w / kBlockW)) * kBlockW;
  const int row0 = ty * tile_h + (wblock / (tile_w / kBlockW)) * kBlockH;
  const float bx0 = static_cast<float>(col0), bx1 = static_cast<float>(col0 + kBlockW - 1);
  const float by0 = static_cast<float>(row0), by1 = static_cast<float>(row0 + kBlockH - 1);

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  int last[kPixPerThread];
  bool done[kPixPerThread];
  long long pix[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int row = row0 + lane / kBlockW + k * kRowStep;
    const int col = col0 + lane % kBlockW;
    px[k] = static_cast<float>(col);
    py[k] = static_cast<float>(row);
    pix[k] = static_cast<long long>(row) * width_p + col;
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    last[k] = 0;
    done[k] = false;
  }

  if (threadIdx.x == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_batches = (len + kBatch - 1) / kBatch;
  auto refill = [&](int b) {
    const int lo = b * kBatch;
    bulk_load(s_buf[b & 1], rows + (start + lo) * kRowFloats,
              static_cast<uint32_t>(min(kBatch, len - lo) * kRowFloats * 4), &s_bar[b & 1]);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2 && b < n_batches; ++b) refill(b);
  }

  int b = 0;
  for (; b < n_batches; ++b) {
    const int base = b * kBatch;
    const int n = min(kBatch, len - base);
    const float* buf = s_buf[b & 1];
    mbar_wait(&s_bar[b & 1], (b >> 1) & 1);
    for (int j = threadIdx.x; j < n; j += kBandThreads) s_box[j] = cull_box(buf + j * kRowFloats);
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) mine_done = mine_done && done[k];
    // barrier: the boxes are visible; the band leaves once all its pixels stopped
    if (__syncthreads_count(mine_done) == kBandThreads) break;

    for (int g = 0; g < n; g += 32) {
      bool warp_done = true;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) warp_done = warp_done && done[k];
      if (__all_sync(kAllLanes, warp_done)) break;
      bool meets = false;
      if (g + lane < n) {
        const float4 box = s_box[g + lane];
        meets = box.y >= bx0 && box.x <= bx1 && box.w >= by0 && box.z <= by1;
      }
      // the batch's entries that can apply in this warp's block, in order
      for (unsigned mask = __ballot_sync(kAllLanes, meets); mask != 0; mask &= mask - 1) {
        const int j = g + __ffs(mask) - 1;
        const float4 r0 = *reinterpret_cast<const float4*>(buf + j * kRowFloats);
        const float4 r1 = *reinterpret_cast<const float4*>(buf + j * kRowFloats + 4);
        Splat s;  // as load_splat makes it
        s.x = r0.x;
        s.y = r0.y;
        s.nA = -0.5f * r0.z;
        s.B = r0.w;
        s.nC = -0.5f * r1.x;
        s.opa = r1.y;
        s.r = r1.z;
        s.g = r1.w;
        s.b = buf[j * kRowFloats + 8];
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          if (done[k]) continue;
          const float dx = __fsub_rn(s.x, px[k]);
          const float dy = __fsub_rn(s.y, py[k]);
          const float power = splat_power(s, dx, dy);
          const float alpha = splat_alpha(s, expf(power));
          if (!contributes(alpha, power)) continue;
          const float test_t = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
          if (test_t < kTEps) {  // stop before applying this entry
            done[k] = true;
            continue;
          }
          const float w = alpha * T[k];
          cr[k] += w * s.r;
          cg[k] += w * s.g;
          cb[k] += w * s.b;
          last[k] = base + j + 1;
          T[k] = test_t;
        }
      }
    }
    __syncthreads();  // the buffer and the boxes are free again
    if (threadIdx.x == 0 && b + 2 < n_batches) refill(b + 2);
  }
  // leaving early: the next batch may still be landing in shared memory
  if (b + 1 < n_batches) mbar_wait(&s_bar[(b + 1) & 1], ((b + 1) >> 1) & 1);

  const long long plane = static_cast<long long>(width_p) * height_p;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    final_t[pix[k]] = T[k];
    if (no_color) {
      color[pix[k]] = 0.0f;
      color[plane + pix[k]] = 0.0f;
      color[2 * plane + pix[k]] = 0.0f;
      n_contrib[pix[k]] = 0;
    } else {
      color[pix[k]] = cr[k];
      color[plane + pix[k]] = cg[k];
      color[2 * plane + pix[k]] = cb[k];
      n_contrib[pix[k]] = last[k];
    }
  }
}

}  // namespace
}  // namespace glic

// K1. `rows` must be 16-byte aligned (the bulk copy's rule).
extern "C" int glic_blend_forward(const float* rows, long long m_pad, const int* tile_starts,
                                  const int* tile_lens, float* color, float* final_t,
                                  int* n_contrib, int n_tx, int n_ty, int tile_w, int tile_h,
                                  int no_color, void* stream) {
  using namespace glic;
  // the tile's shape picks the warp block: 8x16 where tile_h % 16 == 0,
  // 16x8 for tile_h == 8 (the 8x128 tile of the band geometry)
  const int block_w = tile_h % 16 == 0 ? 8 : (tile_h == 8 ? 16 : 0);
  if (tile_w * tile_h != kTilePix || block_w == 0 || tile_w % block_w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_tx * n_ty <= 0) return static_cast<int>(cudaSuccess);
  auto kernel = block_w == 8 ? blend_forward_kernel<8> : blend_forward_kernel<16>;
  kernel<<<n_tx * n_ty * kBands, kBandThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, m_pad, tile_starts, tile_lens, color, final_t, n_contrib, n_tx, tile_w, tile_h,
      n_tx * tile_w, n_ty * tile_h, no_color);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* glic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
