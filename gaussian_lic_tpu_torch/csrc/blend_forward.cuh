// K1's kernel, templated on the K3 probe variant: the production entry
// (blend_forward.cu) launches kFwdBase, the K3 probes (blend_probe_forward.cu)
// every variant. One source, so K3 `base` is K1.
//
// The design (csrc/blend_forward.cu says why): each warp owns a compact
// 128-pixel block of the tile (k1_block_w), 4 pixels per thread, and walks
// only the entries whose footprint box (cull_box) meets its block, 32 boxes
// to a ballot; batches of 128 gathered rows arrive by 1-D bulk copy into a
// double buffer; a tile is 2 bands of 4 warp blocks, one CUDA block each,
// launched in tile order; a band leaves once every pixel of it has stopped.
//
// The variants each take one cost centre out:
//   kFwdNoCull    no box test and no ballot: every warp walks every entry of
//                 its band (outputs K1's, bit for bit)
//   kFwdNoExp     G = 0.1 power + 0.9 in place of expf(power); its cull box
//                 comes from that test's own threshold (cull_box<true>)
//   kFwdNoAttr    no staging and no attribute loads: every entry is the
//                 constant splat `konst`, culled by that splat's box
//   kFwdNoBlend   no tests and no blend: color += (power, power/2, power/4)
//                 over every in-range entry, walked without a cull and
//                 without an early exit (final_T 1, n_contrib 0)
//   kFwdBatch256  256 rows a batch in place of 128 (outputs K1's)
//   kFwdDirect    no bulk-copy staging: the boxes and the walk read the rows
//                 from device memory (outputs K1's)
// The substitutions apply entries outside K1's box (noexp's linear G passes
// down to power ~ -9, noattr's splat is not the row's, noblend adds every
// entry), hence their own culls. konst's fields and its box come in as
// kernel arguments and an empty asm statement marks them as rewritten on
// every entry, so nvcc cannot hoist the per-entry work out of the loop.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace glic {
namespace {

enum ForwardVariant : int {
  kFwdBase = 0,
  kFwdNoCull = 1,
  kFwdNoExp = 2,
  kFwdNoAttr = 3,
  kFwdNoBlend = 4,
  kFwdBatch256 = 5,
  kFwdDirect = 6,
};

constexpr int kFwdBands = 2;                             // bands per tile
constexpr int kFwdBandThreads = kThreads / kFwdBands;
constexpr int kFwdBandWarps = kFwdBandThreads / 32;

// The raw attributes (x, y, A, B, C, opa, r, g, b) of K3 noattr's splat.
struct RawSplat {
  float v[9];
};

// The values the compiler must assume change here.
__device__ __forceinline__ void opaque(Splat& s) {
  asm volatile("" : "+f"(s.x), "+f"(s.y), "+f"(s.nA), "+f"(s.B), "+f"(s.nC),
               "+f"(s.opa), "+f"(s.r), "+f"(s.g), "+f"(s.b));
}

__device__ __forceinline__ void opaque(float4& v) {
  asm volatile("" : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w));
}

// `walked` (null, or one int per tile, zeros): the entries the tile's walk
// visited, the larger of its bands'. `block_w`: k1_block_w of the tile.
template <int V>
__global__ void __launch_bounds__(kFwdBandThreads)
blend_forward_kernel(const float* __restrict__ rows, long long m_pad,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_lens,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib, int* __restrict__ walked, int n_tx,
                     int tile_w, int tile_h, int width_p, int height_p, int block_w,
                     int no_color, RawSplat konst) {
  constexpr int kBatch = V == kFwdBatch256 ? 256 : 128;    // entries staged per round
  constexpr bool kBulk = V != kFwdNoAttr && V != kFwdDirect;  // rows staged by bulk copy
  constexpr bool kCull = V != kFwdNoCull && V != kFwdNoBlend;
  constexpr bool kBoxes = kCull && V != kFwdNoAttr;         // a box per staged entry
  constexpr bool kTests = V != kFwdNoBlend;
  __shared__ __align__(128) float s_buf[kBulk ? 2 : 1][kBulk ? kBatch * kRowFloats : 4];
  __shared__ float4 s_box[kBoxes ? kBatch : 1];
  __shared__ __align__(8) uint64_t s_bar[2];

  const int band = blockIdx.x % kFwdBands;
  const int tile = blockIdx.x / kFwdBands;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);
  len = max(len, 0);
  const int lane = threadIdx.x & 31;
  const WarpBlock wb = warp_block(band * kFwdBandWarps + (threadIdx.x >> 5), tx * tile_w,
                                  ty * tile_h, tile_w, block_w);
  const float bx0 = static_cast<float>(wb.col0), bx1 = static_cast<float>(wb.col0 + block_w - 1);
  const float by0 = static_cast<float>(wb.row0), by1 = static_cast<float>(wb.row0 + wb.block_h - 1);

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  int last[kPixPerThread];
  bool done[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    int col, row;
    block_pixel(wb, lane, k, col, row);
    px[k] = static_cast<float>(col);
    py[k] = static_cast<float>(row);
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    last[k] = 0;
    done[k] = false;
  }
  Splat ks{};
  float4 kbox{};
  if constexpr (V == kFwdNoAttr) {
    const float* v = konst.v;
    ks = Splat{v[0], v[1], -0.5f * v[2], v[3], -0.5f * v[4], v[5], v[6], v[7], v[8]};
    kbox = cull_box<false>(v[0], v[1], v[2], v[3], v[4], v[5]);
  }

  if (kBulk && threadIdx.x == 0) {
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
  if (kBulk && threadIdx.x == 0) {
    for (int b = 0; b < 2 && b < n_batches; ++b) refill(b);
  }

  int b = 0;
  for (; b < n_batches; ++b) {
    const int base = b * kBatch;
    const int n = min(kBatch, len - base);
    const float* src;  // this batch's rows: staged, or in device memory
    if constexpr (kBulk) {
      src = s_buf[b & 1];
      mbar_wait(&s_bar[b & 1], (b >> 1) & 1);
    } else {
      src = rows + (start + base) * kRowFloats;
    }
    if constexpr (kBoxes) {
      for (int j = threadIdx.x; j < n; j += kFwdBandThreads)
        s_box[j] = cull_box<V == kFwdNoExp>(src + j * kRowFloats);
    }
    if constexpr (kTests) {
      bool mine_done = true;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) mine_done = mine_done && done[k];
      // barrier: the boxes are visible; the band leaves once all its pixels stopped
      if (__syncthreads_count(mine_done) == kFwdBandThreads) break;
    } else {
      __syncthreads();
    }

    for (int g = 0; g < n; g += 32) {
      if constexpr (kTests) {
        bool warp_done = true;
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) warp_done = warp_done && done[k];
        if (__all_sync(kAllLanes, warp_done)) break;
      }
      unsigned mask;
      if constexpr (kCull) {
        bool meets = false;
        if (g + lane < n) {
          float4 box;
          if constexpr (V == kFwdNoAttr) {
            box = kbox;
            opaque(box);
          } else {
            box = s_box[g + lane];
          }
          meets = box_meets(box, bx0, bx1, by0, by1);
        }
        mask = __ballot_sync(kAllLanes, meets);
      } else {
        mask = n - g >= 32 ? kAllLanes : (1u << (n - g)) - 1u;
      }
      // the batch's entries that can apply in this warp's block, in order
      for (; mask != 0; mask &= mask - 1) {
        const int j = g + __ffs(mask) - 1;
        Splat s;
        if constexpr (V == kFwdNoAttr) {
          s = ks;
          opaque(s);
        } else {
          s = row_splat(src + j * kRowFloats);
        }
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          if (kTests && done[k]) continue;
          const float dx = __fsub_rn(s.x, px[k]);
          const float dy = __fsub_rn(s.y, py[k]);
          const float power = splat_power(s, dx, dy);
          if constexpr (!kTests) {
            cr[k] += power;
            cg[k] += power * 0.5f;
            cb[k] += power * 0.25f;
            continue;
          }
          const float G = V == kFwdNoExp ? __fadd_rn(__fmul_rn(power, 0.1f), 0.9f) : expf(power);
          const float alpha = splat_alpha(s, G);
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
    if (kBulk && threadIdx.x == 0 && b + 2 < n_batches) refill(b + 2);
  }
  // leaving early: the next batch may still be landing in shared memory
  if (kBulk && b + 1 < n_batches) mbar_wait(&s_bar[(b + 1) & 1], ((b + 1) >> 1) & 1);
  if (walked != nullptr && threadIdx.x == 0) atomicMax(walked + tile, min(b * kBatch, len));

  const long long plane = static_cast<long long>(width_p) * height_p;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    // the pixel's index, from its exact float coordinates (no registers held
    // through the walk)
    const long long pix = static_cast<long long>(py[k]) * width_p + static_cast<int>(px[k]);
    final_t[pix] = T[k];
    if (no_color) {
      color[pix] = 0.0f;
      color[plane + pix] = 0.0f;
      color[2 * plane + pix] = 0.0f;
      n_contrib[pix] = 0;
    } else {
      color[pix] = cr[k];
      color[plane + pix] = cg[k];
      color[2 * plane + pix] = cb[k];
      n_contrib[pix] = last[k];
    }
  }
}

// Launches variant V over n_tx x n_ty tiles of tile_h x tile_w pixels.
template <int V>
cudaError_t launch_forward(const float* rows, long long m_pad, const int* tile_starts,
                           const int* tile_lens, float* color, float* final_t, int* n_contrib,
                           int* walked, int n_tx, int n_ty, int tile_w, int tile_h,
                           int no_color, const RawSplat& konst, cudaStream_t stream) {
  const int block_w = k1_block_w(tile_h, tile_w);
  if (block_w == 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) return cudaErrorMisalignedAddress;
  if (n_tx * n_ty <= 0) return cudaSuccess;
  blend_forward_kernel<V><<<n_tx * n_ty * kFwdBands, kFwdBandThreads, 0, stream>>>(
      rows, m_pad, tile_starts, tile_lens, color, final_t, n_contrib, walked, n_tx, tile_w,
      tile_h, n_tx * tile_w, n_ty * tile_h, block_w, no_color, konst);
  return cudaGetLastError();
}

}  // namespace
}  // namespace glic
