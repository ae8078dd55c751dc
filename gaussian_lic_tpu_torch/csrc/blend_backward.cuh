// K2's kernel, templated on the K4 probe variant: the production entry
// (blend_backward.cu) launches kBwdBase, the K4 probes
// (blend_probe_backward.cu) every variant. One source, so K4 `base` is K2.
//
// The design (csrc/blend_backward.cu says why): 4 bands a tile, one block of
// 64 threads each; each warp owns one of K1's compact 128-pixel blocks
// (warp block band * 2 + warp, k1_block_w), 4 pixels a thread; batches of
// 128 gathered rows arrive by 1-D bulk copy into a double buffer and are
// walked back to front from min(max n_contrib, len) over the band's two
// blocks; a per-batch pass writes each entry's footprint box (cull_box) to
// shared memory, and each warp applies only the entries whose box meets its
// block, 32 boxes to a ballot; each applied entry's 9 sums are reduced over
// the warp by a 12-shuffle reduce-scatter into a per-warp [128][9] buffer
// (zeroed before each batch: a skipped entry's sums read zero), a per-batch
// pass sums the 2 warps, turns the moments into gradients and adds them per
// Gaussian with three red.global.add.v4.f32; the tiles are launched in the
// order the caller passes (K2: longest first).
//
// The variants each take one cost centre out of that culled walk:
//   kBwdSbuf        one buffer, refilled synchronously after each batch
//                   (gradients K2's)
//   kBwdNoRed       no reduce-scatter and no warp-partials pass: each entry's
//                   record is the band's first thread's own 4 pixels' sums
//                   (every pixel's arithmetic still runs), added per Gaussian
//   kBwdSmemAtomic  no reduce-scatter: every lane that applied the entry adds
//                   its 9 sums into one [128][9] buffer with shared-memory
//                   atomics, so no per-warp buffer and no warp pass
//                   (gradients K2's, in another order)
//   kBwdNoAtomic    no per-Gaussian atomics: each band stores its partial
//                   record of every walked entry into a (bands, M_pad, 9)
//                   buffer with plain stores
//   kBwdNoCull      no box pass, no box test and no ballot: K2's walk before
//                   the cull, whose band is 256 consecutive pixels of the
//                   tile (thread t's at t + 64 k, so a warp spans 7 rows of
//                   32 interleaved with the other warp's) and whose warps
//                   walk every entry (gradients K2's, in another order)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace glic {
namespace {

enum BackwardVariant : int {
  kBwdBase = 0,
  kBwdSbuf = 1,
  kBwdNoRed = 2,
  kBwdSmemAtomic = 3,
  kBwdNoAtomic = 4,
  kBwdNoCull = 5,
};

constexpr int kBatchB = 128;                         // entries staged per round
constexpr int kGrads = 9;
constexpr int kTableStride = 12;                     // floats per per-Gaussian row
constexpr int kBufBytes = kBatchB * kRowFloats * 4;  // one staged batch: 8 KB
constexpr int kBwdBands = 4;                         // blocks per tile
constexpr int kBwdBandThreads = kThreads / kBwdBands;  // threads per block
constexpr int kBwdBandWarps = kBwdBandThreads / 32;

// Dynamic shared memory of a block: the staged batches, the cull's boxes,
// then the per-entry partial sums [warp][entry][9] (one row for the
// variants that sum into one). K2: 2 x 8,192 + 2,048 + 9,216 = 27,648 B.
template <int V>
struct BwdSmem {
  static constexpr bool kCull = V != kBwdNoCull;
  static constexpr int kBufs = V == kBwdSbuf ? 1 : 2;
  static constexpr int kRedRows = (V == kBwdNoRed || V == kBwdSmemAtomic) ? 1 : kBwdBandWarps;
  static constexpr int kBoxOffset = kBufs * kBufBytes;
  static constexpr int kRedOffset = kBoxOffset + (kCull ? kBatchB * 16 : 0);
  static constexpr int kBytes = kRedOffset + kRedRows * kBatchB * kGrads * 4;
  static_assert(kBytes <= 48 * 1024, "K2's shared memory needs the opt-in attribute");
};

// One level of the reduce-scatter: q[0..V) -> q[0..H), H = ceil(V/2). The
// lane whose `upper` bit is set keeps the upper half, its partner (lane ^ OFF)
// the lower one; each sends the other half across. The upper half of an odd V
// is padded with a zero.
template <int OFF, int V>
__device__ __forceinline__ void reduce_scatter_level(float* q, bool upper) {
  constexpr int H = (V + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float a = q[i];
    const float b = (i + H < V) ? q[i + H] : 0.0f;
    const float keep = upper ? b : a;
    const float send = upper ? a : b;
    q[i] = keep + __shfl_xor_sync(kAllLanes, send, OFF);
  }
}

// After this, lane `lane` holds in q[0] the warp sum of moment
// reduce_scatter_index(lane) (when that is valid): 9 -> 5 -> 3 -> 2 -> 1 -> 1.
__device__ __forceinline__ void reduce_scatter9(float* q, int lane) {
  reduce_scatter_level<16, 9>(q, lane & 16);
  reduce_scatter_level<8, 5>(q, lane & 8);
  reduce_scatter_level<4, 3>(q, lane & 4);
  reduce_scatter_level<2, 2>(q, lane & 2);
  q[0] += __shfl_xor_sync(kAllLanes, q[0], 1);
}

// The moment a lane holds after reduce_scatter9, or -1: the levels unwound
// from the last, each adding its half size for an upper lane; a padded slot
// (index past its level's size) holds zero. Of each lane pair of the last
// level only the even lane writes.
__device__ __forceinline__ int reduce_scatter_index(int lane) {
  int idx = (lane & 2) ? 1 : 0;
  bool ok = idx < 2;
  idx += (lane & 4) ? 2 : 0;
  ok = ok && idx < 3;
  idx += (lane & 8) ? 3 : 0;
  ok = ok && idx < 5;
  idx += (lane & 16) ? 5 : 0;
  ok = ok && idx < 9 && !(lane & 1);
  return ok ? idx : -1;
}

__device__ __forceinline__ void add_row(float* dst, const float (&g)[kGrads]) {
  float4* d = reinterpret_cast<float4*>(dst);
  atomicAdd(d + 0, make_float4(g[0], g[1], g[2], g[3]));
  atomicAdd(d + 1, make_float4(g[4], g[5], g[6], g[7]));
  atomicAdd(d + 2, make_float4(g[8], 0.0f, 0.0f, 0.0f));
}

// `out`: the (P+1, 12) per-Gaussian table, or for kBwdNoAtomic the
// (kBwdBands, m_pad, 9) band records. `walked` (null, or one int per tile,
// zeros): the entries the tile's walk visited, the larger of its bands'.
// `block_w`: k1_block_w of the tile (not read by kBwdNoCull).
template <int V>
__global__ void __launch_bounds__(kBwdBandThreads)
blend_backward_kernel(const float* __restrict__ rows, long long m_pad,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_lens,
                      const int* __restrict__ tile_order,
                      const float* __restrict__ dl_dcolor,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib,
                      const int* __restrict__ sorted_gauss,
                      float* __restrict__ out, int* __restrict__ walked, int n_tx,
                      int tile_w, int tile_h, int width_p, int height_p, int block_w) {
  using L = BwdSmem<V>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_buf = reinterpret_cast<float*>(smem);                  // [kBufs][kBatchB][16]
  float4* s_box = reinterpret_cast<float4*>(smem + L::kBoxOffset);  // [kBatchB] (culled)
  float* s_red = reinterpret_cast<float*>(smem + L::kRedOffset);    // [kRedRows][kBatchB][9]
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_nmax;

  const int band = blockIdx.x % kBwdBands;
  const int tile = tile_order[blockIdx.x / kBwdBands];
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int red_idx = reduce_scatter_index(lane);
  const long long plane = static_cast<long long>(width_p) * height_p;

  WarpBlock wb{};
  float bx0 = 0.0f, bx1 = 0.0f, by0 = 0.0f, by1 = 0.0f;
  if constexpr (L::kCull) {
    wb = warp_block(band * kBwdBandWarps + warp, tx * tile_w, ty * tile_h, tile_w, block_w);
    bx0 = static_cast<float>(wb.col0);
    bx1 = static_cast<float>(wb.col0 + block_w - 1);
    by0 = static_cast<float>(wb.row0);
    by1 = static_cast<float>(wb.row0 + wb.block_h - 1);
  }
  float px[kPixPerThread], py[kPixPerThread];
  float dlr[kPixPerThread], dlg[kPixPerThread], dlb[kPixPerThread];
  float T[kPixPerThread], sdl[kPixPerThread];
  int nc[kPixPerThread];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    int row, col;
    if constexpr (L::kCull) {
      block_pixel(wb, lane, k, col, row);
    } else {
      const int flat = band * (kPixPerThread * kBwdBandThreads) + threadIdx.x + k * kBwdBandThreads;
      row = ty * tile_h + flat / tile_w;
      col = tx * tile_w + flat % tile_w;
    }
    const long long pix = static_cast<long long>(row) * width_p + col;
    px[k] = static_cast<float>(col);
    py[k] = static_cast<float>(row);
    dlr[k] = dl_dcolor[pix];
    dlg[k] = dl_dcolor[plane + pix];
    dlb[k] = dl_dcolor[2 * plane + pix];
    T[k] = final_t[pix];
    sdl[k] = 0.0f;
    nc[k] = n_contrib[pix];
    my_max = max(my_max, nc[k]);
  }
  if (threadIdx.x == 0) {
    s_nmax = 0;
    for (int i = 0; i < L::kBufs; ++i) mbar_init(&s_bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  atomicMax(&s_nmax, my_max);
  __syncthreads();
  // entries past every pixel's last contributor have zero gradient
  const int n_walk = min(s_nmax, len);
  const int n_batches = (n_walk + kBatchB - 1) / kBatchB;
  if (walked != nullptr && threadIdx.x == 0) atomicMax(walked + tile, max(n_walk, 0));

  // batch b holds entries [lo, hi) of the range, hi = n_walk - b * kBatchB
  auto issue = [&](int b) {
    const int hi = n_walk - b * kBatchB;
    const int lo = max(hi - kBatchB, 0);
    bulk_load(s_buf + (b & (L::kBufs - 1)) * kBatchB * kRowFloats, rows + (start + lo) * kRowFloats,
              static_cast<uint32_t>((hi - lo) * kRowFloats * 4), &s_bar[b & (L::kBufs - 1)]);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < L::kBufs && b < n_batches; ++b) issue(b);
  }

  for (int b = 0; b < n_batches; ++b) {
    const int hi = n_walk - b * kBatchB;
    const int lo = max(hi - kBatchB, 0);
    const int n = hi - lo;
    const float* buf = s_buf + (b & (L::kBufs - 1)) * kBatchB * kRowFloats;
    mbar_wait(&s_bar[b & (L::kBufs - 1)], (b >> (L::kBufs - 1)) & 1);
    if constexpr (L::kCull || V == kBwdSmemAtomic) {
      // the sums of the entries no lane adds to must read zero
      float4* red4 = reinterpret_cast<float4*>(s_red);
      for (int i = threadIdx.x; i < L::kRedRows * kBatchB * kGrads / 4; i += kBwdBandThreads)
        red4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (L::kCull) {
        for (int j = threadIdx.x; j < n; j += kBwdBandThreads) s_box[j] = cull_box(buf + j * kRowFloats);
      }
      __syncthreads();
    }

    auto entry = [&](int j) {
      const Splat s = row_splat(buf + j * kRowFloats);
      const int pos = lo + j + 1;  // 1-based in-range index
      float q[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) q[i] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float dx = __fsub_rn(s.x, px[k]);
        const float dy = __fsub_rn(s.y, py[k]);
        const float power = splat_power(s, dx, dy);
        const float g = expf(power);
        const float alpha = splat_alpha(s, g);
        if (!contributes(alpha, power) || pos > nc[k]) continue;
        any = true;
        const float inv_om = 1.0f / (1.0f - alpha);
        T[k] = T[k] * inv_om;  // T before this entry
        const float w = alpha * T[k];
        const float s1 = s.r * dlr[k] + s.g * dlg[k] + s.b * dlb[k];
        const float dalpha = T[k] * s1 - sdl[k] * inv_om;
        const float e = g * dalpha;       // dL/d(opa * G)
        const float gd = s.opa * e;
        const float t1 = gd * dx;
        const float t2 = gd * dy;
        q[0] += t1;
        q[1] += t2;
        q[2] += t1 * dx;
        q[3] += t1 * dy;
        q[4] += t2 * dy;
        q[5] += e;
        q[6] += w * dlr[k];
        q[7] += w * dlg[k];
        q[8] += w * dlb[k];
        sdl[k] += w * s1;
      }
      if constexpr (V == kBwdNoRed) {
        // every lane's sums stay computed; the first lane's are the record
#pragma unroll
        for (int i = 0; i < kGrads; ++i) asm volatile("" ::"f"(q[i]));
        if (threadIdx.x == 0) {
#pragma unroll
          for (int i = 0; i < kGrads; ++i) s_red[j * kGrads + i] = q[i];
        }
      } else if constexpr (V == kBwdSmemAtomic) {
        if (any) {
#pragma unroll
          for (int i = 0; i < kGrads; ++i) atomicAdd(&s_red[j * kGrads + i], q[i]);
        }
      } else {
        float v = 0.0f;
        if (__any_sync(kAllLanes, any)) {
          reduce_scatter9(q, lane);
          v = q[0];
        }
        if (red_idx >= 0) s_red[(warp * kBatchB + j) * kGrads + red_idx] = v;
      }
    };
    if constexpr (L::kCull) {
      // back to front, 32 boxes to a ballot; a skipped entry's sums stay zero
      for (int g_hi = n; g_hi > 0; g_hi -= 32) {
        const int g_lo = max(g_hi - 32, 0);
        bool meets = false;
        if (g_lo + lane < g_hi) meets = box_meets(s_box[g_lo + lane], bx0, bx1, by0, by1);
        for (unsigned mask = __ballot_sync(kAllLanes, meets); mask != 0;) {
          const int bit = 31 - __clz(mask);
          mask ^= 1u << bit;
          entry(g_lo + bit);
        }
      }
    } else {
      for (int j = n - 1; j >= 0; --j) entry(j);
    }
    __syncthreads();

    // sum the warps, turn the raw moments into gradients, add them per Gaussian
    for (int j = threadIdx.x; j < n; j += kBwdBandThreads) {
      float m[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) m[i] = 0.0f;
      for (int w = 0; w < L::kRedRows; ++w) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) m[i] += s_red[(w * kBatchB + j) * kGrads + i];
      }
      // the raw moments as gradients of (x, y, A, B, C, opa, r, g, b)
      auto grads = [&](float (&o)[kGrads]) {
        const float A = buf[j * kRowFloats + 2];
        const float B = buf[j * kRowFloats + 3];
        const float C = buf[j * kRowFloats + 4];
        o[0] = -(A * m[0] + B * m[1]);   // d x
        o[1] = -(C * m[1] + B * m[0]);   // d y
        o[2] = -0.5f * m[2];             // d A
        o[3] = -m[3];                    // d B
        o[4] = -0.5f * m[4];             // d C
        o[5] = m[5];                     // d opa
        o[6] = m[6];                     // d r
        o[7] = m[7];                     // d g
        o[8] = m[8];                     // d b
      };
      float o[kGrads];
      if constexpr (V == kBwdNoAtomic) {
        grads(o);
        float* dst = out + (band * m_pad + start + lo + j) * kGrads;
#pragma unroll
        for (int i = 0; i < kGrads; ++i) dst[i] = o[i];
      } else {
        bool nonzero = false;
#pragma unroll
        for (int i = 0; i < kGrads; ++i) nonzero = nonzero || m[i] != 0.0f;
        const int gid = sorted_gauss[start + lo + j];
        if (nonzero) {
          grads(o);
          add_row(out + static_cast<long long>(gid) * kTableStride, o);
        }
      }
    }
    __syncthreads();  // the buffer and s_red are free again
    if (threadIdx.x == 0 && b + L::kBufs < n_batches) issue(b + L::kBufs);
  }
}

// Launches variant V over the n_tx x n_ty tiles in `tile_order`.
template <int V>
cudaError_t launch_backward(const float* rows, long long m_pad, const int* tile_starts,
                            const int* tile_lens, const int* tile_order,
                            const float* dl_dcolor, const float* final_t,
                            const int* n_contrib, const int* sorted_gauss, float* out,
                            int* walked, int n_tx, int n_ty, int tile_w, int tile_h,
                            cudaStream_t stream) {
  const int block_w = k1_block_w(tile_h, tile_w);
  if (block_w == 0 || tile_order == nullptr) return cudaErrorInvalidValue;
  if (V != kBwdNoAtomic && sorted_gauss == nullptr) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int n_tiles = n_tx * n_ty;
  if (n_tiles <= 0) return cudaSuccess;
  blend_backward_kernel<V><<<n_tiles * kBwdBands, kBwdBandThreads, BwdSmem<V>::kBytes, stream>>>(
      rows, m_pad, tile_starts, tile_lens, tile_order, dl_dcolor, final_t, n_contrib,
      sorted_gauss, out, walked, n_tx, tile_w, tile_h, n_tx * tile_w, n_ty * tile_h, block_w);
  return cudaGetLastError();
}

}  // namespace
}  // namespace glic
