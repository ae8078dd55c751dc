// K2: tile blend backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_lic_tpu/ops/blend_pallas.py:
// _backward_kernel / blend_backward (the reference's PerGaussianRenderCUDA,
// backward.cu:379-597), and the per-Gaussian sum after it
// (ops/rasterize.py's reduction, the reference's atomicAdd at :585-595).
//
// Per tile (or per pixel band of a tile) it walks the splat range back to
// front from min(max n_contrib, len), rebuilds each pixel's transmittance by
// division from final_T (T <- T / (1 - alpha), as a multiply by the
// reciprocal) and keeps Sdl, the running suffix dot of colour with dL/dpix,
// so that
//   dL/dalpha = T (rgb . dL) - Sdl / (1 - alpha),
// exactly the Pallas kernel's per-pixel arithmetic (blend_common.cuh), so
// every (entry, pixel) decision is K1's. It sums each entry's 9 gradients
// (x, y, A, B, C, opa, r, g, b) over the pixels and adds them into the
// per-Gaussian table at sorted_gauss[entry]; only the order of summation
// differs from the plain version.
//
// What bounds it on this card: FP32 issue slots. Each (entry, pixel) pair up
// to the pixel's n_contrib costs ~19 FP32 instructions and an expf's MUFU to
// test, and an applied pair ~26 more and a reciprocal's MUFU; DRAM traffic
// is small. On top comes a 9-sum reduction over the block's pixels for every
// entry. The first design (kept line for line as K4's `base`,
// blend_probe_backward.cu) spent 54% of its time in that reduction and 31%
// in a synchronous batch refill. This one:
//  (a) stages batches of 128 gathered rows (64 B each, one contiguous run)
//      with a 1-D bulk copy (cp.async.bulk + mbarrier) into a double buffer:
//      batch k+1 lands while batch k is walked;
//  (b) reduces an entry's 9 sums over a warp with a butterfly reduce-scatter
//      (5 + 3 + 2 + 1 + 1 = 12 shuffles, after which 9 lanes hold one warp sum
//      each; the first design used 45), then one shared store per entry and
//      warp; one pass per batch sums the warps;
//  (c) adds each entry's sums into the (P+1, 12) table with three vector
//      atomics (red.global.add.v4.f32), skipped when all nine are zero, so
//      no (M_pad, 9) buffer and no index_add_ pass;
//  (d) splits each tile into 4 pixel bands of 256 pixels, one block of 64
//      threads each, whose partial sums simply add in the table, and launches
//      the tiles longest first (a tile order the caller computes on the
//      card). Of 1 / 2 / 4 bands, each in tile order and longest first, this
//      was the fastest at the 1M-Gaussian train step; the two buffers and the
//      warp partials then take 25,600 B of shared memory, under the 48 KB a
//      launch gets without an opt-in.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace glic {
namespace {

constexpr int kBatchB = 128;                         // entries staged per round
constexpr int kGrads = 9;
constexpr int kTableStride = 12;                     // floats per per-Gaussian row
constexpr int kBufBytes = kBatchB * kRowFloats * 4;  // one staged batch: 8 KB
constexpr int kBands = 4;                            // blocks per tile
constexpr int kBandThreads = kThreads / kBands;      // threads per block
constexpr int kBandWarps = kBandThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a block: the two staged batches, then the warps'
// per-entry partial sums [warp][entry][9].
constexpr int kSmemBytes = 2 * kBufBytes + kBandWarps * kBatchB * kGrads * 4;
static_assert(kSmemBytes <= 48 * 1024, "K2's shared memory needs the opt-in attribute");

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
    q[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// After this, lane `lane` holds in q[0] the warp sum of moment
// reduce_scatter_index(lane) (when that is valid): 9 -> 5 -> 3 -> 2 -> 1 -> 1.
__device__ __forceinline__ void reduce_scatter9(float* q, int lane) {
  reduce_scatter_level<16, 9>(q, lane & 16);
  reduce_scatter_level<8, 5>(q, lane & 8);
  reduce_scatter_level<4, 3>(q, lane & 4);
  reduce_scatter_level<2, 2>(q, lane & 2);
  q[0] += __shfl_xor_sync(kFull, q[0], 1);
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

__global__ void __launch_bounds__(kBandThreads)
blend_backward_kernel(const float* __restrict__ rows, long long m_pad,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_lens,
                      const int* __restrict__ tile_order,
                      const float* __restrict__ dl_dcolor,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib,
                      const int* __restrict__ sorted_gauss,
                      float* __restrict__ table, int n_tx, int tile_w,
                      int tile_h, int width_p, int height_p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_buf = reinterpret_cast<float*>(smem);                    // [2][kBatchB][16]
  float* s_red = reinterpret_cast<float*>(smem + 2 * kBufBytes);    // [warp][kBatchB][9]
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_nmax;

  const int band = blockIdx.x % kBands;
  const int tile = tile_order[blockIdx.x / kBands];
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int red_idx = reduce_scatter_index(lane);
  const long long plane = static_cast<long long>(width_p) * height_p;

  float px[kPixPerThread], py[kPixPerThread];
  float dlr[kPixPerThread], dlg[kPixPerThread], dlb[kPixPerThread];
  float T[kPixPerThread], sdl[kPixPerThread];
  int nc[kPixPerThread];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int flat = band * (kPixPerThread * kBandThreads) + threadIdx.x + k * kBandThreads;
    const int row = ty * tile_h + flat / tile_w;
    const int col = tx * tile_w + flat % tile_w;
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
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  atomicMax(&s_nmax, my_max);
  __syncthreads();
  // entries past every pixel's last contributor have zero gradient
  const int n_walk = min(s_nmax, len);
  const int n_batches = (n_walk + kBatchB - 1) / kBatchB;

  // batch b holds entries [lo, hi) of the range, hi = n_walk - b * kBatchB
  auto issue = [&](int b) {
    const int hi = n_walk - b * kBatchB;
    const int lo = max(hi - kBatchB, 0);
    bulk_load(s_buf + (b & 1) * kBatchB * kRowFloats, rows + (start + lo) * kRowFloats,
              static_cast<uint32_t>((hi - lo) * kRowFloats * 4), &s_bar[b & 1]);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2 && b < n_batches; ++b) issue(b);
  }

  for (int b = 0; b < n_batches; ++b) {
    const int hi = n_walk - b * kBatchB;
    const int lo = max(hi - kBatchB, 0);
    const int n = hi - lo;
    const float* buf = s_buf + (b & 1) * kBatchB * kRowFloats;
    mbar_wait(&s_bar[b & 1], (b >> 1) & 1);

    for (int j = n - 1; j >= 0; --j) {
      const float4 r0 = *reinterpret_cast<const float4*>(buf + j * kRowFloats);
      const float4 r1 = *reinterpret_cast<const float4*>(buf + j * kRowFloats + 4);
      Splat s;
      s.x = r0.x;
      s.y = r0.y;
      s.nA = -0.5f * r0.z;
      s.B = r0.w;
      s.nC = -0.5f * r1.x;
      s.opa = r1.y;
      s.r = r1.z;
      s.g = r1.w;
      s.b = buf[j * kRowFloats + 8];
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
      float v = 0.0f;
      if (__any_sync(kFull, any)) {
        reduce_scatter9(q, lane);
        v = q[0];
      }
      if (red_idx >= 0) s_red[(warp * kBatchB + j) * kGrads + red_idx] = v;
    }
    __syncthreads();

    // sum the warps, turn the raw moments into gradients, add them per Gaussian
    for (int j = threadIdx.x; j < n; j += kBandThreads) {
      float m[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) m[i] = 0.0f;
      for (int w = 0; w < kBandWarps; ++w) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) m[i] += s_red[(w * kBatchB + j) * kGrads + i];
      }
      bool nonzero = false;
#pragma unroll
      for (int i = 0; i < kGrads; ++i) nonzero = nonzero || m[i] != 0.0f;
      const int gid = sorted_gauss[start + lo + j];
      if (nonzero) {
        const float A = buf[j * kRowFloats + 2];
        const float B = buf[j * kRowFloats + 3];
        const float C = buf[j * kRowFloats + 4];
        float out[kGrads];
        out[0] = -(A * m[0] + B * m[1]);   // d x
        out[1] = -(C * m[1] + B * m[0]);   // d y
        out[2] = -0.5f * m[2];             // d A
        out[3] = -m[3];                    // d B
        out[4] = -0.5f * m[4];             // d C
        out[5] = m[5];                     // d opa
        out[6] = m[6];                     // d r
        out[7] = m[7];                     // d g
        out[8] = m[8];                     // d b
        add_row(table + static_cast<long long>(gid) * kTableStride, out);
      }
    }
    __syncthreads();  // the buffer and s_red are free again
    if (threadIdx.x == 0 && b + 2 < n_batches) issue(b + 2);
  }
}

}  // namespace
}  // namespace glic

// `table`: (n_gauss + 1, 12) float32 zeros, 16-byte aligned; entry e adds
// its 9 gradients to row sorted_gauss[e], which must lie in [0, n_gauss]
// (the dead id n_gauss to the last row). `tile_order`: (n_tx * n_ty,) int32
// permutation of the tiles, longest first. `rows` must be 16-byte aligned
// (the bulk copy's rule).
extern "C" int glic_blend_backward(const float* rows, long long m_pad,
                                   const int* tile_starts, const int* tile_lens,
                                   const int* tile_order, const float* dl_dcolor,
                                   const float* final_t, const int* n_contrib,
                                   const int* sorted_gauss, float* table,
                                   int n_tx, int n_ty, int tile_w, int tile_h, void* stream) {
  using namespace glic;
  if (tile_w * tile_h != kTilePix || tile_order == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_tiles = n_tx * n_ty;
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_backward_kernel<<<n_tiles * kBands, kBandThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      rows, m_pad, tile_starts, tile_lens, tile_order, dl_dcolor, final_t, n_contrib,
      sorted_gauss, table, n_tx, tile_w, tile_h, n_tx * tile_w, n_ty * tile_h);
  return static_cast<int>(cudaGetLastError());
}
