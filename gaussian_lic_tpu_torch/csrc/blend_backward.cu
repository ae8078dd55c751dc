// K2: tile blend backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_lic_tpu/ops/blend_pallas.py:
// _backward_kernel / blend_backward (the reference's PerGaussianRenderCUDA,
// backward.cu:379-597).
//
// Per tile it walks the splat range back to front from min(max n_contrib,
// len), rebuilds each pixel's transmittance by division from final_T
// (T <- T / (1 - alpha), as a multiply by the reciprocal) and keeps Sdl, the
// running suffix dot of colour with dL/dpix, so that
//   dL/dalpha = T (rgb . dL) - Sdl / (1 - alpha),
// exactly the Pallas kernel's arithmetic. It writes per-entry gradients
// (M_pad, 9) for (x, y, A, B, C, opa, r, g, b); the per-Gaussian sum is a
// separate index_add_ in ops/rasterize.py.
//
// What bounds it on this card: per applied (entry, pixel) pair ~40 float
// ops and one expf, plus a reduction of 9 sums over the tile's 1024 pixels
// for every entry. The reduction is the cost to watch: the design does it
// with warp shuffles (skipped when no pixel of the warp applied the entry)
// into a shared [warp][entry][9] buffer, and one pass per batch sums the 8
// warps. Each entry belongs to exactly one tile, so each block owns its
// entries' output rows and needs no atomics.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace glic {
namespace {

constexpr int kBatchB = 128;                 // entries staged per round
constexpr int kWarps = kThreads / 32;
constexpr int kGrads = 9;

__global__ void __launch_bounds__(kThreads)
blend_backward_kernel(const float* __restrict__ rows, long long m_pad,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_lens,
                      const float* __restrict__ dl_dcolor,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib,
                      float* __restrict__ grads, int n_tx, int tile_w,
                      int tile_h, int width_p, int height_p) {
  __shared__ Splat s_splat[kBatchB];
  __shared__ float s_red[kWarps][kBatchB][kGrads];
  __shared__ int s_nmax;

  const int tile = blockIdx.x;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long plane = static_cast<long long>(width_p) * height_p;

  float px[kPixPerThread], py[kPixPerThread];
  float dlr[kPixPerThread], dlg[kPixPerThread], dlb[kPixPerThread];
  float T[kPixPerThread], sdl[kPixPerThread];
  int nc[kPixPerThread];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int flat = threadIdx.x + k * kThreads;
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
  if (threadIdx.x == 0) s_nmax = 0;
  __syncthreads();
  atomicMax(&s_nmax, my_max);
  __syncthreads();
  // entries past every pixel's last contributor have zero gradient
  const int n_walk = min(s_nmax, len);

  for (int hi = n_walk; hi > 0; hi -= kBatchB) {
    const int lo = max(hi - kBatchB, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's shared reads are done
    if (threadIdx.x < n) s_splat[threadIdx.x] = load_splat(rows, start + lo + threadIdx.x);
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      const Splat s = s_splat[j];
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
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) {
          float v = q[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) s_red[warp][j][i] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) s_red[warp][j][i] = 0.0f;
      }
    }
    __syncthreads();

    // sum the warps and turn the raw moments into per-entry gradients
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float m[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_red[w][j][i];
        m[i] = v;
      }
      const Splat s = s_splat[j];
      const float A = -2.0f * s.nA;
      const float C = -2.0f * s.nC;
      float* out = grads + (start + lo + j) * kGrads;
      out[0] = -(A * m[0] + s.B * m[1]);   // d x
      out[1] = -(C * m[1] + s.B * m[0]);   // d y
      out[2] = -0.5f * m[2];               // d A
      out[3] = -m[3];                      // d B
      out[4] = -0.5f * m[4];               // d C
      out[5] = m[5];                       // d opa
      out[6] = m[6];                       // d r
      out[7] = m[7];                       // d g
      out[8] = m[8];                       // d b
    }
  }
}

}  // namespace
}  // namespace glic

extern "C" int glic_blend_backward(const float* rows, long long m_pad,
                                   const int* tile_starts, const int* tile_lens,
                                   const float* dl_dcolor, const float* final_t,
                                   const int* n_contrib, float* grads, int n_tx,
                                   int n_ty, int tile_w, int tile_h,
                                   void* stream) {
  if (tile_w * tile_h != glic::kTilePix) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n_tx * n_ty;
  if (n_tiles > 0) {
    glic::blend_backward_kernel<<<n_tiles, glic::kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        rows, m_pad, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib,
        grads, n_tx, tile_w, tile_h, n_tx * tile_w, n_ty * tile_h);
  }
  return static_cast<int>(cudaGetLastError());
}
