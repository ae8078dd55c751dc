// K1: tile blend forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_lic_tpu/ops/blend_pallas.py:
// _forward_kernel / blend_forward (the reference's renderCUDA,
// forward.cu:321-481).
//
// What bounds it on this card: per (entry, pixel) pair it does one expf and
// ~20 float ops, and it reads each entry's 9 floats once per tile (36 B
// against 1024 pixel evaluations), so it is bound by the SM's arithmetic
// and by the serial front-to-back dependence per pixel, not by device
// memory. The design: one block of 256 threads per 32x32 tile, 4 pixels per
// thread, their T/colour state in registers; the block stages 256 entries at
// a time into shared memory (one entry per thread, 9 floats), and every
// thread walks the batch reading the same shared address (a broadcast, no
// bank conflicts). The block leaves the walk as soon as every pixel of the
// tile has terminated (__syncthreads_count). No atomics: each block writes
// only its own tile's pixels.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace glic {
namespace {

constexpr int kBatch = kThreads;  // entries staged per round, one per thread

__global__ void __launch_bounds__(kThreads)
blend_forward_kernel(const float* __restrict__ rows, long long m_pad,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_lens,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib, int n_tx, int tile_w,
                     int tile_h, int width_p, int height_p, int no_color) {
  __shared__ Splat s_splat[kBatch];

  const int tile = blockIdx.x;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  int last[kPixPerThread];
  bool done[kPixPerThread];
  long long pix[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int flat = threadIdx.x + k * kThreads;
    const int row = ty * tile_h + flat / tile_w;
    const int col = tx * tile_w + flat % tile_w;
    px[k] = static_cast<float>(col);
    py[k] = static_cast<float>(row);
    pix[k] = static_cast<long long>(row) * width_p + col;
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    last[k] = 0;
    done[k] = false;
  }

  for (int base = 0; base < len; base += kBatch) {
    int mine_done = 1;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) mine_done &= done[k] ? 1 : 0;
    // barrier: also orders the previous batch's shared reads before the refill
    if (__syncthreads_count(mine_done) == kThreads) break;
    const int n = min(kBatch, len - base);
    if (threadIdx.x < n) s_splat[threadIdx.x] = load_splat(rows, start + base + threadIdx.x);
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const Splat s = s_splat[j];
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

extern "C" int glic_blend_forward(const float* rows, long long m_pad,
                                  const int* tile_starts, const int* tile_lens,
                                  float* color, float* final_t, int* n_contrib,
                                  int n_tx, int n_ty, int tile_w, int tile_h,
                                  int no_color, void* stream) {
  if (tile_w * tile_h != glic::kTilePix) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n_tx * n_ty;
  if (n_tiles > 0) {
    glic::blend_forward_kernel<<<n_tiles, glic::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        rows, m_pad, tile_starts, tile_lens, color, final_t, n_contrib, n_tx,
        tile_w, tile_h, n_tx * tile_w, n_ty * tile_h, no_color);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* glic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
