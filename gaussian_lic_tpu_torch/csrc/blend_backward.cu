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
// entry. The first design spent 54% of its time in that reduction and 31%
// in a synchronous batch refill (as its K4 probes measured). This one:
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
// The kernel is blend_backward.cuh, templated on the K4 probe variant; this
// entry launches its base instantiation, blend_probe_backward.cu every
// variant. Plain C interface, loaded with ctypes by
// gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_backward.cuh"

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
  return static_cast<int>(launch_backward<kBwdBase>(
      rows, m_pad, tile_starts, tile_lens, tile_order, dl_dcolor, final_t, n_contrib,
      sorted_gauss, table, nullptr, n_tx, n_ty, tile_w, tile_h,
      static_cast<cudaStream_t>(stream)));
}
