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
// is small. On top comes a 9-sum reduction over a warp's pixels for every
// entry the warp walks. The first design spent 54% of its time in that
// reduction and 31% in a synchronous batch refill (as its K4 probes
// measured); the next walked every entry of a tile at every pixel up to
// n_contrib, of which it applied under 2%. This one:
//  (a) stages batches of 128 gathered rows (64 B each, one contiguous run)
//      with a 1-D bulk copy (cp.async.bulk + mbarrier) into a double buffer:
//      batch k+1 lands while batch k is walked;
//  (b) culls as K1 does: each warp owns one of K1's compact 128-pixel blocks
//      of the tile (8x16, or as wide or as narrow as the tile's shape asks:
//      k1_block_w, warp_block, block_pixel in blend_common.cuh), a per-batch
//      pass writes every staged entry's footprint box (cull_box: the pixels
//      outside it cannot pass the alpha >= 1/255 test), and each warp tests
//      32 boxes against its block with one ballot and walks only the entries
//      that meet it. A skipped pair is one the arithmetic would not apply,
//      so the gradients are those of the walk without the cull, summed in
//      another order; a NaN-opacity row's box is every pixel, and
//      splat_alpha skips it;
//  (c) reduces an entry's 9 sums over a warp with a butterfly reduce-scatter
//      (5 + 3 + 2 + 1 + 1 = 12 shuffles, after which 9 lanes hold one warp sum
//      each; the first design used 45), then one shared store per entry and
//      warp into a per-warp buffer zeroed before each batch (an entry a warp
//      skips reads zero there); one pass per batch sums the warps;
//  (d) adds each entry's sums into the (P+1, 12) table with three vector
//      atomics (red.global.add.v4.f32), skipped when all nine are zero, so
//      no (M_pad, 9) buffer and no index_add_ pass;
//  (e) splits each tile into 4 bands of two warp blocks, one CUDA block of 64
//      threads each, whose partial sums simply add in the table; a band
//      walks from the largest n_contrib of its own 256 pixels. The tiles
//      are launched longest first (a tile order the caller computes on the
//      card). The two buffers and the warp partials take 25,600 B of shared
//      memory and the boxes 2,048 B: 27,648 B, under the 48 KB a launch gets
//      without an opt-in.
// The bound it now meets: at chip_smoke.py's 1M-Gaussian train step
// (640x512, 32x32 tiles, an NVIDIA H100 80GB HBM3 at 700 W) it takes 1.165
// ms, 68% of the walk bound (0.791 ms: the FP32 and MUFU work of every pair
// up to n_contrib, at the card's peak issue rate); without the cull (the K4
// probe nocull) 2.934 ms, 27%. 72 registers, no spill.
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
