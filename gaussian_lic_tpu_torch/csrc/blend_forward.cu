// K1: tile blend forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_lic_tpu/ops/blend_pallas.py:
// _forward_kernel / blend_forward (the reference's renderCUDA,
// forward.cu:321-481).
//
// What bounds it on this card: per (entry, pixel) pair it tests, one expf
// and ~20 float ops; device memory is no limit (each entry's 64-byte row is
// read once per tile). The first design tested every entry of a tile at
// every pixel, 1.39e9 pairs at the 1M-Gaussian train step, of which
// 1.8% apply: the tests and their expf were its time. This design tests only
// the pairs that can apply:
//  (a) each warp owns a compact block of 128 pixels of the tile, 4 pixels per
//      thread (k1_block_w, blend_common.cuh). Once per CUDA block, one thread per
//      staged entry computes the bounding box of the entry's alpha >= 1/255
//      ellipse (cull_box), widened so that it holds every pixel at which the
//      float arithmetic of blend_common.cuh could apply the entry. Each warp
//      tests 32 boxes against its block at a time (one ballot) and walks only
//      the entries whose box meets it, in order. A skipped pair is one that
//      the per-pixel test would reject, so color, final_T and n_contrib are
//      the first design's bit for bit;
//  (b) batches of 128 gathered rows arrive by a 1-D bulk copy
//      (cp.async.bulk + mbarrier, blend_common.cuh) into a double buffer:
//      batch b+1 lands while b is walked. The block leaves the walk once
//      every pixel of its band has stopped (__syncthreads_count per batch);
//  (c) a tile is split into 2 pixel bands of whole warp blocks, one
//      CUDA block each. The forward walk is independent per pixel, so bands
//      need no sum between blocks.
// K1's warp blocks are 8x16 pixels, 2 bands a tile, launched in tile order:
// the fastest of the layouts timed at the 1M-Gaussian train step (16x8 and
// 32x4 blocks; 1, 2 or 4 bands; tile order or longest first, with the argsort
// it needs on every call counted; PERF.md). A tile of fewer than 16 rows or 8
// columns has no room for them: its blocks keep 128 pixels, as wide (16x8,
// 32x4, 64x2, 128x1) or as narrow (4x32, 2x64, 1x128) as the tile asks. The
// block's shape is a kernel argument: only the threads' pixel coordinates,
// computed once, depend on it.
//
// The kernel is blend_forward.cuh, templated on the K3 probe variant; this
// entry launches its base instantiation, blend_probe_forward.cu every variant.
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_forward.cuh"

// K1. `rows` must be 16-byte aligned (the bulk copy's rule).
extern "C" int glic_blend_forward(const float* rows, long long m_pad, const int* tile_starts,
                                  const int* tile_lens, float* color, float* final_t,
                                  int* n_contrib, int n_tx, int n_ty, int tile_w, int tile_h,
                                  int no_color, void* stream) {
  using namespace glic;
  return static_cast<int>(launch_forward<kFwdBase>(
      rows, m_pad, tile_starts, tile_lens, color, final_t, n_contrib, nullptr, n_tx, n_ty,
      tile_w, tile_h, no_color, RawSplat{}, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* glic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
