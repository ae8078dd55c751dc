// K8: the binning's slot keys, hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/ops/tiles.py:181-270 compute_slot_keys_kmajor, with
// gaussian_rects (:113), depth_key (:59) and ops/projection.py:210
// max_contrib_power_rect_components (the reference's duplicateWithKeys with
// StopThePop's exact per-tile cull, rasterizer_impl.cu:59-193,
// forward.cu:151-230). In PyTorch that chain was ~35 separate launches over
// (K, P) int64 and float arrays.
//
// What bounds it on this card: device memory. Per Gaussian it reads the
// mean and conic (20 B of the (P + 1, 16) splat table, a 64-B row stride),
// depth, opacity, radius and the active flag (about 33 B) and writes K
// 4-byte keys and its live tile count; at P = 2^20, K = 8 that is ~0.02 ms
// at 3.35 TB/s. One thread per Gaussian computes the rect, the depth key
// and the cull threshold once and loops over its K slots; slot k's key goes
// to k P + p (k-major, the JAX order), so a warp's stores are coalesced for
// each k. The rect tiles lost to the K-slot cap and the live slots are
// summed by a block reduction and one integer atomic per block (exact in
// any order). The kernel is bin_keys.cuh's template, whose timing variants
// (bin_keys_probe.cu) show that this time is the kernel's memory traffic:
// its loads and stores alone take all but a few percent of it, so a design
// that evaluates the cull with every lane busy (the listed design, among
// the variants) gains nothing. This entry launches the base instantiation.
//
// Every float operation is the plain chain's (ops/tiles.py) as PyTorch runs
// it on the card, one *_rn intrinsic each, in its order: nvcc would contract
// a * b + c into an FMA, PyTorch's eager ops never do. A tensor divided by
// a Python number is multiplied by the number's float reciprocal (PyTorch's
// CUDA div with a CPU scalar), torch.clamp keeps a NaN, and float -> int32
// truncates after the +-2^30 clamp (cvt.rzi takes NaN to 0). One flipped
// `power <= threshold` decision would change the list.
//
// Keys are the uint32 (tile << depth_bits) | depth key with the top bit
// flipped, so they sort as int32 in the uint32 order; a dead slot's 0xFFFFFFFF
// becomes 0x7FFFFFFF and sorts last.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "bin_keys.cuh"

// K8 over P Gaussians: keys (K P,) int32, touched (P,), and sums (2,) int32
// (the truncated rect tiles, the live slots), which must hold zeros.
extern "C" int glic_bin_keys(const float* xy, long long xy_stride, const float* conic,
                             long long conic_stride, const float* depth, const long long* dkey,
                             const float* opacity, const float* radius, const bool* active,
                             long long P, int K, int depth_bits, int n_tx, int n_ty, int tile_w,
                             int tile_h, int band_ty0, int band_n_ty, float opa_thr, int* keys,
                             int* touched, int* sums, void* stream) {
  using namespace glic_k8;
  if (P == 0) return 0;
  Args a;
  if (!make_args(xy, xy_stride, conic, conic_stride, depth, dkey, opacity, radius, active, P, K,
                 depth_bits, n_tx, n_ty, tile_w, tile_h, band_ty0, band_n_ty, opa_thr, keys,
                 touched, sums, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bin_keys<kK8Base>(a, static_cast<cudaStream_t>(stream)));
}
