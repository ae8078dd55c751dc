// Timing variants of K8, the binning's slot keys, hand-written for Hopper
// (sm_90a). Off the main path.
//
// Each variant is an instantiation of K8's own kernel template
// (bin_keys.cuh, which lists them), and `base` is the instantiation K8
// launches (bin_keys.cu): `rcp`, `vecload`, `fold` and `listed` compute K8's
// outputs bit for bit, `nopower`, `onestore`, `notable`, `memonly` and
// `listed_nopower` are timing only. The numbering is K8_VARIANT_IDS in
// ops/tiles.py. glic_l2_fetch_granularity sets the L2's fetch size hint for
// tools/probe_torch_binning_loss.py.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "bin_keys.cuh"

// The arguments of glic_bin_keys after the variant.
extern "C" int glic_bin_keys_probe(int variant, const float* xy, long long xy_stride,
                                   const float* conic, long long conic_stride,
                                   const float* depth, const long long* dkey,
                                   const float* opacity, const float* radius, const bool* active,
                                   long long P, int K, int depth_bits, int n_tx, int n_ty,
                                   int tile_w, int tile_h, int band_ty0, int band_n_ty,
                                   float opa_thr, int* keys, int* touched, int* sums,
                                   void* stream) {
  using namespace glic_k8;
  if (P == 0) return 0;
  Args a;
  if (!make_args(xy, xy_stride, conic, conic_stride, depth, dkey, opacity, radius, active, P, K,
                 depth_bits, n_tx, n_ty, tile_w, tile_h, band_ty0, band_n_ty, opa_thr, keys,
                 touched, sums, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GLIC_CASE(V) \
  case V:            \
    return static_cast<int>(launch_bin_keys<V>(a, s));
    GLIC_CASE(kK8Base)
    GLIC_CASE(kK8NoPower)
    GLIC_CASE(kK8OneStore)
    GLIC_CASE(kK8Rcp)
    GLIC_CASE(kK8VecLoad)
    GLIC_CASE(kK8NoTable)
    GLIC_CASE(kK8MemOnly)
    GLIC_CASE(kK8Fold)
    GLIC_CASE(kK8Listed)
    GLIC_CASE(kK8ListedNoPower)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cudaLimitMaxL2FetchGranularity (a hint to the L2 of how many bytes to fetch
// on a miss, 0-128): *previous gets the current value, then `bytes` is set
// when it is not negative. For timing K8's table reads.
extern "C" int glic_l2_fetch_granularity(int bytes, int* previous) {
  size_t cur = 0;
  cudaError_t e = cudaDeviceGetLimit(&cur, cudaLimitMaxL2FetchGranularity);
  if (e != cudaSuccess) return static_cast<int>(e);
  *previous = static_cast<int>(cur);
  if (bytes >= 0) e = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, bytes);
  return static_cast<int>(e);
}
