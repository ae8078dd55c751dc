// Timing variants of K9, the binning's sorted list and tile ranges,
// hand-written for Hopper (sm_90a). Off the main path.
//
// Each variant is an instantiation of one of K9's kernel templates
// (bin_ranges.cuh, which lists them), and `base` is the instantiation K9
// launches (bin_ranges.cu): `hist`, `first` (the first design),
// `mod32` and `fastdiv` compute K9's outputs bit for bit, `memonly` and
// `noatomic` are timing only. The numbering is K9_VARIANT_IDS in
// ops/tiles.py.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "bin_ranges.cuh"

// The arguments of glic_bin_ranges after the variant; the variants that
// build the histogram (all but base with touched) need zeros in cnt.
extern "C" int glic_bin_ranges_probe(int variant, const int* keys, const long long* slots,
                                     long long m_eff, long long m_pad, int P, int T,
                                     int depth_bits, int tile0, long long magic, int shift,
                                     const int* touched, const int* sums, const int* slot_keys,
                                     long long n_slot_keys, int* sorted_gauss, int* starts,
                                     int* lens, int* cnt, void* stream) {
  using namespace glic_k9;
  Args a;
  if (!make_args(keys, slots, m_eff, m_pad, P, T, depth_bits, tile0, magic, shift, touched, sums,
                 slot_keys, n_slot_keys, sorted_gauss, starts, lens, cnt, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GLIC_CASE(V) \
  case V:            \
    return static_cast<int>(launch_bin_ranges<V>(a, s));
    GLIC_CASE(kK9Base)
    GLIC_CASE(kK9Hist)
    GLIC_CASE(kK9First)
    GLIC_CASE(kK9MemOnly)
    GLIC_CASE(kK9NoAtomic)
    GLIC_CASE(kK9Mod32)
    GLIC_CASE(kK9FastDiv)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
