// K9: the binning's sorted list and tile ranges, hand-written for Hopper
// (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/ops/tiles.py:327-378 (the budget cut, searchsorted over
// the sorted tile ids, the Gaussian id of every entry and the per-Gaussian
// surviving counts; the reference's identifyTileRanges,
// rasterizer_impl.cu:395-429). In PyTorch that was ~10 launches: a
// searchsorted, a %, a where, a cat, and a (K, P) compare of every slot
// against the budget's boundary key.
//
// What bounds it on this card: device memory. Per entry of the sorted list it
// reads a 4-byte key and an 8-byte slot and writes a 4-byte Gaussian id
// (about 29 MB at 1,782,784 entries, ~0.01 ms at 3.35 TB/s); the tile ranges
// and counts are small. One thread per entry, one pass:
//   * sorted_gauss[i] = slot % P for a live entry of [0, m_eff), else P (the
//     dead id, also for the tail up to m_pad);
//   * tile_starts: the entry where the tile id steps from t_{i-1} to t_i
//     writes its position as the start of every tile in (t_{i-1}, t_i], and
//     one more thread writes m_eff for the tiles past the last entry: the
//     searchsorted(side="left") of every tile, empty ones included;
//   * tile_lens: a tile's first entry subtracts its position and its last
//     adds its end (two integer atomics per non-empty tile);
//   * cnt: an atomic histogram of the live entries of [0, m_eff). After the
//     stable sort those are exactly the slots whose (key, slot) sorts below
//     the m_eff-th entry's, JAX's survivor compare.
// Nothing reads back to the host: the bundles capture it in a CUDA graph.
//
// Keys are K8's (csrc/bin_keys.cu): the uint32 key with its top bit
// flipped, sorted as int32. Tile ids are key >> depth_bits - tile0, capped
// at T: the dead key's field passes every tile.
//
// bin_ranges.cuh holds the design (E entries a thread from 16-byte loads,
// the neighbours' tile ids by warp shuffles, the remainder from a magic
// multiplier, cnt as the JAX package computes it from K8's touched, sums
// and keys, without atomics or zeros) and the first design (one thread an
// entry, an atomic histogram) among its timing variants
// (bin_ranges_probe.cu); this entry launches its base instantiation.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "bin_ranges.cuh"

// K9 over the first m_eff entries of the sorted keys and slots: sorted_gauss
// (m_pad,), starts (T,), and lens (T,), which must hold zeros, and cnt (P,).
// magic and shift: slot / P as (slot * magic) >> shift (ops/tiles.py
// k9_fastdiv). With touched (K8's (P,) live slots per Gaussian), sums (K8's
// (2,)) and slot_keys (K8's (n_slot_keys,) keys in slot order), cnt is
// written whole; without them (null) cnt must hold zeros.
extern "C" int glic_bin_ranges(const int* keys, const long long* slots, long long m_eff,
                               long long m_pad, int P, int T, int depth_bits, int tile0,
                               long long magic, int shift, const int* touched, const int* sums,
                               const int* slot_keys, long long n_slot_keys, int* sorted_gauss,
                               int* starts, int* lens, int* cnt, void* stream) {
  using namespace glic_k9;
  Args a;
  if (!make_args(keys, slots, m_eff, m_pad, P, T, depth_bits, tile0, magic, shift, touched, sums,
                 slot_keys, n_slot_keys, sorted_gauss, starts, lens, cnt, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bin_ranges<kK9Base>(a, static_cast<cudaStream_t>(stream)));
}
