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
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFlip = 0x80000000u;
constexpr unsigned kInvalid = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned key_at(const int* keys, long long i) {
  return static_cast<unsigned>(__ldg(keys + i)) ^ kFlip;
}

__device__ __forceinline__ int tile_of(unsigned key, int depth_bits, int tile0, int T) {
  return static_cast<int>(min(static_cast<long long>(key >> depth_bits) - tile0,
                              static_cast<long long>(T)));
}

__global__ void __launch_bounds__(kThreads) bin_ranges_kernel(
    const int* __restrict__ keys, const long long* __restrict__ slots, long long m_eff,
    long long m_pad, long long n_threads, int P, int T, int depth_bits, int tile0,
    int* __restrict__ sorted_gauss, int* __restrict__ starts, int* __restrict__ lens,
    int* __restrict__ cnt) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_threads) return;
  // tile of the entry before: -1 before the first
  const int prev =
      i == 0 || i > m_eff ? -1 : tile_of(key_at(keys, i - 1), depth_bits, tile0, T);
  if (i >= m_eff) {  // past the list: the tiles after its last entry start at m_eff
    if (i == m_eff)
      for (int b = max(prev + 1, 0); b < T; ++b) starts[b] = static_cast<int>(m_eff);
    if (i < m_pad) sorted_gauss[i] = P;
    return;
  }
  const unsigned key = key_at(keys, i);
  const int t = tile_of(key, depth_bits, tile0, T);
  for (int b = max(prev + 1, 0); b <= min(t, T - 1); ++b) starts[b] = static_cast<int>(i);
  if (t >= 0 && t < T) {
    if (t != prev) atomicSub(lens + t, static_cast<int>(i));
    const int next = i + 1 < m_eff ? tile_of(key_at(keys, i + 1), depth_bits, tile0, T) : T;
    if (t != next) atomicAdd(lens + t, static_cast<int>(i + 1));
  }
  int g = P;
  if (key != kInvalid) {
    g = static_cast<int>(__ldg(slots + i) % P);
    atomicAdd(cnt + g, 1);
  }
  sorted_gauss[i] = g;
}

}  // namespace

// K9 over the first m_eff entries of the sorted keys and slots: sorted_gauss
// (m_pad,), starts (T,), and lens (T,) and cnt (P,), which must hold zeros.
extern "C" int glic_bin_ranges(const int* keys, const long long* slots, long long m_eff,
                               long long m_pad, int P, int T, int depth_bits, int tile0,
                               int* sorted_gauss, int* starts, int* lens, int* cnt,
                               void* stream) {
  if (m_eff < 0 || m_pad < m_eff || P < 1 || T < 0 || depth_bits < 0 || depth_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_threads = m_pad > m_eff ? m_pad : m_eff + 1;
  const long long blocks = (n_threads + kThreads - 1) / kThreads;
  bin_ranges_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      keys, slots, m_eff, m_pad, n_threads, P, T, depth_bits, tile0, sorted_gauss, starts, lens,
      cnt);
  return static_cast<int>(cudaGetLastError());
}
