// K9's kernel templates, shared by K9 (bin_ranges.cu, which launches kK9Base)
// and its timing variants (bin_ranges_probe.cu, every variant), as K8's
// bin_keys.cuh is shared with its probe. bin_ranges.cu says what K9
// computes.
//
// The first design (kK9First) was one thread an entry: three key loads
// (entries i - 1, i and i + 1), a 64-bit signed `slot % P` (a software
// division routine), and an atomicAdd into the per-Gaussian count `cnt` at a
// random Gaussian for every live entry, into zeros that a fill launch wrote
// before it (with the tile lengths). Its variants take one cost centre out
// each:
//   kK9MemOnly   timing only: the same loads and the same ids stored, with
//                no remainder, no atomics and no starts loop
//   kK9NoAtomic  timing only: the `cnt` histogram left out
//   kK9Mod32     slot % P in 32-bit unsigned arithmetic (bit for bit)
//   kK9FastDiv   slot % P from a magic multiplier and shift computed on the
//                host for P (bit for bit)
// Both cheap remainders take the 64-bit one for a slot of 2^31 or more, so
// they are exact for every slot id.
//
// The listed design (bin_ranges_kernel; kK9Base) gives a thread 4 adjacent
// entries and 4 Gaussians:
//  (a) it reads their keys as one 16-byte load and the slots as one,
//      where the list allows (16-byte aligned, the whole group inside it),
//      and skips the slot loads of a group of dead entries;
//  (b) the tile ids of the entries before and after its group come from the
//      neighbouring lanes (warp shuffles), so an entry's key is loaded once;
//  (c) the remainder is kK9FastDiv's;
//  (d) `cnt` is computed as the JAX package computes it
//      (gaussian_lic_tpu/ops/tiles.py:339-365) when the caller gives K8's
//      `touched`, its sums and its keys: where the live slots fit the list
//      (sums[1] <= m_eff) cnt is `touched`, a 16-byte copy; else each
//      Gaussian counts its live slots whose (key, slot) sorts below the
//      m_eff-th entry's. No atomics and no zeros: the caller's fill of cnt
//      goes. Without them (the sharded path's merged list) it builds the
//      histogram into zeros as the first design.
// Its variant kK9Hist is the same with the histogram always (bit for bit;
// cnt must hold zeros).
//
// Slot ids are int32 (k P + p below 2^31: the sort's values). Given K8's
// sums, every kernel reads only the first sums[1] entries (the live slots,
// which K13's sort leaves at the front of buffers it does not clear) and
// takes the entries from there to m_eff as dead, which is what a sort of all
// P K slots holds there.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace glic_k9 {

enum K9Variant : int {
  kK9Base = 0,
  kK9Hist = 1,
  kK9First = 2,
  kK9MemOnly = 3,
  kK9NoAtomic = 4,
  kK9Mod32 = 5,
  kK9FastDiv = 6,
};

constexpr int kThreads = 256;
constexpr unsigned kFlip = 0x80000000u;
constexpr unsigned kInvalid = 0xFFFFFFFFu;
constexpr int kDeadKey = static_cast<int>(kInvalid ^ kFlip);   // the int32 form
constexpr int kEntries = 4;   // entries a thread of the listed design
constexpr int kGauss = 4;     // Gaussians a thread of the listed design

struct Args {
  const int* keys;          // sorted keys, K8's int32 form
  const int* slots;         // their slot ids k P + p
  long long m_eff, m_pad;
  int P, T, depth_bits, tile0;
  unsigned magic;           // slot / P = (slot * magic) >> shift for slot < 2^31
  int shift;
  const int* touched;       // K8's (P,) live slots per Gaussian, or null
  const int* sums;          // K8's (2,): sums[1] the live slots
  const int* slot_keys;     // K8's (K P,) keys in slot order
  long long n_slot_keys;
  int* sorted_gauss;
  int* starts;
  int* lens;
  int* cnt;
};

__device__ __forceinline__ int tile_of(unsigned key, int depth_bits, int tile0, int T) {
  return static_cast<int>(min(static_cast<long long>(key >> depth_bits) - tile0,
                              static_cast<long long>(T)));
}

__device__ __forceinline__ unsigned key_at(const int* keys, long long i) {
  return static_cast<unsigned>(__ldg(keys + i)) ^ kFlip;
}

// The entries the list holds: the first sums[1] (K8's live slots) where the
// caller gives K8's sums, else m_eff. Entries from there on read as dead.
__device__ __forceinline__ long long list_end(const Args& a) {
  return a.sums ? min(a.m_eff, static_cast<long long>(__ldg(a.sums + 1))) : a.m_eff;
}

__device__ __forceinline__ unsigned key_in(const Args& a, long long end, long long i) {
  return i < end ? key_at(a.keys, i) : kInvalid;
}

// slot % P, the first design's 64-bit signed remainder
__device__ __forceinline__ int rem64(long long slot, int P) {
  return static_cast<int>(slot % P);
}

// slot % P in 32-bit unsigned arithmetic below 2^31
__device__ __forceinline__ int rem32(long long slot, int P) {
  if (slot >> 31) return rem64(slot, P);
  return static_cast<int>(static_cast<unsigned>(slot) % static_cast<unsigned>(P));
}

// slot % P from the magic multiplier below 2^31 (ops/tiles.py k9_fastdiv:
// magic = ceil(2^shift / P), shift = 31 + ceil(log2 P), exact for n < 2^31)
__device__ __forceinline__ int remfast(long long slot, int P, unsigned magic, int shift) {
  if (slot >> 31) return rem64(slot, P);
  const unsigned n = static_cast<unsigned>(slot);
  const unsigned q = static_cast<unsigned>((static_cast<unsigned long long>(n) * magic) >> shift);
  return static_cast<int>(n - q * static_cast<unsigned>(P));
}

// the starts of the tiles after tile `prev` up to `t` (the searchsorted of
// each): entry i
__device__ __forceinline__ void write_starts(int* starts, int prev, int t, int T, long long i) {
  for (int b = max(prev + 1, 0); b <= min(t, T - 1); ++b) starts[b] = static_cast<int>(i);
}

// ---------------------------------------------------------------------------
// the first design and its cost-centre variants: one thread an entry
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads) bin_ranges_first_kernel(Args a, long long n_threads) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_threads) return;
  const long long end = list_end(a);
  // tile of the entry before: -1 before the first
  const int prev =
      i == 0 || i > a.m_eff ? -1 : tile_of(key_in(a, end, i - 1), a.depth_bits, a.tile0, a.T);
  if (i >= a.m_eff) {  // past the list: the tiles after its last entry start at m_eff
    if (V != kK9MemOnly && i == a.m_eff)
      for (int b = max(prev + 1, 0); b < a.T; ++b) a.starts[b] = static_cast<int>(a.m_eff);
    if (i < a.m_pad) a.sorted_gauss[i] = a.P;
    return;
  }
  const unsigned key = key_in(a, end, i);
  const int t = tile_of(key, a.depth_bits, a.tile0, a.T);
  const bool ranged = t >= 0 && t < a.T;   // a tile of the grid (or band): its length counts
  const int next = ranged && i + 1 < a.m_eff
                       ? tile_of(key_in(a, end, i + 1), a.depth_bits, a.tile0, a.T) : a.T;
  if constexpr (V == kK9MemOnly) {   // timing only: the loads, and an id made from them
    a.sorted_gauss[i] = key != kInvalid ? __ldg(a.slots + i) ^ (prev + next)
                                        : a.P;
    return;
  }
  write_starts(a.starts, prev, t, a.T, i);
  if (ranged) {
    if (t != prev) atomicSub(a.lens + t, static_cast<int>(i));
    if (t != next) atomicAdd(a.lens + t, static_cast<int>(i + 1));
  }
  int g = a.P;
  if (key != kInvalid) {
    const long long slot = __ldg(a.slots + i);
    if constexpr (V == kK9Mod32) {
      g = rem32(slot, a.P);
    } else if constexpr (V == kK9FastDiv) {
      g = remfast(slot, a.P, a.magic, a.shift);
    } else {
      g = rem64(slot, a.P);
    }
    if constexpr (V != kK9NoAtomic) atomicAdd(a.cnt + g, 1);
  }
  a.sorted_gauss[i] = g;
}

// ---------------------------------------------------------------------------
// the listed design: E entries and 4 Gaussians a thread
// ---------------------------------------------------------------------------

// cnt of the Gaussians [p0, p0 + 4): a copy of touched, or (the budget cut
// the list) JAX's survivor compare of each Gaussian's slots against the
// m_eff-th entry's (key, slot)
__device__ __forceinline__ void gaussian_counts(const Args& a, long long p0, bool cut) {
  const bool whole = p0 + kGauss <= a.P;
  if (!cut) {
    if (whole && ((reinterpret_cast<uintptr_t>(a.touched + p0) |
                   reinterpret_cast<uintptr_t>(a.cnt + p0)) & 15) == 0) {
      *reinterpret_cast<int4*>(a.cnt + p0) = __ldg(reinterpret_cast<const int4*>(a.touched + p0));
    } else {
      for (long long p = p0; p < min(p0 + kGauss, static_cast<long long>(a.P)); ++p)
        a.cnt[p] = __ldg(a.touched + p);
    }
    return;
  }
  const int bk_key = __ldg(a.keys + a.m_eff);
  const long long bk_slot = __ldg(a.slots + a.m_eff);
  const long long K = a.n_slot_keys / a.P;
  for (long long p = p0; p < min(p0 + kGauss, static_cast<long long>(a.P)); ++p) {
    int n = 0;
    for (long long k = 0; k < K; ++k) {
      const long long slot = k * a.P + p;
      const int key = __ldg(a.slot_keys + slot);
      n += key != kDeadKey && (key < bk_key || (key == bk_key && slot < bk_slot));
    }
    a.cnt[p] = n;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) bin_ranges_kernel(Args a, long long n_threads) {
  constexpr int E = kEntries;
  constexpr unsigned kAll = 0xffffffffu;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long i0 = j * E;
  const bool hist = V == kK9Hist || a.touched == nullptr;
  const long long end = list_end(a);

  // the group's keys: 16-byte loads where the whole group is in the list
  unsigned key[E];
  const bool full = i0 + E <= end;
  if (full && (reinterpret_cast<uintptr_t>(a.keys + i0) & 15) == 0) {
#pragma unroll
    for (int w = 0; w < E / 4; ++w) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(a.keys + i0) + w);
      key[4 * w] = static_cast<unsigned>(k4.x) ^ kFlip;
      key[4 * w + 1] = static_cast<unsigned>(k4.y) ^ kFlip;
      key[4 * w + 2] = static_cast<unsigned>(k4.z) ^ kFlip;
      key[4 * w + 3] = static_cast<unsigned>(k4.w) ^ kFlip;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) key[e] = key_in(a, end, i0 + e);
  }
  int t[E];
#pragma unroll
  for (int e = 0; e < E; ++e) t[e] = tile_of(key[e], a.depth_bits, a.tile0, a.T);
  // the tile of the entry before the group (the previous lane's last) and
  // after it (the next lane's first); the warp's ends load their own
  int prev = __shfl_up_sync(kAll, t[E - 1], 1);
  int next = __shfl_down_sync(kAll, t[0], 1);
  if (lane == 0) prev = i0 > 0 && i0 <= a.m_eff ? tile_of(key_in(a, end, i0 - 1), a.depth_bits,
                                                          a.tile0, a.T) : -1;
  if (lane == 31 || i0 + E >= a.m_eff)
    next = i0 + E < a.m_eff ? tile_of(key_in(a, end, i0 + E), a.depth_bits, a.tile0, a.T) : a.T;
  if (j >= n_threads) return;

  // slots of the live entries: 16-byte loads where the whole group is in the
  // list, none for a group of dead entries
  int g[E];
  bool any_live = false;
#pragma unroll
  for (int e = 0; e < E; ++e) any_live |= key[e] != kInvalid;
  if (any_live && full && (reinterpret_cast<uintptr_t>(a.slots + i0) & 15) == 0) {
#pragma unroll
    for (int w = 0; w < E / 4; ++w) {
      const int4 s4 = __ldg(reinterpret_cast<const int4*>(a.slots + i0) + w);
      g[4 * w] = key[4 * w] != kInvalid ? remfast(s4.x, a.P, a.magic, a.shift) : a.P;
      g[4 * w + 1] = key[4 * w + 1] != kInvalid ? remfast(s4.y, a.P, a.magic, a.shift) : a.P;
      g[4 * w + 2] = key[4 * w + 2] != kInvalid ? remfast(s4.z, a.P, a.magic, a.shift) : a.P;
      g[4 * w + 3] = key[4 * w + 3] != kInvalid ? remfast(s4.w, a.P, a.magic, a.shift) : a.P;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      g[e] = key[e] != kInvalid ? remfast(__ldg(a.slots + i0 + e), a.P, a.magic, a.shift) : a.P;
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = i0 + e;
    const int before = e == 0 ? prev : t[e - 1];
    if (i < a.m_eff) {
      const int after = e == E - 1 ? next : (i + 1 < a.m_eff ? t[e + 1] : a.T);
      write_starts(a.starts, before, t[e], a.T, i);
      if (t[e] >= 0 && t[e] < a.T) {
        if (t[e] != before) atomicSub(a.lens + t[e], static_cast<int>(i));
        if (t[e] != after) atomicAdd(a.lens + t[e], static_cast<int>(i + 1));
      }
      if (hist && key[e] != kInvalid) atomicAdd(a.cnt + g[e], 1);
    } else if (i == a.m_eff) {   // the tiles after the list's last entry start at m_eff
      for (int b = max(before + 1, 0); b < a.T; ++b)
        a.starts[b] = static_cast<int>(a.m_eff);
    }
  }
  // ids: the dead id P past the list, up to m_pad
  if (i0 + E <= a.m_pad && (reinterpret_cast<uintptr_t>(a.sorted_gauss + i0) & 15) == 0) {
#pragma unroll
    for (int w = 0; w < E / 4; ++w)
      reinterpret_cast<int4*>(a.sorted_gauss + i0)[w] =
          make_int4(g[4 * w], g[4 * w + 1], g[4 * w + 2], g[4 * w + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (i0 + e < a.m_pad) a.sorted_gauss[i0 + e] = g[e];
  }
  if (!hist && j * kGauss < a.P) gaussian_counts(a, j * kGauss, __ldg(a.sums + 1) > a.m_eff);
}

// The kernels' arguments, checked; false if they are out of range.
inline bool make_args(const int* keys, const int* slots, long long m_eff, long long m_pad,
                      int P, int T, int depth_bits, int tile0, long long magic, int shift,
                      const int* touched, const int* sums, const int* slot_keys,
                      long long n_slot_keys, int* sorted_gauss, int* starts, int* lens, int* cnt,
                      Args* a) {
  if (m_eff < 0 || m_pad < m_eff || P < 1 || T < 0 || depth_bits < 0 || depth_bits > 31 ||
      magic < 0 || magic > 0xFFFFFFFFll || shift < 31 || shift > 63)
    return false;
  if (touched && (!sums || !slot_keys || n_slot_keys < 0 || n_slot_keys % P)) return false;
  *a = Args{keys, slots, m_eff, m_pad, P, T, depth_bits, tile0,
            static_cast<unsigned>(magic), shift, touched, sums, slot_keys, n_slot_keys,
            sorted_gauss, starts, lens, cnt};
  return true;
}

template <int V>
cudaError_t launch_bin_ranges(const Args& a, cudaStream_t s) {
  // entries [0, m_pad) and the entry m_eff, whose thread starts the tiles
  // after the list
  const long long n_entries = a.m_pad > a.m_eff ? a.m_pad : a.m_eff + 1;
  if constexpr (V >= kK9First) {
    const long long blocks = (n_entries + kThreads - 1) / kThreads;
    bin_ranges_first_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, n_entries);
  } else {
    constexpr int E = kEntries;
    long long n_threads = (n_entries + E - 1) / E;
    const long long n_gauss = (static_cast<long long>(a.P) + kGauss - 1) / kGauss;
    if (a.touched != nullptr && V != kK9Hist && n_gauss > n_threads) n_threads = n_gauss;
    const long long blocks = (n_threads + kThreads - 1) / kThreads;
    bin_ranges_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, n_threads);
  }
  return cudaGetLastError();
}

}  // namespace glic_k9
