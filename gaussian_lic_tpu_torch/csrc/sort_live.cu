// K13: the binning's sort, hand-written for Hopper (sm_90a). A stable sort of
// the live slots of K8's keys only, by their 32-bit keys.
//
// Replaces jax.lax.sort((keys, slot_ids), num_keys=1) of the JAX package's
// gaussian_lic_tpu/ops/tiles.py:325, which the port ran as
// torch.sort(keys, stable=True) over all P K slot keys (ops/tiles.py
// bin_gaussians): four radix passes over every slot with int64 indices,
// though 92-94% of the slots of the benchmark's maps are dead (a Gaussian
// uses 1-2 of its K = 16 slots). K9 reads only the list's first entries,
// and those are exactly the live slots: the stable sort of all P K keys puts
// the dead key (INVALID_KEY, the largest) last, and ties among live keys keep
// slot order, so its first n entries are the stable sort of the n live slots
// taken in slot order.
//
// What bounds it on this card: device memory. One read of the P K keys (4 B
// each) and, for the n live pairs (4-B key, 4-B slot id), four passes that
// each read and write 8 B a pair: 4 P K + 64 n bytes (~44 us at 3.35 TB/s for
// the 2^20-row map of fastlivo's step, P K = 16.8M, n ~ 1.3M).
//
// The design: six kernels on the caller's stream, none of them sized by
// the live count, which stays on the device (the wrapper reads nothing
// back, so the train step's bundles capture it in their CUDA graphs).
//   radix_compact_live_kernel  one pass over the P K keys in tiles of 8192
//      (16-byte loads), keeping the live ones (key != the dead key) with
//      their slot ids, in slot order: a block counts its live keys, takes its
//      offset by a decoupled look-back over the tiles before it and writes
//      its pairs there. The last tile writes the count n. Each tile also
//      zeroes the look-back words of the sort tiles whose first entry it
//      writes, so no memset of the sort's worst-case status runs.
//   radix_histogram_kernel  the 4 x 256 digit counts of the n live keys.
//   radix_onesweep_kernel x 4  a stable LSD radix sort, 8-bit digits,
//      onesweep style (each pass one launch that reads and writes the pairs
//      once): persistent blocks take tiles of 4096 pairs in order from a
//      counter and stop at the first tile past n. A warp ranks its 512 pairs
//      by digit in order (__match_any_sync and a shared count a digit), the
//      block stages the tile in digit order in shared memory, and each of
//      256 threads takes its digit's offset by a decoupled look-back (16
//      tiles' words in flight at a time) before the tile is written out in
//      runs. The compaction's look-back is a warp's, 128 tiles a step, and
//      a warp stages its live pairs in shared memory to write them in runs.
// The look-back words are 64 bits, a flag above a 32-bit count, so any
// count below 2^31 fits; one array serves the four passes (flags 2p + 1
// and 2p + 2 of pass p: an earlier pass's word reads as not ready).
// On an H100 (700 W) it takes 0.155 ms on the keys of a fastlivo training
// view (7.6% live) against torch.sort's 0.796, 28% of its bound: a pass is
// latency bound (one tile in flight a block, its 16 ranking rounds and its
// look-back in series), and the compaction reads at about half the card's
// bandwidth.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace glic_k13 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr unsigned kFlip = 0x80000000u;
constexpr int kDeadKey = 0x7FFFFFFF;      // INVALID_KEY in K8's int32 form
constexpr int kBins = 256;                 // 8-bit digits
constexpr int kPasses = 4;
constexpr int kCompactChunks = 8;          // 16-byte loads a thread of the compaction
constexpr int kCompactTile = 8192;         // slots a compaction tile
constexpr int kItems = 16;                 // pairs a thread of a pass
constexpr int kSortTile = 4096;            // pairs a tile of a pass
constexpr int kWarpPairs = 32 * kItems;    // pairs a warp of a pass
constexpr int kWindow = 16;                // look-back words a thread of a pass reads at once
constexpr int kLaneWords = 4;              // look-back words a lane of the compaction reads
static_assert(kCompactTile == kThreads * kCompactChunks * 4, "compaction tile");
static_assert(kSortTile == kThreads * kItems, "sort tile");
static_assert(kThreads == kBins, "a pass gives each digit a thread");
static_assert(kCompactChunks * kWarps == 64, "the chunk offsets: two a lane of one warp");

// The zeroed scratch (int32 words), in this order: the live count, the
// compaction's tile counter, each pass's tile counter, the 4 x 256 digit
// counts, then a 64-bit look-back word a compaction tile.
constexpr int kCountWord = 0;
constexpr int kCompactCounter = 1;
constexpr int kPassCounters = 2;
constexpr int kHistWord = 8;
constexpr int kCompactStatusWord = 1032;
static_assert(kCompactStatusWord == kHistWord + kPasses * kBins, "scratch layout");
static_assert(kCompactStatusWord % 2 == 0, "64-bit look-back words");

constexpr unsigned kAggregate = 1;         // the compaction's flags
constexpr unsigned kInclusive = 2;

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned flag, unsigned count) {
  const unsigned long long v = (static_cast<unsigned long long>(flag) << 32) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The sum of the counts of the tiles before `tile`, from their words
// words[t * stride]: aggregates (flag `agg`) summed back to the nearest
// inclusive prefix (flag agg + 1). A word whose flag is below `agg` is not
// ready (or an earlier pass's): the window is read again from there. One
// thread, kWindow words in flight.
__device__ unsigned lookback(const unsigned long long* words, int stride, int tile,
                             unsigned agg) {
  unsigned before = 0;
  int t = tile - 1;
  while (t >= 0) {
    unsigned long long w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      w[i] = t - i >= 0 ? load_word(words + (t - i) * stride)
                        : static_cast<unsigned long long>(agg + 1) << 32;
    int used = 0;
    bool done = false;
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      if (done) break;
      const unsigned flag = static_cast<unsigned>(w[i] >> 32);
      if (flag < agg) break;
      before += static_cast<unsigned>(w[i]);
      ++used;
      done = flag > agg;
    }
    if (done) return before;
    t -= used;
  }
  return before;
}

// lookback() for one 64-bit word a tile (stride 1), by a whole warp:
// lane l reads tiles t - 4 l .. t - 4 l - 3 at once, 128 tiles a step, nearest
// first. Every lane of the warp must call it; each gets the sum.
__device__ unsigned warp_lookback(const unsigned long long* words, long long tile,
                                  unsigned agg) {
  constexpr unsigned kSpan = 32 * kLaneWords;
  const unsigned lane = threadIdx.x & 31;
  unsigned before = 0;
  long long t = tile - 1;
  while (t >= 0) {
    unsigned long long w[kLaneWords];
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q) {
      const long long at = t - static_cast<long long>(kLaneWords * lane + q);
      w[q] = at >= 0 ? load_word(words + at) : static_cast<unsigned long long>(agg + 1) << 32;
    }
    // the nearest word not ready and the nearest inclusive one, by position
    unsigned wait = kSpan, incl = kSpan;
#pragma unroll
    for (int q = kLaneWords - 1; q >= 0; --q) {
      const unsigned flag = static_cast<unsigned>(w[q] >> 32);
      if (flag < agg) wait = kLaneWords * lane + q;
      if (flag > agg) incl = kLaneWords * lane + q;
    }
    wait = __reduce_min_sync(kAllLanes, wait);
    incl = __reduce_min_sync(kAllLanes, incl);
    // sum the ready words before the first that is not, through the nearest
    // inclusive one
    const unsigned stop = wait <= incl ? wait : incl + 1;
    unsigned mine = 0;
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q)
      mine += kLaneWords * lane + q < stop ? static_cast<unsigned>(w[q]) : 0u;
    before += __reduce_add_sync(kAllLanes, mine);
    if (incl < wait) return before;
    t -= stop;
  }
  return before;
}

// The exclusive prefix of `v` over the block's threads in order. Every
// thread of the block must call it.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* s_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(kAllLanes, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_sums[warp] = incl;
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s_sums[w] : 0u;
  __syncthreads();   // s_sums is free again
  return before + incl - v;
}

__device__ __forceinline__ unsigned digit_of(int key, int shift) {
  return ((static_cast<unsigned>(key) ^ kFlip) >> shift) & (kBins - 1);
}

// ---------------------------------------------------------------------------
// the compaction: the live slots, in slot order
// ---------------------------------------------------------------------------

// A tile holds slots [tile * 8192, + 8192): 8 chunks of 1024, thread t reading
// slots 4t .. 4t + 3 of each chunk, so the tile's order is (chunk, warp,
// lane, element).
__global__ void __launch_bounds__(kThreads) radix_compact_live_kernel(
    const int* __restrict__ keys, long long n_slots, int* __restrict__ keys_out,
    int* __restrict__ slots_out, int* scratch, unsigned long long* __restrict__ sort_words) {
  __shared__ unsigned s_tile;
  __shared__ unsigned long long s_warp_counts[kWarps];
  __shared__ unsigned s_chunk_first[kCompactChunks * kWarps];   // (chunk, warp) in tile order
  __shared__ unsigned s_first, s_count;
  __shared__ int s_stage[kWarps][2][128];   // a warp's live pairs of one chunk, in order
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(scratch + kCompactStatusWord);
  if (tid == 0) s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch + kCompactCounter), 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kCompactTile;
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;

  int k[kCompactChunks][4];
#pragma unroll
  for (int c = 0; c < kCompactChunks; ++c) {
    const long long i = base + (static_cast<long long>(c) * kThreads + tid) * 4;
    if (vec && i + 4 <= n_slots) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(keys + i));
      k[c][0] = v.x;
      k[c][1] = v.y;
      k[c][2] = v.z;
      k[c][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) k[c][e] = i + e < n_slots ? keys[i + e] : kDeadKey;
    }
  }
  // the live keys of each chunk, 8 bits a chunk, scanned over the warp (a
  // field reaches 32 x 4 = 128 at most, so no field carries into the next)
  unsigned long long mine = 0;
#pragma unroll
  for (int c = 0; c < kCompactChunks; ++c) {
    unsigned live = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) live += k[c][e] != kDeadKey;
    mine |= static_cast<unsigned long long>(live) << (8 * c);
  }
  unsigned long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long u = __shfl_up_sync(kAllLanes, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp_counts[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    // entry e = chunk * kWarps + warp of the tile's order, two a lane
    const int e0 = 2 * lane, e1 = e0 + 1;
    const unsigned v0 =
        static_cast<unsigned>(s_warp_counts[e0 % kWarps] >> (8 * (e0 / kWarps))) & 0xFF;
    const unsigned v1 =
        static_cast<unsigned>(s_warp_counts[e1 % kWarps] >> (8 * (e1 / kWarps))) & 0xFF;
    const unsigned pair = v0 + v1;
    unsigned run = pair;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(kAllLanes, run, o);
      if (lane >= o) run += u;
    }
    s_chunk_first[e0] = run - pair;
    s_chunk_first[e1] = run - pair + v0;
    const unsigned count = __shfl_sync(kAllLanes, run, 31);
    unsigned first = 0;
    if (lane == 0) store_word(words + tile, tile == 0 ? kInclusive : kAggregate, count);
    if (tile > 0) first = warp_lookback(words, tile, kAggregate);
    if (lane == 0) {
      if (tile > 0) store_word(words + tile, kInclusive, first + count);
      s_first = first;
      s_count = count;
      if (base + kCompactTile >= n_slots) scratch[kCountWord] = static_cast<int>(first + count);
    }
  }
  __syncthreads();
  const unsigned first = s_first, count = s_count;
  const unsigned long long below = incl - mine;   // the warp's lanes before this one
  // chunk by chunk, the warp's live pairs in order in shared memory, then
  // written out by consecutive lanes to consecutive entries
#pragma unroll
  for (int c = 0; c < kCompactChunks; ++c) {
    unsigned o = static_cast<unsigned>(below >> (8 * c)) & 0xFF;
    const int slot = static_cast<int>(base) + (c * kThreads + tid) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k[c][e] != kDeadKey) {
        s_stage[warp][0][o] = k[c][e];
        s_stage[warp][1][o] = slot + e;
        ++o;
      }
    }
    __syncwarp();
    const unsigned m = static_cast<unsigned>(s_warp_counts[warp] >> (8 * c)) & 0xFF;
    const unsigned at = first + s_chunk_first[c * kWarps + warp];
    for (unsigned q = lane; q < m; q += 32) {
      keys_out[at + q] = s_stage[warp][0][q];
      slots_out[at + q] = s_stage[warp][1][q];
    }
    __syncwarp();
  }
  // the look-back words of the sort tiles whose first entry lies in this
  // tile's range [first, first + count)
  if (count) {
    const long long lo = (static_cast<long long>(first) + kSortTile - 1) / kSortTile;
    const long long hi = (static_cast<long long>(first) + count - 1) / kSortTile;
    for (long long s = lo; s <= hi; ++s) sort_words[s * kBins + tid] = 0;
  }
}

// ---------------------------------------------------------------------------
// the digit counts of the live keys
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) radix_histogram_kernel(const int* __restrict__ keys,
                                                                   int* scratch) {
  __shared__ unsigned s_hist[kPasses * kBins];
  const int tid = threadIdx.x;
  for (int i = tid; i < kPasses * kBins; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  const long long n = scratch[kCountWord];
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int key = __ldg(keys + i);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) atomicAdd(s_hist + p * kBins + digit_of(key, 8 * p), 1u);
  }
  __syncthreads();
  unsigned* hist = reinterpret_cast<unsigned*>(scratch + kHistWord);
  for (int i = tid; i < kPasses * kBins; i += kThreads)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
}

// ---------------------------------------------------------------------------
// one pass of the radix sort: digit `pass` (bits 8 pass .. 8 pass + 7)
// ---------------------------------------------------------------------------

// A tile holds pairs [tile * 4096, + 4096) of the list; warp w ranks pairs
// w * 512 .. w * 512 + 511, lane l's item i being pair w * 512 + 32 i + l,
// so (warp, item, lane) is the list's order.
__global__ void __launch_bounds__(kThreads, 3) radix_onesweep_kernel(
    const int* __restrict__ keys_in, const int* __restrict__ vals_in, int* __restrict__ keys_out,
    int* __restrict__ vals_out, int* scratch, unsigned long long* words, int pass) {
  __shared__ int s_keys[kSortTile];
  __shared__ int s_vals[kSortTile];
  __shared__ unsigned s_warp_bins[kWarps][kBins];
  __shared__ unsigned s_digit_first[kBins];   // the digit's first entry in the list
  __shared__ unsigned s_tile_first[kBins];    // its first entry in the tile
  __shared__ unsigned s_out[kBins];           // list entry of tile entry j: s_out[digit] + j
  __shared__ unsigned s_sums[kWarps];
  __shared__ unsigned s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // unsigned: an index of a tile's last pair stays below 2^32 for n < 2^31
  const unsigned n = static_cast<unsigned>(scratch[kCountWord]);
  if (static_cast<long long>(blockIdx.x) * kSortTile >= n) return;
  const int shift = 8 * pass;
  const unsigned agg = 2 * pass + 1;
  const unsigned lanes_below = (1u << lane) - 1;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + kPassCounters + pass);
  const unsigned* hist = reinterpret_cast<const unsigned*>(scratch + kHistWord) + pass * kBins;
  s_digit_first[tid] = block_exclusive_scan(hist[tid], s_sums);

  for (;;) {
    if (tid == 0) s_tile = atomicAdd(counter, 1u);
    for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_warp_bins[0][0])[i] = 0;
    __syncthreads();
    const int tile = static_cast<int>(s_tile);
    if (static_cast<long long>(tile) * kSortTile >= n) break;
    const unsigned base = static_cast<unsigned>(tile) * kSortTile;
    const unsigned warp_base = base + warp * kWarpPairs;

    int key[kItems], val[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned j = warp_base + 32 * i + lane;
      key[i] = j < n ? keys_in[j] : 0;
      val[i] = j < n ? vals_in[j] : 0;
    }
    // each pair's rank among the warp's earlier pairs of its digit
    unsigned rank[kItems];
    unsigned* bins = s_warp_bins[warp];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool valid = warp_base + 32 * i + lane < n;
      const unsigned d = valid ? digit_of(key[i], shift) : kBins;
      const unsigned peers = __match_any_sync(kAllLanes, d);
      const unsigned below = __popc(peers & lanes_below);
      const unsigned before = valid ? bins[d] : 0u;
      __syncwarp();
      if (valid && below == 0) bins[d] = before + __popc(peers);
      __syncwarp();
      rank[i] = before + below;
    }
    __syncthreads();
    // digit tid: each warp's first rank in the tile, the tile's count
    unsigned count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = s_warp_bins[w][tid];
      s_warp_bins[w][tid] = count;
      count += c;
    }
    unsigned long long* word = words + static_cast<long long>(tile) * kBins + tid;
    store_word(word, tile == 0 ? agg + 1 : agg, count);
    s_tile_first[tid] = block_exclusive_scan(count, s_sums);
    __syncthreads();
    // the tile in digit order, in shared memory
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (warp_base + 32 * i + lane < n) {
        const unsigned d = digit_of(key[i], shift);
        const unsigned at = s_tile_first[d] + s_warp_bins[warp][d] + rank[i];
        s_keys[at] = key[i];
        s_vals[at] = val[i];
      }
    }
    // digit tid's entries in the tiles before
    unsigned before = 0;
    if (tile > 0) {
      before = lookback(words + tid, kBins, tile, agg);
      store_word(word, agg + 1, before + count);
    }
    s_out[tid] = s_digit_first[tid] + before - s_tile_first[tid];
    __syncthreads();
    const int tile_n = static_cast<int>(min(static_cast<unsigned>(kSortTile), n - base));
    for (int j = tid; j < tile_n; j += kThreads) {
      const int kk = s_keys[j];
      const unsigned o = s_out[digit_of(kk, shift)] + j;
      keys_out[o] = kk;
      vals_out[o] = s_vals[j];
    }
    __syncthreads();   // shared memory is the next tile's
  }
}

// Blocks of radix_onesweep_kernel that fit on the card at once (its
// persistent grid); the same for every launch of the process.
int resident_sort_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radix_onesweep_kernel, kThreads, 0);
    blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace glic_k13

// K13 over K8's n_slots int32 keys (slot order, slot id = index): the live
// pairs' stable sort by key in keys_a / slots_a (n_slots each; entries past
// the live count hold whatever was there), keys_b / slots_b the passes'
// second buffers (n_slots each). scratch: kCompactStatusWord + 2 ceil(n_slots
// / kCompactTile) int32 words of zeros; word 0 gets the live count.
// sort_words: ceil(n_slots / kSortTile) x 256 64-bit words, uninitialised.
extern "C" int glic_sort_live(const int* keys, long long n_slots, int* keys_a, int* slots_a,
                              int* keys_b, int* slots_b, int* scratch,
                              unsigned long long* sort_words, void* stream) {
  using namespace glic_k13;
  if (n_slots < 0 || n_slots >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long compact_tiles = (n_slots + kCompactTile - 1) / kCompactTile;
  radix_compact_live_kernel<<<static_cast<unsigned>(compact_tiles), kThreads, 0, s>>>(
      keys, n_slots, keys_a, slots_a, scratch, sort_words);
  const int resident = resident_sort_blocks();
  const long long hist_blocks = (n_slots + kThreads - 1) / kThreads;
  radix_histogram_kernel<<<static_cast<unsigned>(hist_blocks < resident ? hist_blocks : resident),
                           kThreads, 0, s>>>(keys_a, scratch);
  const long long sort_tiles = (n_slots + kSortTile - 1) / kSortTile;
  const unsigned sort_blocks =
      static_cast<unsigned>(sort_tiles < resident ? sort_tiles : resident);
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool from_a = pass % 2 == 0;
    radix_onesweep_kernel<<<sort_blocks, kThreads, 0, s>>>(
        from_a ? keys_a : keys_b, from_a ? slots_a : slots_b, from_a ? keys_b : keys_a,
        from_a ? slots_b : slots_a, scratch, sort_words, pass);
  }
  return static_cast<int>(cudaGetLastError());
}
