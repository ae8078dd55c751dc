// K7: the visibility-masked sparse Adam of all six parameter groups in one
// launch, hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/ops/adam.py:40 sparse_adam_update, called once per group
// by the train step (engine/trainer.py:114, parallel/sharded.py:572); the
// reference's adamUpdateCUDA (adam.cu:9-38). In PyTorch each group was ~14
// separate kernels.
//
// One kernel body in two forms (template <bool kInPlace>), chosen by whether
// every group's outputs are its inputs:
//  * in place (ops/adam.py sparse_adam_update_groups_, the train step inside
//    a bundle's CUDA graph): p, m and v are updated where they lie, at the
//    rows `visible` marks; every other float keeps its bits. The walk stops
//    at the map's count, read on the device, and a chunk of rows none of
//    which is visible costs its mask bytes alone. What bounds it: device
//    memory over the visible rows, 28 B an element (p, g, m, v read; p, m, v
//    written; 59 floats a Gaussian), plus a mask byte a row below the count.
//  * out of place (the eager train step, the sharded step): fresh p', m' and
//    v' of every row, none of the inputs written (a CUDA graph's step reads
//    its inputs again). What bounds it: 28 B every element of every row, plus
//    a mask byte a row (~0.52 ms at 2^20 Gaussians at 3.35 TB/s).
//
// The work: a persistent grid (the blocks that fit on the card at once) of
// warps, each taking the next chunk of 32 rows from a device counter until
// none is left (a static split of the chunks over the warps left a last
// round a fifth full at 2^20 rows). A lane reads its row's mask byte and the
// warp's ballot is the chunk's visibility. The chunk's groups lie end to end
// as 8 w 16-byte words each (w the group's width, 1 to 45), two words a lane
// in flight. The in-place form loads no 32-byte sector (two lanes' words)
// none of whose rows is visible, and stores every sector it loads whole, the
// invisible floats in it with the bits it loaded, so no sector is written
// in part. A short last chunk, or groups not 32-byte aligned, go a float a
// lane, visible rows only in place. Each operation is the plain version's
// (ops/adam.py:sparse_adam_update), in its order, rounded once by the *_rn
// intrinsics, so the visible rows get its floats bit for bit.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

namespace glic_adam {

constexpr int kMaxGroups = 6;  // ops/adam.py MAX_GROUPS

// ops/adam.py _Group: the same field order and types
struct AdamGroup {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;  // p, m and v themselves in the in-place form
  float* m_out;
  float* v_out;
  int width;     // floats a row
  float neg_lr;
};

struct AdamGroups {
  AdamGroup g[kMaxGroups];
  int sub[kMaxGroups];  // 32-row sub-chunks a unit of each group
  int n;
  int vec;              // bit k: group k's seven pointers are 32-byte aligned
  bool vec_mask;        // `visible` is 16-byte aligned
};

}  // namespace glic_adam

namespace {

using namespace glic_adam;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSub = 16;  // a unit's rows: at most 16 x 32, 16 mask bytes a lane

// The unit a warp takes next, and the warps that have found none left (the
// last one zeroes both for the next launch), one pair a form: launches of
// K7 on one device must not overlap.
__device__ unsigned long long g_next_unit[2];
__device__ unsigned g_done_warps[2];

struct Betas {
  float b1, omb1, b2, omb2, eps;
};

// m = b1 m0 + (1 - b1) g; v = b2 v0 + (1 - b2) g g; step = -lr m / (sqrt(v) + eps);
// p' = p + step, m' = m, v' = v where visible, else p, m0, v0 (their bits)
__device__ __forceinline__ void adam(float& p, float g, float& m0, float& v0, float neg_lr,
                                     const Betas& b, bool vis) {
  const float m = __fadd_rn(__fmul_rn(b.b1, m0), __fmul_rn(b.omb1, g));
  const float v = __fadd_rn(__fmul_rn(b.b2, v0), __fmul_rn(__fmul_rn(b.omb2, g), g));
  const float step = __fdiv_rn(__fmul_rn(neg_lr, m), __fadd_rn(__fsqrt_rn(v), b.eps));
  if (vis) p = __fadd_rn(p, step), m0 = m, v0 = v;
}

// Visibility of the unit's rows lo .. lo + 31 (bit r: row lo + r).
__device__ __forceinline__ unsigned long long window(const unsigned* bits, int lo) {
  return (bits[lo >> 5] | static_cast<unsigned long long>(bits[(lo >> 5) + 1]) << 32) >> (lo & 31);
}

// The low bits of 4 bool bytes, in order.
__device__ __forceinline__ unsigned pack4(unsigned x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// One unit: nr rows of group G from row `base`, their visibility in `bits`.
// Its 16-byte words two a lane in flight (G 32-byte aligned), then the
// floats past its last whole word, or all its floats, a float a lane.
template <bool kInPlace>
__device__ __forceinline__ void unit(const AdamGroup& G, bool vec, long long base, int nr,
                                     const unsigned* bits, int lane, const Betas& b) {
  const int w = G.width, n_el = nr * w, n_words = vec ? n_el / 4 : 0;
  const long long e0 = base * w;
  for (int q0 = lane; q0 < n_words; q0 += 64) {
    float4 p[2], g[2], m[2], v[2];
    unsigned long long win[2];
    bool on[2];
    int dr[2], col[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = q0 + 32 * u, e = 4 * q;
      on[u] = q < n_words;
      if (!on[u]) continue;
      // the 32-byte sector's rows lo .. hi; two lanes, the same decision
      const int s0 = e & ~7, lo = s0 / w, hi = (s0 + 7) / w, row = e / w;
      win[u] = window(bits, lo);
      if (kInPlace) on[u] = (win[u] & ((2u << (hi - lo)) - 1u)) != 0;
      if (!on[u]) continue;
      dr[u] = row - lo;
      col[u] = e - row * w;
      const long long i = e0 + e;
      p[u] = __ldcs(reinterpret_cast<const float4*>(G.p + i));
      g[u] = __ldcs(reinterpret_cast<const float4*>(G.g + i));
      m[u] = __ldcs(reinterpret_cast<const float4*>(G.m + i));
      v[u] = __ldcs(reinterpret_cast<const float4*>(G.v + i));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!on[u]) continue;
      bool vis[4];
      for (int j = 0, r = dr[u], c = col[u]; j < 4; ++j) {
        vis[j] = (win[u] >> r) & 1u;
        if (++c == w) c = 0, ++r;
      }
      adam(p[u].x, g[u].x, m[u].x, v[u].x, G.neg_lr, b, vis[0]);
      adam(p[u].y, g[u].y, m[u].y, v[u].y, G.neg_lr, b, vis[1]);
      adam(p[u].z, g[u].z, m[u].z, v[u].z, G.neg_lr, b, vis[2]);
      adam(p[u].w, g[u].w, m[u].w, v[u].w, G.neg_lr, b, vis[3]);
      const long long i = e0 + 4 * (q0 + 32 * u);
      __stcs(reinterpret_cast<float4*>(G.p_out + i), p[u]);
      __stcs(reinterpret_cast<float4*>(G.m_out + i), m[u]);
      __stcs(reinterpret_cast<float4*>(G.v_out + i), v[u]);
    }
  }
  for (int e = 4 * n_words + lane; e < n_el; e += 32) {
    const int r = e / w;
    const bool vis = (bits[r >> 5] >> (r & 31)) & 1u;
    if (kInPlace && !vis) continue;
    const long long i = e0 + e;
    float p = G.p[i], m = G.m[i], v = G.v[i];
    adam(p, G.g[i], m, v, G.neg_lr, b, vis);
    G.p_out[i] = p;
    G.m_out[i] = m;
    G.v_out[i] = v;
  }
}

// rows: the groups' leading dimension; count (in place, or null): the rows
// to walk, read on the device (rows at or past it must be invisible). The
// work is units of 32 sub[k] rows of one group, group after group; each
// warp takes the next unit until none is left.
template <bool kInPlace>
__global__ void __launch_bounds__(kThreads) sparse_adam_kernel(
    AdamGroups gs, const bool* __restrict__ visible, const int* __restrict__ count,
    long long rows, Betas b) {
  __shared__ unsigned s_bits[kWarps][kMaxSub + 1];
  long long n = rows;
  if (kInPlace && count != nullptr) {
    const long long c = *count;
    n = c < 0 ? 0 : (c < rows ? c : rows);
  }
  const int lane = threadIdx.x & 31;
  unsigned* bits = s_bits[threadIdx.x / 32];
  if (lane == 0) bits[kMaxSub] = 0;
  long long last[kMaxGroups];  // one past each group's last unit, laid end to end
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    const long long unit_rows = 32ll * gs.sub[k];
    last[k] = (k == 0 ? 0 : last[k - 1]) + (k < gs.n ? (n + unit_rows - 1) / unit_rows : 0);
  }
  unsigned long long next = 0;
  if (lane == 0) next = atomicAdd(&g_next_unit[kInPlace], 1ull);
  long long u = static_cast<long long>(__shfl_sync(0xffffffffu, next, 0));
  while (u < last[kMaxGroups - 1]) {
    if (lane == 0) next = atomicAdd(&g_next_unit[kInPlace], 1ull);  // in flight meanwhile
    int k = 0;
    long long first = 0;  // the group's first unit
#pragma unroll
    for (int j = 0; j + 1 < kMaxGroups; ++j) {
      if (u >= last[j]) k = j + 1, first = last[j];
    }
    const long long base = (u - first) * 32 * gs.sub[k];
    const int nr = static_cast<int>(n - base < 32ll * gs.sub[k] ? n - base : 32ll * gs.sub[k]);
    // the unit's mask, 16 rows a lane, as bits: half a word a lane
    const int r = 16 * lane;
    unsigned mine = 0;
    if (r + 16 <= nr && gs.vec_mask) {
      const uint4 x = *reinterpret_cast<const uint4*>(visible + base + r);
      mine = pack4(x.x) | pack4(x.y) << 4 | pack4(x.z) << 8 | pack4(x.w) << 12;
    } else {
      for (int j = 0; j < 16 && r + j < nr; ++j) mine |= static_cast<unsigned>(visible[base + r + j]) << j;
    }
    reinterpret_cast<unsigned short*>(bits)[lane] = static_cast<unsigned short>(mine);
    __syncwarp();
    if (!kInPlace || __any_sync(0xffffffffu, mine != 0)) {
      unit<kInPlace>(gs.g[k], (gs.vec >> k) & 1, base, nr, bits, lane, b);
    }
    __syncwarp();  // the next unit's bits overwrite these
    u = static_cast<long long>(__shfl_sync(0xffffffffu, next, 0));
  }
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(&g_done_warps[kInPlace], 1u) == gridDim.x * kWarps - 1) {
      g_next_unit[kInPlace] = 0;
      g_done_warps[kInPlace] = 0;
    }
  }
}

// Blocks of sparse_adam_kernel<kInPlace> that fit on the card at once (its
// persistent grid); the same for every launch of the process.
template <bool kInPlace>
long long resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sparse_adam_kernel<kInPlace>,
                                                  kThreads, 0);
    blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <bool kInPlace>
int launch(const AdamGroups& gs, const bool* visible, const int* count, long long rows,
           const Betas& b, cudaStream_t stream) {
  const long long need = ((rows + 31) / 32 + kWarps - 1) / kWarps;
  const long long resident = resident_blocks<kInPlace>();
  sparse_adam_kernel<kInPlace><<<static_cast<unsigned>(need < resident ? need : resident),
                                 kThreads, 0, stream>>>(gs, visible, count, rows, b);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// K7 over `n_groups` <= 6 descriptors (host memory, read here) of `rows`
// rows each. In place when every group's outputs are its p, m and v (then
// `count`, a device int or null, bounds the rows walked), out of place when
// none is; a mix is refused.
extern "C" int glic_sparse_adam(const glic_adam::AdamGroup* groups, int n_groups,
                                long long rows, const bool* visible, const int* count, float b1,
                                float omb1, float b2, float omb2, float eps, void* stream) {
  using namespace glic_adam;
  if (n_groups < 1 || n_groups > kMaxGroups || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  AdamGroups gs{};
  int aliased = 0;
  for (int k = 0; k < n_groups; ++k) {
    const AdamGroup& G = gs.g[k] = groups[k];
    if (G.width < 1) return static_cast<int>(cudaErrorInvalidValue);
    aliased += G.p_out == G.p && G.m_out == G.m && G.v_out == G.v;
    const bool vec = aligned(G.p, 32) && aligned(G.g, 32) && aligned(G.m, 32) &&
                     aligned(G.v, 32) && aligned(G.p_out, 32) && aligned(G.m_out, 32) &&
                     aligned(G.v_out, 32);
    gs.vec |= static_cast<int>(vec) << k;
    // a unit of 128 words or more, a whole number of steps of 64 (the
    // sub-chunks a multiple of 8 / gcd(w, 8)); one sub-chunk from w = 16
    int sub = 1;
    if (G.width < 16) {
      const int low = G.width & -G.width;  // gcd(w, 8) is the lesser of it and 8
      const int step = 8 / (low < 8 ? low : 8);
      sub = ((16 + G.width - 1) / G.width + step - 1) / step * step;
      sub = sub < kMaxSub ? sub : kMaxSub;
    }
    gs.sub[k] = sub;
  }
  gs.vec_mask = aligned(visible, 16);
  if (aliased != 0 && aliased != n_groups) return static_cast<int>(cudaErrorInvalidValue);
  gs.n = n_groups;
  const Betas b{b1, omb1, b2, omb2, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aliased ? launch<true>(gs, visible, count, rows, b, s)
                 : launch<false>(gs, visible, nullptr, rows, b, s);
}
