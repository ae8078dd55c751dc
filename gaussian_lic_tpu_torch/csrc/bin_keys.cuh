// K8's kernel template, shared by K8 (bin_keys.cu, which launches kK8Base)
// and its timing variants (bin_keys_probe.cu, every variant), as K6's
// preprocess_backward.cuh is shared with its probe. bin_keys.cu says what K8
// computes and why its arithmetic is PyTorch's.
//
// K8 (kK8Base) is one thread a Gaussian over its K slots: it computes the
// rect, the depth key and the cull threshold once, evaluates
// max_contrib_power (about 70 FP32 operations and two IEEE divisions) for
// each slot that is live, in the rect and in the band, and stores slot k's
// key at k P + p, coalesced across the warp; a block adds its sums into
// `sums` with two integer atomics (the wrapper zeroes them first).
//
// Its body is divergent: at the 1M-Gaussian train step (K = 8) the power is
// evaluated in 117,652 of 262,144 warp-slots with 41% of their lanes busy.
// The listed design (kK8Listed) takes that away: a block writes the
// (Gaussian, slot) pairs to evaluate as one dense list in shared memory (a
// block-wide scan of each Gaussian's range of slots: k < rect_count bounds
// it, and the band cuts it at multiples of the rect's width), every lane
// evaluates a pair, and the block stores a (slots x 256) tile of keys row by
// row. It is bit for bit K8, and no faster: the variants below show that
// K8's time is its memory traffic (kK8MemOnly, the loads and stores alone,
// takes all but a few percent of it), not the power's body (kK8NoPower).
//
// The variants, each K8 with one thing changed:
//   kK8NoPower        timing only: the cull always passes (no power)
//   kK8OneStore       timing only: one key store a Gaussian instead of K
//   kK8Rcp            1 / t as __frcp_rn(t) instead of __fdiv_rn(1, t): both
//                     are the correctly rounded reciprocal (bit for bit)
//   kK8VecLoad        the mean and conic as one 16-byte load and a word
//                     where they are a 16-byte aligned table's columns 0-4
//                     (bit for bit)
//   kK8NoTable        timing only: every Gaussian reads row 0's mean and
//                     conic (no table stream)
//   kK8MemOnly        timing only: K8's loads, and K stores of a value made
//                     from them, without its arithmetic
//   kK8Fold           the sums kept between blocks on the device and written
//                     by the last block, so `sums` needs no zeros (bit for
//                     bit; no fill launch before K8, a fence in each block)
//   kK8Listed         the listed design (bit for bit)
//   kK8ListedNoPower  timing only: the listed design without the power

#pragma once

#include <cuda_runtime.h>

#include "preprocess_common.cuh"

namespace glic_k8 {

using glic_pre::add;
using glic_pre::clamp;
using glic_pre::clamp_min;
using glic_pre::mul;
using glic_pre::sub;

enum K8Variant : int {
  kK8Base = 0,
  kK8NoPower = 1,
  kK8OneStore = 2,
  kK8Rcp = 3,
  kK8VecLoad = 4,
  kK8NoTable = 5,
  kK8MemOnly = 6,
  kK8Fold = 7,
  kK8Listed = 8,
  kK8ListedNoPower = 9,
};

constexpr int kThreads = 256;
constexpr int kChunk = 8;   // slots a pass of the listed design
constexpr unsigned kFlip = 0x80000000u;
constexpr unsigned kInvalid = 0xFFFFFFFFu;
constexpr int kDeadKey = static_cast<int>(kInvalid ^ kFlip);

struct Grid {
  int n_tx, n_ty, tile_w, tile_h;
  float tw, th;          // tile_w, tile_h as floats
  float inv_tw, inv_th;  // their float reciprocals
};

struct Args {
  const float* xy;
  long long xy_stride;
  const float* conic;
  long long conic_stride;
  const float* depth;
  const long long* dkey;
  const float* opacity;
  const float* radius;
  const bool* active;
  long long P;
  int K, depth_bits;
  Grid g;
  int band_ty0, band_n_ty;   // band_n_ty < 0: no band, global tile ids
  float opa_thr, inv_opa_thr;
  int* keys;
  int* touched;
  int* sums;
  bool table_rows;   // xy and conic are columns 0-4 of 16-byte aligned rows (kK8VecLoad)
};

// kK8Fold's running sums between its blocks (the truncated rect tiles, the
// live slots) and its count of finished blocks: the last block to finish
// copies the sums out and zeroes all three for the next launch. Zero when
// the module loads; the launches on a device run one after another.
static __device__ int g_sums[2];
static __device__ unsigned g_done;

// torch.clamp(v, -2^30, 2^30).to(torch.int32)
__device__ __forceinline__ int to_int32(float v) {
  return __float2int_rz(clamp(v, -1073741824.0f, 1073741824.0f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// 1.0 / t is t.reciprocal() * 1.0 in PyTorch: a correctly rounded reciprocal
template <bool kRcp>
__device__ __forceinline__ float reciprocal(float t) {
  if constexpr (kRcp) return __frcp_rn(t);
  return __fdiv_rn(1.0f, t);
}

// ops/projection.py max_contrib_power_rect_components, one tile's pixel rect
template <bool kRcp>
__device__ __forceinline__ float max_contrib_power(float A, float B, float C, float mx,
                                                   float my, float rminx, float rminy,
                                                   float rmaxx, float rmaxy) {
  const float x_min_diff = sub(rminx, mx);
  const float y_min_diff = sub(rminy, my);
  const float x_left = x_min_diff > 0.0f ? 1.0f : 0.0f;
  const float y_above = y_min_diff > 0.0f ? 1.0f : 0.0f;
  const float not_in_x = add(x_left, mx > rmaxx ? 1.0f : 0.0f);
  const float not_in_y = add(y_above, my > rmaxy ? 1.0f : 0.0f);
  const float size_x = sub(rmaxx, rminx);
  const float size_y = sub(rmaxy, rminy);
  const float px = add(mul(x_left, rminx), mul(sub(1.0f, x_left), rmaxx));
  const float py = add(mul(y_above, rminy), mul(sub(1.0f, y_above), rmaxy));
  const float dx = x_min_diff >= 0.0f ? size_x : -size_x;
  const float dy = y_min_diff >= 0.0f ? size_y : -size_y;
  const float diffx = sub(mx, px);
  const float diffy = sub(my, py);
  const float eps = 1e-12f;
  const float rcp_dxdxA = reciprocal<kRcp>(add(mul(mul(size_x, size_x), A), eps));
  const float rcp_dydyC = reciprocal<kRcp>(add(mul(mul(size_y, size_y), C), eps));
  const float tx = mul(not_in_y,
                       clamp(mul(add(mul(mul(dx, A), diffx), mul(mul(dx, B), diffy)), rcp_dxdxA),
                             0.0f, 1.0f));
  const float ty = mul(not_in_x,
                       clamp(mul(add(mul(mul(dy, B), diffx), mul(mul(dy, C), diffy)), rcp_dydyC),
                             0.0f, 1.0f));
  const float qx = add(px, mul(tx, dx));
  const float qy = add(py, mul(ty, dy));
  const float ddx = sub(mx, qx);
  const float ddy = sub(my, qy);
  const float power = add(mul(0.5f, add(mul(mul(A, ddx), ddx), mul(mul(C, ddy), ddy))),
                          mul(mul(B, ddx), ddy));
  return add(not_in_x, not_in_y) > 0.0f ? power : 0.0f;
}

// Does slot (tx, ty) of a Gaussian at (x, y) with conic (A, B, C) survive
// the cull at threshold thr? (Always, in the no-power variants.)
template <int V>
__device__ __forceinline__ bool survives(float A, float B, float C, float x, float y, int tx,
                                         int ty, float thr, const Grid& g) {
  if constexpr (V == kK8NoPower || V == kK8ListedNoPower) return true;
  const float txf = static_cast<float>(tx), tyf = static_cast<float>(ty);
  const float power = max_contrib_power<V == kK8Rcp>(
      A, B, C, x, y, mul(txf, g.tw), mul(tyf, g.th), sub(mul(add(txf, 1.0f), g.tw), 1.0f),
      sub(mul(add(tyf, 1.0f), g.th), 1.0f));
  return power <= thr;
}

// Thread 0 of each block, with the block's sums: adds them into `sums`
// (zeroed by the wrapper); kK8Fold adds them to the running sums, and the
// last block writes those to `sums`.
template <int V>
__device__ __forceinline__ void add_sums(int n_trunc, int n_live, int* sums) {
  if constexpr (V != kK8Fold) {
    if (n_trunc) atomicAdd(sums, n_trunc);
    if (n_live) atomicAdd(sums + 1, n_live);
  } else {
    if (n_trunc) atomicAdd(&g_sums[0], n_trunc);
    if (n_live) atomicAdd(&g_sums[1], n_live);
    __threadfence();
    if (atomicAdd(&g_done, 1u) == gridDim.x - 1) {
      __threadfence();
      sums[0] = atomicExch(&g_sums[0], 0);
      sums[1] = atomicExch(&g_sums[1], 0);
      atomicExch(&g_done, 0u);
    }
  }
}

__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = threadIdx.x < (kThreads >> 5) ? smem[threadIdx.x] : 0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide exclusive scan of v over the block's threads; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// One Gaussian's rect, depth key and cull threshold (gaussian_rects,
// depth_key, the opacity's log threshold), and its truncated rect tiles.
struct Gaussian {
  float x, y, A, B, C, thr;
  int rminx, rminy, safe_w, rect_count, ty_id;   // ty_id: the row of tile ids' origin
  unsigned dk;
  bool live;
  int lo, hi;                                    // the slots in the rect and band
  int n_trunc;
};

// A Gaussian's inputs as they come from device memory: mean, conic,
// radius, opacity, the depth key's source word (its int64 key's low word,
// or the depth's float bits), the active flag.
struct Raw {
  float x, y, A, B, C, r, opacity;
  unsigned dbits;
  bool active;
};

template <int V>
__device__ __forceinline__ Raw load_raw(const Args& a, long long p) {
  Raw w;
  const long long m = V == kK8NoTable ? 0 : p;   // timing only: row 0's mean and conic
  if (V == kK8VecLoad && a.table_rows) {
    const float* row = a.xy + m * a.xy_stride;
    const float4 r = *reinterpret_cast<const float4*>(row);
    w.x = r.x;
    w.y = r.y;
    w.A = r.z;
    w.B = r.w;
    w.C = row[4];
  } else {
    w.x = a.xy[m * a.xy_stride];
    w.y = a.xy[m * a.xy_stride + 1];
    w.A = a.conic[m * a.conic_stride];
    w.B = a.conic[m * a.conic_stride + 1];
    w.C = a.conic[m * a.conic_stride + 2];
  }
  w.r = a.radius[p];
  w.opacity = a.opacity[p];
  w.dbits = a.dkey != nullptr ? static_cast<unsigned>(a.dkey[p]) : __float_as_uint(a.depth[p]);
  w.active = a.active[p];
  return w;
}

__device__ __forceinline__ Gaussian make_gaussian(const Args& a, const Raw& w) {
  Gaussian q;
  const Grid& g = a.g;
  q.x = w.x;
  q.y = w.y;
  q.A = w.A;
  q.B = w.B;
  q.C = w.C;
  const float r = w.r;
  q.live = w.active && (a.dkey != nullptr || r > 0.0f);
  q.dk = a.dkey != nullptr ? w.dbits : w.dbits >> (31 - a.depth_bits);
  // gaussian_rects: min inclusive, max exclusive, clamped to the grid
  q.rminx = clampi(to_int32(mul(sub(q.x, r), g.inv_tw)), 0, g.n_tx);
  q.rminy = clampi(to_int32(mul(sub(q.y, r), g.inv_th)), 0, g.n_ty);
  const int rmaxx = clampi(to_int32(mul(sub(add(add(q.x, r), g.tw), 1.0f), g.inv_tw)), 0, g.n_tx);
  const int rmaxy = clampi(to_int32(mul(sub(add(add(q.y, r), g.th), 1.0f), g.inv_th)), 0, g.n_ty);
  const int rect_w = rmaxx - q.rminx;
  q.rect_count = rect_w * (rmaxy - q.rminy);
  q.safe_w = max(rect_w, 1);
  q.thr = logf(mul(clamp_min(w.opacity, a.opa_thr), a.inv_opa_thr));
  const bool band = a.band_n_ty >= 0;
  q.ty_id = band ? q.rminy - a.band_ty0 : q.rminy;
  // slot k is in the rect iff k < rect_count, and in the band iff
  // band_ty0 <= rminy + k / safe_w < band_ty0 + band_n_ty: one range of k
  long long lo = 0, hi = min(a.K, q.rect_count);
  int in_scope = q.rect_count;
  if (band) {
    const long long above = a.band_ty0 - q.rminy, below = a.band_ty0 + a.band_n_ty - q.rminy;
    lo = above > 0 ? above * q.safe_w : 0;
    hi = below > 0 ? min(hi, below * q.safe_w) : 0;
    const int rows = max(min(rmaxy, a.band_ty0 + a.band_n_ty) - max(q.rminy, a.band_ty0), 0);
    in_scope = rows * rect_w;
  }
  lo = min(lo, static_cast<long long>(a.K));
  q.lo = static_cast<int>(lo);
  q.hi = static_cast<int>(max(hi, lo));
  const int enumerated = q.hi - q.lo;
  q.n_trunc = q.live ? max(in_scope - enumerated, 0) : 0;
  return q;
}

__device__ __forceinline__ unsigned slot_key(const Gaussian& q, int k, int n_tx, int bits) {
  const int tile = (q.ty_id + k / q.safe_w) * n_tx + q.rminx + k % q.safe_w;
  return (static_cast<unsigned>(tile) << bits) | q.dk;
}

// K8: one thread a Gaussian, over its K slots
template <int V>
__device__ __forceinline__ void serial_body(const Args& a, int* smem) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int n_trunc = 0, n_live = 0;
  if (V == kK8MemOnly && p < a.P) {   // timing only: the loads and stores alone
    const Raw w = load_raw<kK8Base>(a, p);
    const unsigned v = w.dbits ^ __float_as_uint(w.x) ^ __float_as_uint(w.y) ^
                       __float_as_uint(w.A) ^ __float_as_uint(w.B) ^ __float_as_uint(w.C) ^
                       __float_as_uint(w.r) ^ __float_as_uint(w.opacity) ^ w.active;
    for (int k = 0; k < a.K; ++k) a.keys[k * a.P + p] = static_cast<int>(v + k);
    a.touched[p] = a.K;
    n_live = a.K;
  } else if (p < a.P) {
    const Gaussian q = make_gaussian(a, load_raw<V>(a, p));
    unsigned folded = 0;
    for (int k = 0; k < a.K; ++k) {
      unsigned key = kInvalid;
      if (q.live && k >= q.lo && k < q.hi &&
          survives<V>(q.A, q.B, q.C, q.x, q.y, q.rminx + k % q.safe_w, q.rminy + k / q.safe_w,
                      q.thr, a.g)) {
        key = slot_key(q, k, a.g.n_tx, a.depth_bits);
        ++n_live;
      }
      if constexpr (V == kK8OneStore)
        folded ^= key;
      else
        a.keys[k * a.P + p] = static_cast<int>(key ^ kFlip);
    }
    if constexpr (V == kK8OneStore) a.keys[p] = static_cast<int>(folded);
    a.touched[p] = n_live;
    n_trunc = q.n_trunc;
  }
  n_trunc = block_sum(n_trunc, smem);
  n_live = block_sum(n_live, smem + kThreads / 32);
  if (threadIdx.x == 0) add_sums<V>(n_trunc, n_live, a.sums);
}

// the listed design: the block's (Gaussian, slot) pairs to evaluate as one
// dense list, every lane on a pair
template <int V>
__device__ __forceinline__ void listed_body(const Args& a) {
  __shared__ float s_f[6][kThreads];            // x, y, A, B, C, thr
  __shared__ int s_i[4][kThreads];              // rminx, rminy, safe_w, ty_id
  __shared__ unsigned s_dk[kThreads];
  __shared__ int s_live[kThreads];              // surviving slots, by Gaussian
  __shared__ int s_keys[kChunk][kThreads];
  __shared__ unsigned short s_list[kChunk * kThreads];
  __shared__ int s_red[2 * (kThreads / 32)];
  const int t = threadIdx.x;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + t;
  Gaussian q{};
  if (p < a.P) {
    q = make_gaussian(a, load_raw<V>(a, p));
    s_f[0][t] = q.x;
    s_f[1][t] = q.y;
    s_f[2][t] = q.A;
    s_f[3][t] = q.B;
    s_f[4][t] = q.C;
    s_f[5][t] = q.thr;
    s_i[0][t] = q.rminx;
    s_i[1][t] = q.rminy;
    s_i[2][t] = q.safe_w;
    s_i[3][t] = q.ty_id;
    s_dk[t] = q.dk;
  }
  s_live[t] = 0;
  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    const int kn = min(kChunk, a.K - k0);
    const int lo = max(q.lo, k0), hi = min(q.hi, k0 + kn);
    const int n = q.live && hi > lo ? hi - lo : 0;
    int total;
    const int at = block_scan(n, s_red, &total);
    for (int i = 0; i < n; ++i)
      s_list[at + i] = static_cast<unsigned short>(t * kChunk + (lo - k0 + i));
#pragma unroll
    for (int k = 0; k < kChunk; ++k) s_keys[k][t] = kDeadKey;
    __syncthreads();
    for (int j = t; j < total; j += kThreads) {
      const int e = s_list[j];
      const int gi = e / kChunk, kk = e % kChunk, k = k0 + kk;
      const int safe_w = s_i[2][gi];
      const int tx = s_i[0][gi] + k % safe_w, ty = s_i[1][gi] + k / safe_w;
      if (survives<V>(s_f[2][gi], s_f[3][gi], s_f[4][gi], s_f[0][gi], s_f[1][gi], tx, ty,
                      s_f[5][gi], a.g)) {
        const int tile = (s_i[3][gi] + k / safe_w) * a.g.n_tx + tx;
        s_keys[kk][gi] = static_cast<int>(
            ((static_cast<unsigned>(tile) << a.depth_bits) | s_dk[gi]) ^ kFlip);
        atomicAdd(&s_live[gi], 1);
      }
    }
    __syncthreads();
    if (p < a.P)
      for (int k = 0; k < kn; ++k) a.keys[(k0 + k) * a.P + p] = s_keys[k][t];
    __syncthreads();   // the next pass refills the list and the tile
  }
  const int n_live = p < a.P ? s_live[t] : 0;
  if (p < a.P) a.touched[p] = n_live;
  const int n_trunc = block_sum(q.n_trunc, s_red);
  const int live_sum = block_sum(n_live, s_red + kThreads / 32);
  if (t == 0) add_sums<V>(n_trunc, live_sum, a.sums);
}

template <int V>
__global__ void __launch_bounds__(kThreads) bin_keys_kernel(Args a) {
  if constexpr (V >= kK8Listed) {
    listed_body<V>(a);
  } else {
    __shared__ int smem[2 * (kThreads / 32)];
    serial_body<V>(a, smem);
  }
}

template <int V>
cudaError_t launch_bin_keys(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.P + kThreads - 1) / kThreads;
  bin_keys_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// the C entries' arguments as Args; false if they are invalid
inline bool make_args(const float* xy, long long xy_stride, const float* conic,
                      long long conic_stride, const float* depth, const long long* dkey,
                      const float* opacity, const float* radius, const bool* active,
                      long long P, int K, int depth_bits, int n_tx, int n_ty, int tile_w,
                      int tile_h, int band_ty0, int band_n_ty, float opa_thr, int* keys,
                      int* touched, int* sums, Args* out) {
  if (K < 1 || depth_bits < 0 || depth_bits > 31 || tile_w < 1 || tile_h < 1) return false;
  const float tw = static_cast<float>(tile_w), th = static_cast<float>(tile_h);
  // PyTorch computes a CPU scalar divisor's reciprocal in float on the host
  const Grid g{n_tx, n_ty, tile_w, tile_h, tw, th, 1.0f / tw, 1.0f / th};
  const bool table_rows = conic == xy + 2 && conic_stride == xy_stride && xy_stride % 4 == 0 &&
                          reinterpret_cast<unsigned long long>(xy) % 16 == 0;
  *out = Args{xy, xy_stride, conic, conic_stride, depth, dkey, opacity, radius, active, P, K,
              depth_bits, g, band_ty0, band_n_ty, opa_thr, 1.0f / opa_thr, keys, touched,
              sums, table_rows};
  return true;
}

}  // namespace glic_k8
