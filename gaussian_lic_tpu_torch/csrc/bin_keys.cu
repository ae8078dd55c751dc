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
// any order).
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

#include "preprocess_common.cuh"

namespace {

using glic_pre::add;
using glic_pre::clamp;
using glic_pre::clamp_min;
using glic_pre::mul;
using glic_pre::sub;

constexpr int kThreads = 256;
constexpr unsigned kFlip = 0x80000000u;
constexpr unsigned kInvalid = 0xFFFFFFFFu;

struct Grid {
  int n_tx, n_ty, tile_w, tile_h;
  float tw, th;          // tile_w, tile_h as floats
  float inv_tw, inv_th;  // their float reciprocals
};

// torch.clamp(v, -2^30, 2^30).to(torch.int32)
__device__ __forceinline__ int to_int32(float v) {
  return __float2int_rz(clamp(v, -1073741824.0f, 1073741824.0f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// ops/projection.py max_contrib_power_rect_components, one tile's pixel rect
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
  // 1.0 / t is t.reciprocal() * 1.0: a correctly rounded reciprocal
  const float rcp_dxdxA = __fdiv_rn(1.0f, add(mul(mul(size_x, size_x), A), eps));
  const float rcp_dydyC = __fdiv_rn(1.0f, add(mul(mul(size_y, size_y), C), eps));
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

// band_n_ty < 0: no band, global tile ids. dkey == nullptr: the depth key of
// `depth` and live = active & (radius > 0); else the given depth keys and
// live = active as it is.
__global__ void __launch_bounds__(kThreads) bin_keys_kernel(
    const float* __restrict__ xy, long long xy_stride, const float* __restrict__ conic,
    long long conic_stride, const float* __restrict__ depth,
    const long long* __restrict__ dkey, const float* __restrict__ opacity,
    const float* __restrict__ radius, const bool* __restrict__ active, long long P, int K,
    int depth_bits, Grid g, int band_ty0, int band_n_ty, float opa_thr, float inv_opa_thr,
    int* __restrict__ keys, int* __restrict__ touched, int* __restrict__ sums) {
  __shared__ int smem[2][kThreads / 32];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int n_trunc = 0, n_live = 0;
  if (p < P) {
    const float x = xy[p * xy_stride], y = xy[p * xy_stride + 1];
    const float A = conic[p * conic_stride], B = conic[p * conic_stride + 1],
                C = conic[p * conic_stride + 2];
    const float r = radius[p];
    const bool live = active[p] && (dkey != nullptr || r > 0.0f);
    const unsigned dk = dkey != nullptr
                            ? static_cast<unsigned>(dkey[p])
                            : __float_as_uint(depth[p]) >> (31 - depth_bits);
    // gaussian_rects: min inclusive, max exclusive, clamped to the grid
    const int rminx = clampi(to_int32(mul(sub(x, r), g.inv_tw)), 0, g.n_tx);
    const int rminy = clampi(to_int32(mul(sub(y, r), g.inv_th)), 0, g.n_ty);
    const int rmaxx = clampi(to_int32(mul(sub(add(add(x, r), g.tw), 1.0f), g.inv_tw)), 0, g.n_tx);
    const int rmaxy = clampi(to_int32(mul(sub(add(add(y, r), g.th), 1.0f), g.inv_th)), 0, g.n_ty);
    const int rect_w = rmaxx - rminx;
    const int rect_count = rect_w * (rmaxy - rminy);
    const int safe_w = max(rect_w, 1);
    const float thr = logf(mul(clamp_min(opacity[p], opa_thr), inv_opa_thr));
    const bool band = band_n_ty >= 0;
    int enumerated = 0;
    for (int k = 0; k < K; ++k) {
      const int tx = rminx + k % safe_w;
      const int ty = rminy + k / safe_w;
      const bool in_rect = k < rect_count;
      const int ty_l = ty - band_ty0;
      const bool in_band = !band || (ty_l >= 0 && ty_l < band_n_ty);
      enumerated += in_rect && in_band;
      unsigned key = kInvalid;
      if (live && in_rect && in_band) {
        const float txf = static_cast<float>(tx), tyf = static_cast<float>(ty);
        const float power = max_contrib_power(
            A, B, C, x, y, mul(txf, g.tw), mul(tyf, g.th), sub(mul(add(txf, 1.0f), g.tw), 1.0f),
            sub(mul(add(tyf, 1.0f), g.th), 1.0f));
        if (power <= thr) {
          const int tile = (band ? ty_l : ty) * g.n_tx + tx;
          key = (static_cast<unsigned>(tile) << depth_bits) | dk;
          ++n_live;
        }
      }
      keys[k * P + p] = static_cast<int>(key ^ kFlip);
    }
    touched[p] = n_live;
    if (live) {
      int in_scope = rect_count;
      if (band) {
        const int rows = max(min(rmaxy, band_ty0 + band_n_ty) - max(rminy, band_ty0), 0);
        in_scope = rows * rect_w;
      }
      n_trunc = max(in_scope - enumerated, 0);
    }
  }
  n_trunc = block_sum(n_trunc, smem[0]);
  n_live = block_sum(n_live, smem[1]);
  if (threadIdx.x == 0) {
    if (n_trunc) atomicAdd(sums, n_trunc);
    if (n_live) atomicAdd(sums + 1, n_live);
  }
}

}  // namespace

// K8 over P Gaussians: keys (K P,) int32, touched (P,), and sums (2,) int32
// (the truncated rect tiles, the live slots), which must hold zeros.
extern "C" int glic_bin_keys(const float* xy, long long xy_stride, const float* conic,
                             long long conic_stride, const float* depth, const long long* dkey,
                             const float* opacity, const float* radius, const bool* active,
                             long long P, int K, int depth_bits, int n_tx, int n_ty, int tile_w,
                             int tile_h, int band_ty0, int band_n_ty, float opa_thr, int* keys,
                             int* touched, int* sums, void* stream) {
  if (P == 0) return 0;
  if (K < 1 || depth_bits < 0 || depth_bits > 31 || tile_w < 1 || tile_h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float tw = static_cast<float>(tile_w), th = static_cast<float>(tile_h);
  // PyTorch computes a CPU scalar divisor's reciprocal in float on the host
  const Grid g{n_tx, n_ty, tile_w, tile_h, tw, th, 1.0f / tw, 1.0f / th};
  const long long blocks = (P + kThreads - 1) / kThreads;
  bin_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      xy, xy_stride, conic, conic_stride, depth, dkey, opacity, radius, active, P, K,
      depth_bits, g, band_ty0, band_n_ty, opa_thr, 1.0f / opa_thr, keys, touched, sums);
  return static_cast<int>(cudaGetLastError());
}
