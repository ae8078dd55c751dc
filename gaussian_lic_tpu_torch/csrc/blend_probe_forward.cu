// K3: substitution probes of the tile blend forward (K1), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_kernel.py: make_fwd(...).run (its
// pl.pallas_call at :235), the Pallas probe of blend_pallas.py's forward.
// Each variant is K1 (csrc/blend_forward.cu) with one cost centre swapped
// out, so that the time it removes from `base` is what that centre costs:
//
//   0 base      K1's walk, bit for bit
//   1 noexp     G = 0.1 power + 0.9 in place of expf(power)
//   2 noattr    no staging and no attribute loads: every in-range entry is
//               the constant splat passed as a kernel argument
//   3 noblend   color += (power, power/2, power/4) for every in-range entry;
//               no tests, no termination, no early exit
//   4 batch512  512 entries staged per round (2 per thread) in place of 256
//   5 direct    every thread reads each entry's attributes from device
//               memory (L1 broadcast); no shared-memory staging
//
// The numbering is FORWARD_VARIANTS in ops/blend_probe.py. What bounds them
// is K1's bound (per-(entry, pixel) arithmetic and one expf, the serial
// front-to-back dependence); the launch shape is K1's: one block of 256
// threads per 32x32 tile, 4 pixels per thread. Every variant can also write
// the number of entries its block walked (`walked`, one int per tile), since
// noexp, noattr and noblend change where the walk stops.
//
// noattr's constants would be loop-invariant, so nvcc could hoist the power
// and the exp out of the entry loop and the probe would time something else.
// The constants come in as kernel arguments and an empty asm statement marks
// them as rewritten on every entry, which keeps the per-entry arithmetic in
// the loop at no instruction cost.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace glic {
namespace {

enum ForwardVariant : int {
  kFwdBase = 0,
  kFwdNoExp = 1,
  kFwdNoAttr = 2,
  kFwdNoBlend = 3,
  kFwdBatch512 = 4,
  kFwdDirect = 5,
};

// The splat's fields as values the compiler must assume change here.
__device__ __forceinline__ void opaque(Splat& s) {
  asm volatile("" : "+f"(s.x), "+f"(s.y), "+f"(s.nA), "+f"(s.B), "+f"(s.nC),
               "+f"(s.opa), "+f"(s.r), "+f"(s.g), "+f"(s.b));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_forward_kernel(const float* __restrict__ rows, long long m_pad,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_lens,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib, int* __restrict__ walked,
                     int n_tx, int tile_w, int tile_h, int width_p, int height_p,
                     Splat konst) {
  constexpr int kBatch = V == kFwdBatch512 ? 2 * kThreads : kThreads;
  constexpr bool kStage = V != kFwdNoAttr && V != kFwdDirect;
  __shared__ Splat s_splat[kStage ? kBatch : 1];

  const int tile = blockIdx.x;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  int last[kPixPerThread];
  bool done[kPixPerThread];
  long long pix[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int flat = threadIdx.x + k * kThreads;
    const int row = ty * tile_h + flat / tile_w;
    const int col = tx * tile_w + flat % tile_w;
    px[k] = static_cast<float>(col);
    py[k] = static_cast<float>(row);
    // keep the coordinates in registers, as K1's loop does: in this kernel
    // nvcc otherwise rebuilds them from the integers on every entry
    asm volatile("" : "+f"(px[k]), "+f"(py[k]));
    pix[k] = static_cast<long long>(row) * width_p + col;
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    last[k] = 0;
    done[k] = false;
  }

  int base = 0;  // after the walk: the entries it visited, if less than len
  for (; base < len; base += kBatch) {
    if (V == kFwdNoBlend) {
      __syncthreads();  // no early exit; orders the previous batch's reads
    } else {
      int mine_done = 1;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) mine_done &= done[k] ? 1 : 0;
      // barrier: also orders the previous batch's shared reads before the refill
      if (__syncthreads_count(mine_done) == kThreads) break;
    }
    const int n = min(kBatch, len - base);
    if (kStage) {  // one entry per thread and round, as K1 stages them
#pragma unroll
      for (int r = 0; r < kBatch / kThreads; ++r) {
        const int i = threadIdx.x + r * kThreads;
        if (i < n) s_splat[i] = load_splat(rows, start + base + i);
      }
      __syncthreads();
    }

    for (int j = 0; j < n; ++j) {
      Splat s;
      if (V == kFwdNoAttr) {
        s = konst;
        opaque(s);
      } else if (V == kFwdDirect) {
        s = load_splat(rows, start + base + j);
      } else {
        s = s_splat[j];
      }
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (V != kFwdNoBlend && done[k]) continue;
        const float dx = __fsub_rn(s.x, px[k]);
        const float dy = __fsub_rn(s.y, py[k]);
        const float power = splat_power(s, dx, dy);
        if (V == kFwdNoBlend) {
          cr[k] += power;
          cg[k] += power * 0.5f;
          cb[k] += power * 0.25f;
          continue;
        }
        const float g = V == kFwdNoExp ? __fadd_rn(__fmul_rn(power, 0.1f), 0.9f)
                                       : expf(power);
        const float alpha = splat_alpha(s, g);
        if (!contributes(alpha, power)) continue;
        const float test_t = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
        if (test_t < kTEps) {  // stop before applying this entry
          done[k] = true;
          continue;
        }
        const float w = alpha * T[k];
        cr[k] += w * s.r;
        cg[k] += w * s.g;
        cb[k] += w * s.b;
        last[k] = base + j + 1;
        T[k] = test_t;
      }
    }
  }

  const long long plane = static_cast<long long>(width_p) * height_p;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    final_t[pix[k]] = T[k];
    color[pix[k]] = cr[k];
    color[plane + pix[k]] = cg[k];
    color[2 * plane + pix[k]] = cb[k];
    n_contrib[pix[k]] = last[k];
  }
  if (walked != nullptr && threadIdx.x == 0) walked[tile] = min(base, len);
}

template <int V>
cudaError_t launch(const float* rows, long long m_pad, const int* tile_starts,
                   const int* tile_lens, float* color, float* final_t,
                   int* n_contrib, int* walked, int n_tx, int n_ty, int tile_w,
                   int tile_h, const Splat& konst, cudaStream_t stream) {
  probe_forward_kernel<V><<<n_tx * n_ty, kThreads, 0, stream>>>(
      rows, m_pad, tile_starts, tile_lens, color, final_t, n_contrib, walked,
      n_tx, tile_w, tile_h, n_tx * tile_w, n_ty * tile_h, konst);
  return cudaGetLastError();
}

}  // namespace
}  // namespace glic

// `konst`: 9 host floats (x, y, A, B, C, opa, r, g, b), the splat of the
// noattr variant, or null. `walked`: (n_tiles,) int32 or null.
extern "C" int glic_blend_probe_forward(int variant, const float* rows, long long m_pad,
                                        const int* tile_starts, const int* tile_lens,
                                        float* color, float* final_t, int* n_contrib,
                                        int* walked, int n_tx, int n_ty, int tile_w,
                                        int tile_h, const float* konst, void* stream) {
  using namespace glic;
  if (tile_w * tile_h != kTilePix) return static_cast<int>(cudaErrorInvalidValue);
  Splat k{};
  if (konst != nullptr) {  // pre-negated conic halves, as load_splat makes them
    k = Splat{konst[0], konst[1], -0.5f * konst[2], konst[3], -0.5f * konst[4],
              konst[5],  konst[6], konst[7],         konst[8]};
  }
  if (n_tx * n_ty <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (variant) {
#define GLIC_CASE(V)                                                                   \
  case V:                                                                              \
    rc = launch<V>(rows, m_pad, tile_starts, tile_lens, color, final_t, n_contrib,     \
                   walked, n_tx, n_ty, tile_w, tile_h, k, s);                          \
    break;
    GLIC_CASE(kFwdBase)
    GLIC_CASE(kFwdNoExp)
    GLIC_CASE(kFwdNoAttr)
    GLIC_CASE(kFwdNoBlend)
    GLIC_CASE(kFwdBatch512)
    GLIC_CASE(kFwdDirect)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}
