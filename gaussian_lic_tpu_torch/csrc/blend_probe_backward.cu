// K4: substitution probes of the tile blend backward (K2) in its first
// design, hand-written for Hopper (sm_90a). K2 itself was redesigned since
// (csrc/blend_backward.cu); `base` keeps the old design line for line.
//
// Replaces the TPU kernel tools/probe_bwd.py: make_bwd(...).run (its
// pl.pallas_call at :354), the Pallas probe of blend_pallas.py's backward.
// Each variant is the first K2 with its batch pipeline or its
// reduction swapped out:
//
//   0 base        the first K2, line for line (per-entry output)
//   1 dbuf2       the next batch of 128 entries is copied with cp.async into
//                 a second shared buffer while the current one is walked
//                 (the TPU probe's double-buffered DMAs)
//   2 nored       no reduction: each entry's record is built from thread 0's
//                 four pixels (flat 0, 256, 512, 768) alone; every pixel's
//                 math and T/Sdl updates still run. A lower bound for all
//                 reduction work
//   3 smematomic  after each warp's shuffle, lane 0 atomicAdds into one
//                 shared [128][9] buffer: no [8 warps][128][9] buffer and no
//                 per-batch 8-warp pass (the TPU probe's mxusub: the same
//                 sums by another route)
//   4 fused       the per-entry record is atomicAdded straight into the
//                 per-Gaussian grads (P+1, 9) at sorted_gauss[entry]: no
//                 (M_pad, 9) write and no index_add_ (the TPU probe's mxuall:
//                 the last reduction stage removed)
//
// The numbering is BACKWARD_VARIANTS in ops/blend_probe.py. The launch shape
// is the first K2's: one block of 256 threads per tile, 4 pixels per thread, batches
// of 128 entries walked back to front from min(max n_contrib, len); `walked`
// (one int per tile, or null) receives that count. What bounds that K2 is the
// per-(entry, pixel) arithmetic plus the 9-sum reduction over 1024 pixels
// per entry; the variants take that reduction, the batch refill and the
// per-entry write apart. smematomic and fused sum in a run-dependent order.
//
// Shared memory: base and fused 41,476 B (as the first K2), dbuf2 46,084 B (two
// 128-entry buffers of 36 B per entry, as 16 + 16 + 4 B copies), nored and
// smematomic 9,220 B.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace glic {
namespace {

constexpr int kBatchB = 128;  // entries staged per round
constexpr int kWarps = kThreads / 32;
constexpr int kGrads = 9;

enum BackwardVariant : int {
  kBwdBase = 0,
  kBwdDbuf2 = 1,
  kBwdNoRed = 2,
  kBwdSmemAtomic = 3,
  kBwdFused = 4,
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// dbuf2's double buffer: floats 0-3 (x, y, A, B), 4-7 (C, opa, r, g) and 8
// (b) of each gathered row, as they are in device memory.
struct RawBatch {
  float4 xyab[kBatchB];
  float4 copg[kBatchB];
  float b[kBatchB];
};

// Start the copies of the n gathered rows from `first` on into `buf`.
__device__ __forceinline__ void stage_async(RawBatch& buf, const float* __restrict__ rows,
                                            long long first, int n) {
  for (int c = threadIdx.x; c < 3 * n; c += kThreads) {
    const int e = c / 3;
    const int part = c - 3 * e;
    const float* src = rows + (first + e) * kRowFloats + 4 * part;
    if (part == 0) {
      cp_async16(&buf.xyab[e], src);
    } else if (part == 1) {
      cp_async16(&buf.copg[e], src);
    } else {
      cp_async4(&buf.b[e], src);
    }
  }
}

__device__ __forceinline__ Splat raw_splat(const RawBatch& buf, int j) {
  const float4 a = buf.xyab[j];
  const float4 c = buf.copg[j];
  Splat s;
  s.x = a.x;
  s.y = a.y;
  s.nA = -0.5f * a.z;
  s.B = a.w;
  s.nC = -0.5f * c.x;
  s.opa = c.y;
  s.r = c.z;
  s.g = c.w;
  s.b = buf.b[j];
  return s;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_backward_kernel(const float* __restrict__ rows, long long m_pad,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_lens,
                      const float* __restrict__ dl_dcolor,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib,
                      float* __restrict__ grads,
                      const int* __restrict__ sorted_gauss,
                      int* __restrict__ walked, int n_tx, int tile_w,
                      int tile_h, int width_p, int height_p) {
  constexpr bool kDbuf = V == kBwdDbuf2;
  // rows of the shared sum buffer: one per warp, or one shared by all
  constexpr int kRedRows = (V == kBwdNoRed || V == kBwdSmemAtomic) ? 1 : kWarps;
  __shared__ Splat s_splat[kDbuf ? 1 : kBatchB];
  __shared__ RawBatch s_raw[kDbuf ? 2 : 1];
  __shared__ float s_red[kRedRows][kBatchB][kGrads];
  __shared__ int s_nmax;

  const int tile = blockIdx.x;
  const int tx = tile % n_tx;
  const int ty = tile / n_tx;
  const long long start = tile_starts[tile];
  int len = tile_lens[tile];
  if (start + len > m_pad) len = static_cast<int>(m_pad - start);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long plane = static_cast<long long>(width_p) * height_p;

  float px[kPixPerThread], py[kPixPerThread];
  float dlr[kPixPerThread], dlg[kPixPerThread], dlb[kPixPerThread];
  float T[kPixPerThread], sdl[kPixPerThread];
  int nc[kPixPerThread];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int flat = threadIdx.x + k * kThreads;
    const int row = ty * tile_h + flat / tile_w;
    const int col = tx * tile_w + flat % tile_w;
    const long long pix = static_cast<long long>(row) * width_p + col;
    px[k] = static_cast<float>(col);
    py[k] = static_cast<float>(row);
    dlr[k] = dl_dcolor[pix];
    dlg[k] = dl_dcolor[plane + pix];
    dlb[k] = dl_dcolor[2 * plane + pix];
    T[k] = final_t[pix];
    sdl[k] = 0.0f;
    nc[k] = n_contrib[pix];
    my_max = max(my_max, nc[k]);
  }
  if (threadIdx.x == 0) s_nmax = 0;
  __syncthreads();
  atomicMax(&s_nmax, my_max);
  __syncthreads();
  // entries past every pixel's last contributor have zero gradient
  const int n_walk = min(s_nmax, len);
  if (walked != nullptr && threadIdx.x == 0) walked[tile] = n_walk;

  int buf = 0;
  if constexpr (kDbuf) {
    if (n_walk > 0) {
      const int lo0 = max(n_walk - kBatchB, 0);
      stage_async(s_raw[0], rows, start + lo0, n_walk - lo0);
    }
    cp_async_commit();
  }

  for (int hi = n_walk; hi > 0; hi -= kBatchB) {
    const int lo = max(hi - kBatchB, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's shared reads are done
    if constexpr (kDbuf) {
      // the next batch into the other buffer, then wait for this one's copies
      if (lo > 0) {
        const int lo2 = max(lo - kBatchB, 0);
        stage_async(s_raw[buf ^ 1], rows, start + lo2, lo - lo2);
      }
      cp_async_commit();
      cp_async_wait_one();
    } else if (threadIdx.x < n) {
      s_splat[threadIdx.x] = load_splat(rows, start + lo + threadIdx.x);
    }
    if (V == kBwdSmemAtomic) {
      for (int i = threadIdx.x; i < n * kGrads; i += kThreads) (&s_red[0][0][0])[i] = 0.0f;
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      Splat s;
      if constexpr (kDbuf) s = raw_splat(s_raw[buf], j); else s = s_splat[j];
      const int pos = lo + j + 1;  // 1-based in-range index
      float q[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) q[i] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float dx = __fsub_rn(s.x, px[k]);
        const float dy = __fsub_rn(s.y, py[k]);
        const float power = splat_power(s, dx, dy);
        const float g = expf(power);
        const float alpha = splat_alpha(s, g);
        if (!contributes(alpha, power) || pos > nc[k]) continue;
        any = true;
        const float inv_om = 1.0f / (1.0f - alpha);
        T[k] = T[k] * inv_om;  // T before this entry
        const float w = alpha * T[k];
        const float s1 = s.r * dlr[k] + s.g * dlg[k] + s.b * dlb[k];
        const float dalpha = T[k] * s1 - sdl[k] * inv_om;
        const float e = g * dalpha;       // dL/d(opa * G)
        const float gd = s.opa * e;
        const float t1 = gd * dx;
        const float t2 = gd * dy;
        q[0] += t1;
        q[1] += t2;
        q[2] += t1 * dx;
        q[3] += t1 * dy;
        q[4] += t2 * dy;
        q[5] += e;
        q[6] += w * dlr[k];
        q[7] += w * dlg[k];
        q[8] += w * dlb[k];
        sdl[k] += w * s1;
      }
      if (V == kBwdNoRed) {
        // every thread's partial moments stay computed; thread 0's are the record
#pragma unroll
        for (int i = 0; i < kGrads; ++i) asm volatile("" ::"f"(q[i]));
        if (threadIdx.x == 0) {
#pragma unroll
          for (int i = 0; i < kGrads; ++i) s_red[0][j][i] = q[i];
        }
      } else if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) {
          float v = q[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) {
            if (V == kBwdSmemAtomic) {
              atomicAdd(&s_red[0][j][i], v);
            } else {
              s_red[warp][j][i] = v;
            }
          }
        }
      } else if (V != kBwdSmemAtomic && lane == 0) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) s_red[warp][j][i] = 0.0f;
      }
    }
    __syncthreads();

    // sum the warps and turn the raw moments into per-entry gradients
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float m[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kRedRows; ++w) v += s_red[w][j][i];
        m[i] = v;
      }
      Splat s;
      if constexpr (kDbuf) s = raw_splat(s_raw[buf], j); else s = s_splat[j];
      const float A = -2.0f * s.nA;
      const float C = -2.0f * s.nC;
      float out[kGrads];
      out[0] = -(A * m[0] + s.B * m[1]);   // d x
      out[1] = -(C * m[1] + s.B * m[0]);   // d y
      out[2] = -0.5f * m[2];               // d A
      out[3] = -m[3];                      // d B
      out[4] = -0.5f * m[4];               // d C
      out[5] = m[5];                       // d opa
      out[6] = m[6];                       // d r
      out[7] = m[7];                       // d g
      out[8] = m[8];                       // d b
      if (V == kBwdFused) {
        float* dst = grads + static_cast<long long>(sorted_gauss[start + lo + j]) * kGrads;
#pragma unroll
        for (int i = 0; i < kGrads; ++i) atomicAdd(dst + i, out[i]);
      } else {
        float* dst = grads + (start + lo + j) * kGrads;
#pragma unroll
        for (int i = 0; i < kGrads; ++i) dst[i] = out[i];
      }
    }
    buf ^= 1;
  }
}

template <int V>
cudaError_t launch(const float* rows, long long m_pad, const int* tile_starts,
                   const int* tile_lens, const float* dl_dcolor, const float* final_t,
                   const int* n_contrib, float* grads, const int* sorted_gauss,
                   int* walked, int n_tx, int n_ty, int tile_w, int tile_h,
                   cudaStream_t stream) {
  probe_backward_kernel<V><<<n_tx * n_ty, kThreads, 0, stream>>>(
      rows, m_pad, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib, grads,
      sorted_gauss, walked, n_tx, tile_w, tile_h, n_tx * tile_w, n_ty * tile_h);
  return cudaGetLastError();
}

}  // namespace
}  // namespace glic

// `grads`: (m_pad, 9) zeros, or for fused (P+1, 9) zeros indexed by
// `sorted_gauss` (m_pad,) int32 (null for the other variants). `walked`:
// (n_tiles,) int32 or null. dbuf2 needs `rows` 16-byte aligned.
extern "C" int glic_blend_probe_backward(int variant, const float* rows, long long m_pad,
                                         const int* tile_starts, const int* tile_lens,
                                         const float* dl_dcolor, const float* final_t,
                                         const int* n_contrib, float* grads,
                                         const int* sorted_gauss, int* walked, int n_tx,
                                         int n_ty, int tile_w, int tile_h, void* stream) {
  using namespace glic;
  if (tile_w * tile_h != kTilePix) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kBwdFused && sorted_gauss == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kBwdDbuf2 && reinterpret_cast<unsigned long long>(rows) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_tx * n_ty <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (variant) {
#define GLIC_CASE(V)                                                                     \
  case V:                                                                                \
    rc = launch<V>(rows, m_pad, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib,   \
                   grads, sorted_gauss, walked, n_tx, n_ty, tile_w, tile_h, s);          \
    break;
    GLIC_CASE(kBwdBase)
    GLIC_CASE(kBwdDbuf2)
    GLIC_CASE(kBwdNoRed)
    GLIC_CASE(kBwdSmemAtomic)
    GLIC_CASE(kBwdFused)
#undef GLIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}
