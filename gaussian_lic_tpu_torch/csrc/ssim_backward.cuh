// K12's kernel templates, shared by K12 (ssim_backward.cu, which launches
// kK12Base) and its timing variants (ssim_backward_probe.cu, every variant),
// as K11's ssim_forward.cuh is shared with its probe. ssim_backward.cu says
// what K12 computes; this header holds its two designs.
//
// The first design (kK12First) gave a 256-thread block a 32 x 32 tile with
// 37,296 B of static shared memory under __launch_bounds__(256, 4): the
// three partial maps staged with their apron, a vertical pass of 336 column
// segments of 4 rows on 256 threads (two rounds for 1.31 rounds of work),
// then a horizontal pass that read 11 shared words an output for each map
// (33 loads a pixel) and an epilogue that read x and y a word at a time.
// Its variants take one cost centre out each:
//   kK12FirstNoVert   timing only: the vertical pass copies its centre
//                     value (no blur)
//   kK12FirstNoHoriz  timing only: the horizontal pass reads its centre
//                     value (no blur, one load a map)
//   kK12FirstNoEpi    timing only: no x or y loads and no sign or L1 term
//                     (d = g_m (b1 + b2 + b3))
//   kK12FirstLb5      the first design under __launch_bounds__(256, 5)
//                     (bit for bit)
//
// The listed design (ssim_backward_kernel; kK12Base: a 64 x 16 tile, 256
// threads, 5 blocks an SM, vertical segments of 4 rows) carries over what
// paid in K11 (ssim_forward.cuh (a)-(d)) and keeps every rounded operation
// and its order (the vertical pass before the horizontal one, taps in
// order, then g_m (b1 + 2 x b2 + y b3) + g_d sgn w), so its d is the first
// design's bit for bit:
//  (a) the block stages the three maps with cp.async, zeros outside the
//      window and the image by the copy's zero fill, all of a thread's
//      copies in flight before one wait: each staged row from 8 columns left
//      of the tile in 16-byte copies, 20 a row where a 4-byte copy a word
//      took 74 (W % 4 == 0; else a word a copy). Plain loads, each
//      iteration's three waiting for the last's (kK12Sync), and 4-byte
//      copies (kK12A4) are slower. The staged maps and the vertical pass's
//      output have rows padded to a multiple of 4 words;
//  (b) the vertical pass splits each staged column into segments of R output
//      rows; a segment streams its R + 10 input rows once and keeps its
//      3 x R running sums in registers (each output's taps still in order);
//  (c) the horizontal pass gives a thread 4 adjacent outputs of a row: for
//      each map it reads 16 words as four 16-byte loads (the 14 its taps
//      need) and blurs them from registers, 3 loads a pixel instead of 33;
//  (d) x and y are read and d is written 16 bytes at a time where the row
//      allows (W a multiple of 4, 16-byte aligned rows of x and y).
// Its variants: kK12T32x32 (K11's tile), kK12R8, kK12T32x16 and kK12T32x24
// other geometries (kK12Shapes; t32x24 fits 6 blocks an SM in 32,256 B);
// kK12A4 the staging by 4-byte copies, kK12Sync by plain loads; and, timing
// only, kK12NoStage (nothing staged: no map loads), and kK12NoVert,
// kK12NoHoriz and kK12NoEpi, the first design's cost centres taken out of
// this one.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ssim_common.cuh"

namespace glic_k12 {

using glic_ssim::Konst;
using glic_ssim::kR;
using glic_ssim::kTaps;

constexpr int kMaps = 3;   // dm/dmu1, dm/dsigma1^2, dm/dsigma12

enum K12Variant : int {
  kK12Base = 0,
  kK12T32x32 = 1,
  kK12A4 = 2,
  kK12Sync = 3,
  kK12R8 = 4,
  kK12T32x16 = 5,
  kK12T32x24 = 6,
  kK12NoStage = 7,
  kK12NoVert = 8,
  kK12NoHoriz = 9,
  kK12NoEpi = 10,
  kK12First = 11,
  kK12FirstNoVert = 12,
  kK12FirstNoHoriz = 13,
  kK12FirstNoEpi = 14,
  kK12FirstLb5 = 15,
};

struct K12Shape {
  int tile_w, tile_h, threads, min_blocks, seg_rows;
};

// K12's geometries, by variant: {tile width, tile height, threads, blocks an
// SM, output rows a vertical segment}
constexpr K12Shape kK12Shapes[] = {
    {64, 16, 256, 5, 4},    // base
    {32, 32, 256, 5, 4},    // t32x32
    {64, 16, 256, 5, 4},    // a4
    {64, 16, 256, 5, 4},    // sync
    {64, 16, 256, 5, 8},    // r8
    {32, 16, 128, 10, 4},   // t32x16
    {32, 24, 256, 6, 4},    // t32x24
    {64, 16, 256, 5, 4},    // nostage
    {64, 16, 256, 5, 4},    // novert
    {64, 16, 256, 5, 4},    // nohoriz
    {64, 16, 256, 5, 4},    // noepi
    {32, 32, 256, 4, 4},    // first
    {32, 32, 256, 4, 4},    // first_novert
    {32, 32, 256, 4, 4},    // first_nohoriz
    {32, 32, 256, 4, 4},    // first_noepi
    {32, 32, 256, 5, 4},    // first_lb5
};

template <int V>
struct Geo {
  static constexpr K12Shape s = kK12Shapes[V];
  static constexpr int TW = s.tile_w, TH = s.tile_h, THREADS = s.threads;
  static constexpr int MIN_BLOCKS = s.min_blocks;
  // the staging by cp.async (zero-filled outside the window); staged rows
  // from 8 columns left of the tile, 16-byte copies (where the maps' rows
  // allow: Args::vec_maps)
  static constexpr bool ASYNC = V != kK12Sync;
  static constexpr bool V16 = V != kK12A4 && V != kK12Sync;
  static constexpr int SPAN_W = TW + 2 * kR;          // staged columns
  static constexpr int SPAN_H = TH + 2 * kR;          // staged rows
  static constexpr int PITCH = (SPAN_W + 3) / 4 * 4;  // a row's words: 16-byte rows
  static constexpr int PITCH_S = V16 ? TW + 16 : PITCH;  // a staged row's words
  static constexpr int VEC_W = PITCH_S / 4;             // a staged row's 16-byte groups
  static constexpr int R = s.seg_rows;                // output rows a vertical segment
  static constexpr int NSEG = TH / R;                 // vertical segments a column
  static constexpr int GROUPS = TW / 4;               // 4-pixel groups a row
  static_assert(TW % 4 == 0 && TH % R == 0 && THREADS % 32 == 0, "K12 geometry");
  static_assert(TH * GROUPS <= THREADS, "a thread's 4-pixel groups: one at most");
  static_assert(TW - 4 + 16 <= PITCH, "a group's four 16-byte loads stay in its row");
};

struct Args {
  const float* x;
  long long x_cs, x_rs;
  const float* y;
  long long y_cs, y_rs;
  int C, H, W, r0, r1;
  const float* partials;   // (3, C, r1 - r0, W)
  const float* grad;       // (2,): g_m, g_d
  float* d;                // (C, H, W)
  bool vec;                // x and y rows 16-byte aligned and W % 4 == 0
  bool vec_maps;           // the partial maps' rows 16-byte aligned (W % 4 == 0)
};

// Is the 16-byte path open: 4-pixel groups of x, y and d 16-byte aligned?
inline bool vec_ok(const Args& a) {
  const auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return (a.W & 3) == 0 && al(a.x) && al(a.y) && al(a.d) && (a.x_cs & 3) == 0 &&
         (a.x_rs & 3) == 0 && (a.y_cs & 3) == 0 && (a.y_rs & 3) == 0;
}

// d for one pixel from its three blurred maps: the plain chain's operations
// in order (`ssim_backward_plain`); sgn is 0 at x == y, as autograd's abs
// backward, and the L1 term is 0 outside the window's rows.
__device__ __forceinline__ float pixel_d(float b1, float b2, float b3, float xv, float yv,
                                         float g_m, float g_d, bool in_window) {
  const float inner =
      __fadd_rn(__fadd_rn(b1, __fmul_rn(__fmul_rn(2.f, xv), b2)), __fmul_rn(yv, b3));
  const float sgn = static_cast<float>((xv > yv) - (xv < yv));
  const float l1 = in_window ? __fmul_rn(g_d, sgn) : 0.f;
  return __fadd_rn(__fmul_rn(g_m, inner), l1);
}

// ---------------------------------------------------------------------------
// the listed design
// ---------------------------------------------------------------------------

// one word from device memory into shared memory, asynchronously; zeros
// where `in` is false (src is not read then)
__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// 16 bytes likewise (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x and y of the 4-pixel group at (c, gr, gc): 16-byte loads on the vector
// path, else a word each inside the row (zeros past it)
__device__ __forceinline__ void load_xy(const Args& a, int c, int gr, int gc, float (&xv)[4],
                                        float (&yv)[4]) {
  const float* xr = a.x + c * a.x_cs + gr * a.x_rs + gc;
  const float* yr = a.y + c * a.y_cs + gr * a.y_rs + gc;
  if (a.vec) {   // gc + 3 < W: W and gc are multiples of 4
    const float4 fx = __ldg(reinterpret_cast<const float4*>(xr));
    const float4 fy = __ldg(reinterpret_cast<const float4*>(yr));
    xv[0] = fx.x, xv[1] = fx.y, xv[2] = fx.z, xv[3] = fx.w;
    yv[0] = fy.x, yv[1] = fy.y, yv[2] = fy.z, yv[3] = fy.w;
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool in = gc + h < a.W;
      xv[h] = in ? __ldg(xr + h) : 0.f;
      yv[h] = in ? __ldg(yr + h) : 0.f;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(Geo<V>::THREADS, Geo<V>::MIN_BLOCKS)
    ssim_backward_kernel(Args a, Konst k) {
  using G = Geo<V>;
  // the staged maps (map m's rows from m SPAN_H; zeros outside the window's
  // rows and the image's columns, `_blur`'s zero padding), the vertical
  // pass's output
  __shared__ __align__(16) float ps[kMaps * G::SPAN_H][G::PITCH_S];
  __shared__ __align__(16) float vs[kMaps][G::TH][G::PITCH];
  const int c = blockIdx.z;
  const int row0 = blockIdx.y * G::TH;
  const int col0 = blockIdx.x * G::TW;
  const long long plane = static_cast<long long>(a.r1 - a.r0) * a.W;
  const long long stride = plane * a.C;
  const float* pc = a.partials + c * plane;
  // the staged column of apron column q is q + qoff
  const int qoff = G::V16 && a.vec_maps ? 8 - kR : 0;
  if constexpr (G::V16 && V != kK12NoStage) {
    if (a.vec_maps) {   // 16-byte groups from col0 - 8: each inside or outside the row
      for (int i = threadIdx.x; i < G::SPAN_H * G::VEC_W; i += G::THREADS) {
        const int r = i / G::VEC_W, v4 = (i - r * G::VEC_W) * 4;
        const int gr = row0 - kR + r, gc = col0 - 8 + v4;
        const bool in = gr >= a.r0 && gr < a.r1 && gc >= 0 && gc < a.W;
        const long long o = static_cast<long long>(gr - a.r0) * a.W + gc;
#pragma unroll
        for (int m = 0; m < kMaps; ++m)
          cp_async16_zfill(&ps[m * G::SPAN_H + r][v4], pc + m * stride + (in ? o : 0), in);
      }
    }
  }
  if constexpr (V != kK12NoStage) {
    for (int i = threadIdx.x; i < G::SPAN_H * G::SPAN_W; i += G::THREADS) {
      if (G::V16 && a.vec_maps) break;
      const int r = i / G::SPAN_W, q = i - r * G::SPAN_W;
      const int gr = row0 - kR + r, gc = col0 - kR + q;
      const bool in = gr >= a.r0 && gr < a.r1 && gc >= 0 && gc < a.W;
      const long long o = static_cast<long long>(gr - a.r0) * a.W + gc;
#pragma unroll
      for (int m = 0; m < kMaps; ++m) {
        if constexpr (G::ASYNC) {   // src stays inside map m where nothing is read
          cp_async4_zfill(&ps[m * G::SPAN_H + r][q], pc + m * stride + (in ? o : 0), in);
        } else {
          ps[m * G::SPAN_H + r][q] = in ? __ldg(pc + m * stride + o) : 0.f;
        }
      }
    }
  }
  if constexpr (G::ASYNC) cp_async_wait_all();
  __syncthreads();

  // vertical pass: segment g of column q outputs rows [g R, g R + R); input
  // row g R + i adds tap i - j to output j, so each output's taps come in order
  for (int s = threadIdx.x; s < G::SPAN_W * G::NSEG; s += G::THREADS) {
    const int g = s / G::SPAN_W, q = s - g * G::SPAN_W;
    const int rs = g * G::R;
    if constexpr (V == kK12NoVert) {   // timing only: the centre row, no blur
#pragma unroll
      for (int j = 0; j < G::R; ++j)
#pragma unroll
        for (int m = 0; m < kMaps; ++m)
          vs[m][rs + j][q] = ps[m * G::SPAN_H + rs + j + kR][q + qoff];
      continue;
    }
    float acc[kMaps][G::R];
#pragma unroll
    for (int i = 0; i < G::R + 2 * kR; ++i) {
      float v[kMaps];
#pragma unroll
      for (int m = 0; m < kMaps; ++m) v[m] = ps[m * G::SPAN_H + rs + i][q + qoff];
#pragma unroll
      for (int j = 0; j < G::R; ++j) {
        if (i == j) {
#pragma unroll
          for (int m = 0; m < kMaps; ++m) acc[m][j] = __fmul_rn(k.tap[0], v[m]);
        } else if (i > j && i - j < kTaps) {
#pragma unroll
          for (int m = 0; m < kMaps; ++m)
            acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(k.tap[i - j], v[m]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G::R; ++j)
#pragma unroll
      for (int m = 0; m < kMaps; ++m) vs[m][rs + j][q] = acc[m][j];
  }
  __syncthreads();

  // horizontal pass and epilogue: a thread's 4 adjacent outputs
  const int lr = threadIdx.x / G::GROUPS, c4 = (threadIdx.x - lr * G::GROUPS) * 4;
  const int gr = row0 + lr, gc = col0 + c4;
  if (threadIdx.x >= G::TH * G::GROUPS || gr >= a.H || gc >= a.W) return;
  const float g_m = __ldg(a.grad), g_d = __ldg(a.grad + 1);
  float bl[kMaps][4];
#pragma unroll
  for (int m = 0; m < kMaps; ++m) {
    float v[16];
    const float4* src = reinterpret_cast<const float4*>(&vs[m][lr][c4]);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 f = src[w];
      v[4 * w] = f.x;
      v[4 * w + 1] = f.y;
      v[4 * w + 2] = f.z;
      v[4 * w + 3] = f.w;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if constexpr (V == kK12NoHoriz) {   // timing only: the centre column, no blur
        bl[m][h] = v[h + kR];
      } else {
        float acc = __fmul_rn(k.tap[0], v[h]);
#pragma unroll
        for (int i = 1; i < kTaps; ++i) acc = __fadd_rn(acc, __fmul_rn(k.tap[i], v[h + i]));
        bl[m][h] = acc;
      }
    }
  }
  const long long o = (static_cast<long long>(c) * a.H + gr) * a.W + gc;
  float out[4];
  if constexpr (V == kK12NoEpi) {   // timing only: no x, y or L1 term
#pragma unroll
    for (int h = 0; h < 4; ++h)
      out[h] = __fmul_rn(g_m, __fadd_rn(__fadd_rn(bl[0][h], bl[1][h]), bl[2][h]));
  } else {
    const bool in_window = gr >= a.r0 && gr < a.r1;
    float xv[4], yv[4];
    load_xy(a, c, gr, gc, xv, yv);
#pragma unroll
    for (int h = 0; h < 4; ++h)
      out[h] = pixel_d(bl[0][h], bl[1][h], bl[2][h], xv[h], yv[h], g_m, g_d, in_window);
  }
  if (a.vec) {
    *reinterpret_cast<float4*>(a.d + o) = make_float4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (gc + h < a.W) a.d[o + h] = out[h];
  }
}

// ---------------------------------------------------------------------------
// the first design and its cost-centre variants
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(glic_ssim::kThreads, Geo<V>::MIN_BLOCKS)
    ssim_backward_first_kernel(Args a, Konst k) {
  using namespace glic_ssim;
  __shared__ float ps[kMaps][kSpan][kSpan];
  __shared__ float vs[kMaps][kTile][kSpan];
  const int c = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const long long plane = static_cast<long long>(a.r1 - a.r0) * a.W;
  const long long stride = plane * gridDim.z;
  const float* pc = a.partials + c * plane;
  for (int i = tid; i < kSpan * kSpan; i += kThreads) {
    const int r = i / kSpan, q = i - r * kSpan;
    const int gr = row0 - kR + r, gc = col0 - kR + q;
    const bool in = gr >= a.r0 && gr < a.r1 && gc >= 0 && gc < a.W;
    const long long o = static_cast<long long>(gr - a.r0) * a.W + gc;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) ps[m][r][q] = in ? __ldg(pc + m * stride + o) : 0.f;
  }
  __syncthreads();

  for (int s = tid; s < kSegments; s += kThreads) {
    const int g = s / kSpan, q = s - g * kSpan;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
      if constexpr (V == kK12FirstNoVert) {   // timing only: the centre row, no blur
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          vs[m][g * kPerThread + j][q] = ps[m][g * kPerThread + j + kR][q];
      } else {
        float p[kSeg];
#pragma unroll
        for (int i = 0; i < kSeg; ++i) p[i] = ps[m][g * kPerThread + i][q];
        vertical(p, &vs[m][g * kPerThread][q], k);
      }
    }
  }
  __syncthreads();

  const float g_m = __ldg(a.grad), g_d = __ldg(a.grad + 1);
  const int tx = threadIdx.x;
  const int gc = col0 + tx;
  if (gc >= a.W) return;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int lr = threadIdx.y * kPerThread + j;
    const int gr = row0 + lr;
    if (gr >= a.H) break;
    float b[kMaps];
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
      if constexpr (V == kK12FirstNoHoriz) {   // timing only: the centre column, no blur
        b[m] = vs[m][lr][tx + kR];
      } else {
        b[m] = blur11(&vs[m][lr][tx], 1, k);
      }
    }
    float out;
    if constexpr (V == kK12FirstNoEpi) {   // timing only: no x, y or L1 term
      out = __fmul_rn(g_m, __fadd_rn(__fadd_rn(b[0], b[1]), b[2]));
    } else {
      const float xv = __ldg(a.x + c * a.x_cs + gr * a.x_rs + gc);
      const float yv = __ldg(a.y + c * a.y_cs + gr * a.y_rs + gc);
      out = pixel_d(b[0], b[1], b[2], xv, yv, g_m, g_d, gr >= a.r0 && gr < a.r1);
    }
    a.d[(static_cast<long long>(c) * a.H + gr) * a.W + gc] = out;
  }
}

template <int V>
cudaError_t launch_ssim_backward(Args a, const Konst& k, cudaStream_t s) {
  using G = Geo<V>;
  a.vec = vec_ok(a);
  a.vec_maps = (a.W & 3) == 0 && (reinterpret_cast<uintptr_t>(a.partials) & 15) == 0;
  const dim3 grid((a.W + G::TW - 1) / G::TW, (a.H + G::TH - 1) / G::TH, a.C);
  if constexpr (V >= kK12First) {
    ssim_backward_first_kernel<V><<<grid, dim3(glic_ssim::kTile, glic_ssim::kRows), 0, s>>>(a, k);
  } else {
    ssim_backward_kernel<V><<<grid, G::THREADS, 0, s>>>(a, k);
  }
  return cudaGetLastError();
}

}  // namespace glic_k12
