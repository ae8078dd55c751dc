// K11's kernel templates, shared by K11 (ssim_forward.cu, which launches
// kK11Base) and its timing variants (ssim_forward_probe.cu, every variant),
// as K6's preprocess_backward.cuh is shared with its probe. ssim_forward.cu
// says what K11 computes; this header holds its two designs. K12
// (ssim_backward.cuh) has the same two.
//
// The first design (kK11First) gave a 256-thread block a 32 x 32 tile with
// 41,056 B of static shared memory under __launch_bounds__(256, 4): its
// vertical pass ran 336 column segments of 4 rows on 256 threads (two
// rounds for 1.31 rounds of work), and its horizontal pass read 11 shared
// words an output for each of the five quantities (55 loads a pixel) on top
// of ~272 FP32 operations. Its variants take one cost centre out each:
//   kK11FirstNoVert   timing only: the vertical pass copies its centre
//                     value (no blur, no products)
//   kK11FirstNoHoriz  timing only: the horizontal pass reads its centre
//                     value (no blur, one load a quantity)
//   kK11FirstHRegs    timing only: the horizontal pass's 11 loads a quantity
//                     become 6 two-word loads (the taps land one column off
//                     for odd columns)
//   kK11FirstLb5      the first design under __launch_bounds__(256, 5): 5 x
//                     41 KB fit an SM (bit for bit)
//
// The design K11 launches (ssim_forward_kernel; kK11Base's geometry: a
// 32 x 32 tile, 256 threads, 5 blocks an SM, vertical segments of 4 rows)
// keeps every rounded operation and its order (vertical before horizontal,
// taps in order, x^2, y^2, xy rounded before their blur), so its partial
// maps are the first design's bit for bit:
//  (a) the staged tile and the vertical pass's output have rows padded to a
//      multiple of 4 words (16 bytes);
//  (b) the vertical pass splits each staged column into segments of R output
//      rows; a segment streams its R + 10 input rows once and keeps its 5 x R
//      running sums in registers (each output's taps still in order, k =
//      0..10);
//  (c) the horizontal pass gives a thread 4 adjacent outputs of a row: for
//      each quantity it reads 16 words as four 16-byte loads (the 14 its
//      taps need) and blurs them from registers, 5 loads a pixel instead of
//      55; eight threads of a quarter-warp read one row's consecutive words,
//      so the loads have no bank conflicts;
//  (d) it writes the three partial maps 16 bytes at a time where the row
//      allows (W a multiple of 4);
//  (e) the last block to finish sums the blocks' sums in a fixed order
//      (fold_sums), so no reduction kernel follows K11.
// Its variants: kK11R8, kK11T32x16, kK11T64x16, kK11T64x16R4 and
// kK11T128x8R4 other geometries (kK11Shapes); kK11Persist persistent blocks
// that take tiles from a counter (ssim_forward_persist_kernel); kK11NoFold
// the sums left to the wrapper, as the first design does; and, timing only,
// kK11NoMaps (the five quantities summed: no map, divisions or partial-map
// stores), kK11NoStage (zeros staged: no image loads), kK11NoVert and
// kK11NoHoriz (a pass's centre value, no blur).

#pragma once

#include <cuda_runtime.h>

#include "ssim_common.cuh"

namespace glic_ssim {

constexpr int kQuantities = 5;   // x, y, x^2, y^2, xy

enum K11Variant : int {
  kK11Base = 0,
  kK11R8 = 1,
  kK11T32x16 = 2,
  kK11T64x16 = 3,
  kK11NoFold = 4,
  kK11NoMaps = 5,
  kK11NoStage = 6,
  kK11NoVert = 7,
  kK11NoHoriz = 8,
  kK11T64x16R4 = 9,
  kK11T128x8R4 = 10,
  kK11Persist = 11,
  kK11First = 12,
  kK11FirstNoVert = 13,
  kK11FirstNoHoriz = 14,
  kK11FirstHRegs = 15,
  kK11FirstLb5 = 16,
};

// Does variant V's kernel sum its blocks' sums itself (the last block to
// finish), or leave them to the wrapper?
template <int V>
constexpr bool kFolds = V < kK11First && V != kK11NoFold;

struct K11Shape {
  int tile_w, tile_h, threads, min_blocks, seg_rows;
};

// K11's geometries, by variant: {tile width, tile height, threads, blocks an
// SM, output rows a vertical segment}
constexpr K11Shape kK11Shapes[] = {
    {32, 32, 256, 5, 4},   // base
    {32, 32, 256, 4, 8},   // r8
    {32, 16, 128, 8, 8},   // t32x16
    {64, 16, 256, 4, 8},   // t64x16
    {32, 32, 256, 5, 4},   // nofold
    {32, 32, 256, 5, 4},   // nomaps
    {32, 32, 256, 5, 4},   // nostage
    {32, 32, 256, 5, 4},   // novert
    {32, 32, 256, 5, 4},   // nohoriz
    {64, 16, 256, 5, 4},   // t64x16r4
    {128, 8, 256, 5, 4},   // t128x8r4
    {32, 32, 256, 5, 4},   // persist
    {32, 32, 256, 4, 4},   // first
    {32, 32, 256, 4, 4},   // first_novert
    {32, 32, 256, 4, 4},   // first_nohoriz
    {32, 32, 256, 4, 4},   // first_hregs
    {32, 32, 256, 5, 4},   // first_lb5
};

template <int V>
struct Geo {
  static constexpr K11Shape s = kK11Shapes[V];
  static constexpr int TW = s.tile_w, TH = s.tile_h, THREADS = s.threads;
  static constexpr int MIN_BLOCKS = s.min_blocks;
  static constexpr int SPAN_W = TW + 2 * kR;             // staged columns
  static constexpr int SPAN_H = TH + 2 * kR;             // staged rows
  static constexpr int PITCH = (SPAN_W + 3) / 4 * 4;     // a row's words: 16-byte rows
  static constexpr int R = s.seg_rows;                   // output rows a vertical segment
  static constexpr int NSEG = TH / R;                    // vertical segments a column
  static constexpr int GROUPS = TW / 4;                  // 4-pixel groups a row
  static_assert(TW % 4 == 0 && TH % R == 0 && THREADS % 32 == 0, "K11 geometry");
  static_assert(TW - 4 + 16 <= PITCH, "a group's four 16-byte loads stay in its row");
};

struct Images {
  const float* x;
  long long x_cs, x_rs;
  const float* y;
  long long y_cs, y_rs;
  int H, W, r0, r1;
};

// The count of K11's finished blocks, for the last one to sum them all; it
// zeroes it for the next launch. Zero when the module loads; K11's launches
// on a device run one after another (one stream).
static __device__ unsigned g_k11_done;
// kK11Persist's next tile, taken by its blocks in turn; its last block zeroes
// it with g_k11_done.
static __device__ unsigned g_k11_next;

// The block's threads' two sums, in a fixed order: a shuffle tree in each
// warp, then the warps in order; thread 0 gets the block's.
template <int kThreadsT>
__device__ __forceinline__ void block_sums2(float& m_sum, float& d_sum,
                                            float (*red)[kThreadsT / 32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m_sum = __fadd_rn(m_sum, __shfl_xor_sync(0xffffffffu, m_sum, off));
    d_sum = __fadd_rn(d_sum, __shfl_xor_sync(0xffffffffu, d_sum, off));
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = m_sum;
    red[1][tid >> 5] = d_sum;
  }
  __syncthreads();
  if (tid == 0) {
    m_sum = red[0][0];
    d_sum = red[1][0];
#pragma unroll
    for (int w = 1; w < kThreadsT / 32; ++w) {
      m_sum = __fadd_rn(m_sum, red[0][w]);
      d_sum = __fadd_rn(d_sum, red[1][w]);
    }
  }
}

// Called by every thread of each of the n blocks once its rows of
// block_sums are written: the last block to finish sums the first `rows`
// rows of block_sums in a fixed order (thread t the rows t, t + threads, ...
// in turn, then block_sums2's tree) into row `total`, and zeroes the
// counters. No float atomics, so every launch, eager or replayed, gives the
// same sums.
template <int kThreadsT>
__device__ __forceinline__ void fold_sums(float (*red)[kThreadsT / 32], float* block_sums,
                                          unsigned n, unsigned rows, unsigned total) {
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&g_k11_done, 1u) == n - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float ms = 0.f, ds = 0.f;
  constexpr int kBatch = 8;   // loads in flight before their adds, in order
  for (unsigned i0 = tid; i0 < rows; i0 += kBatch * kThreadsT) {
    float2 got[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const unsigned i = i0 + j * kThreadsT;
      got[j] = i < rows ? __ldcg(reinterpret_cast<const float2*>(block_sums) + i)
                        : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j * kThreadsT < rows) {
        ms = __fadd_rn(ms, got[j].x);
        ds = __fadd_rn(ds, got[j].y);
      }
    }
  }
  __syncthreads();   // red is reused
  block_sums2<kThreadsT>(ms, ds, red);
  if (tid == 0) {
    block_sums[2 * total] = ms;
    block_sums[2 * total + 1] = ds;
    g_k11_done = 0;
    g_k11_next = 0;
  }
}

// The block's sums into block_sums[2 b], [2 b + 1], b < n; with kFold, then
// fold_sums over the n rows into row n.
template <int kThreadsT, bool kFold>
__device__ __forceinline__ void store_block_sums(float m_sum, float d_sum,
                                                 float (*red)[kThreadsT / 32],
                                                 float* block_sums, unsigned b, unsigned n) {
  block_sums2<kThreadsT>(m_sum, d_sum, red);
  if (threadIdx.y * blockDim.x + threadIdx.x == 0) {
    block_sums[2 * b] = m_sum;
    block_sums[2 * b + 1] = d_sum;
  }
  if constexpr (kFold) fold_sums<kThreadsT>(red, block_sums, n, n, n);
}

// One pixel's map, its |x - y| and (with partials) its three partial maps,
// from the five blurred quantities: the plain chain's operations in order.
struct Pixel {
  float m, pm1, pm2, pm3;
};

__device__ __forceinline__ Pixel ssim_pixel(float mu1, float mu2, float exx, float eyy,
                                            float exy, const Konst& k) {
  const float mu1_sq = __fmul_rn(mu1, mu1);
  const float mu2_sq = __fmul_rn(mu2, mu2);
  const float mu1_mu2 = __fmul_rn(mu1, mu2);
  const float s1 = __fsub_rn(exx, mu1_sq);
  const float s2 = __fsub_rn(eyy, mu2_sq);
  const float s12 = __fsub_rn(exy, mu1_mu2);
  const float A = __fadd_rn(__fmul_rn(2.f, mu1_mu2), k.c1);
  const float B = __fadd_rn(__fmul_rn(2.f, s12), k.c2);
  const float num = __fmul_rn(A, B);
  const float Cm = __fadd_rn(__fadd_rn(mu1_sq, mu2_sq), k.c1);
  const float D = __fadd_rn(__fadd_rn(s1, s2), k.c2);
  const float den = __fmul_rn(Cm, D);
  Pixel px;
  px.m = __fdiv_rn(num, den);
  // dm/dmu1 = 2 (mu2 (B - A) + mu1 m (C - D)) / (C D)
  const float t = __fadd_rn(__fmul_rn(mu2, __fsub_rn(B, A)),
                            __fmul_rn(__fmul_rn(mu1, px.m), __fsub_rn(Cm, D)));
  px.pm1 = __fdiv_rn(__fmul_rn(2.f, t), den);
  px.pm2 = -__fdiv_rn(px.m, D);
  px.pm3 = __fdiv_rn(__fmul_rn(2.f, A), den);
  return px;
}

// ---------------------------------------------------------------------------
// the listed design
// ---------------------------------------------------------------------------

// The tile at (c, row0, col0) of x and y with its apron into xs and ys,
// zeros outside the image.
template <int V>
__device__ __forceinline__ void stage_tile(float (*xs)[Geo<V>::PITCH], float (*ys)[Geo<V>::PITCH],
                                           const Images& im, int c, int row0, int col0) {
  using G = Geo<V>;
  const float* xc = im.x + c * im.x_cs;
  const float* yc = im.y + c * im.y_cs;
  for (int i = threadIdx.x; i < G::SPAN_H * G::SPAN_W; i += G::THREADS) {
    const int r = i / G::SPAN_W, q = i - r * G::SPAN_W;
    const int gr = row0 - kR + r, gc = col0 - kR + q;
    const bool in = V != kK11NoStage && gr >= 0 && gr < im.H && gc >= 0 && gc < im.W;
    xs[r][q] = in ? __ldg(xc + gr * im.x_rs + gc) : 0.f;
    ys[r][q] = in ? __ldg(yc + gr * im.y_rs + gc) : 0.f;
  }
}

// vertical pass of x, y, x*x, y*y and x*y (each product rounded first, as
// the plain chain's `img1 * img1` is a tensor of its own): segment g of
// column q outputs rows [g R, g R + R); input row g R + i adds tap i - j to
// output j, so each output's taps come in order
template <int V>
__device__ __forceinline__ void vertical_pass(float (*xs)[Geo<V>::PITCH],
                                              float (*ys)[Geo<V>::PITCH],
                                              float (*vs)[Geo<V>::TH][Geo<V>::PITCH],
                                              const Konst& k) {
  using G = Geo<V>;
  for (int s = threadIdx.x; s < G::SPAN_W * G::NSEG; s += G::THREADS) {
    const int g = s / G::SPAN_W, q = s - g * G::SPAN_W;
    const int rs = g * G::R;
    if constexpr (V == kK11NoVert) {   // timing only: the centre row, no blur
#pragma unroll
      for (int j = 0; j < G::R; ++j) {
        const float a = xs[rs + j + kR][q], b = ys[rs + j + kR][q];
        vs[0][rs + j][q] = a;
        vs[1][rs + j][q] = b;
        vs[2][rs + j][q] = a;
        vs[3][rs + j][q] = b;
        vs[4][rs + j][q] = a;
      }
      continue;
    }
    float acc[kQuantities][G::R];
#pragma unroll
    for (int i = 0; i < G::R + 2 * kR; ++i) {
      const float a = xs[rs + i][q], b = ys[rs + i][q];
      const float v[kQuantities] = {a, b, __fmul_rn(a, a), __fmul_rn(b, b), __fmul_rn(a, b)};
#pragma unroll
      for (int j = 0; j < G::R; ++j) {
        if (i == j) {
#pragma unroll
          for (int u = 0; u < kQuantities; ++u) acc[u][j] = __fmul_rn(k.tap[0], v[u]);
        } else if (i > j && i - j < kTaps) {
#pragma unroll
          for (int u = 0; u < kQuantities; ++u)
            acc[u][j] = __fadd_rn(acc[u][j], __fmul_rn(k.tap[i - j], v[u]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G::R; ++j)
#pragma unroll
      for (int u = 0; u < kQuantities; ++u) vs[u][rs + j][q] = acc[u][j];
  }
}

// horizontal pass: 4 adjacent outputs a thread, the map, the partial maps
// and the L1 term of the tile at (c, row0, col0) of an image of C channels,
// added to the thread's sums
template <int V, bool kPartials>
__device__ __forceinline__ void horizontal_pass(float (*xs)[Geo<V>::PITCH],
                                                float (*ys)[Geo<V>::PITCH],
                                                float (*vs)[Geo<V>::TH][Geo<V>::PITCH],
                                                const Konst& k, const Images& im, int C, int c,
                                                int row0, int col0, float* partials,
                                                float& m_sum, float& d_sum) {
  using G = Geo<V>;
  const long long plane = static_cast<long long>(im.r1 - im.r0) * im.W;
  const long long stride = plane * C;
  const bool vec = (im.W & 3) == 0;
  for (int it = threadIdx.x; it < G::TH * G::GROUPS; it += G::THREADS) {
    const int lr = it / G::GROUPS, c4 = (it - lr * G::GROUPS) * 4;
    const int gr = row0 + lr, gc = col0 + c4;
    if (gr >= im.r1 || gc >= im.W) continue;
    float bl[kQuantities][4];
#pragma unroll
    for (int u = 0; u < kQuantities; ++u) {
      float v[16];
      const float4* src = reinterpret_cast<const float4*>(&vs[u][lr][c4]);
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
        if constexpr (V == kK11NoHoriz) {   // timing only: the centre column, no blur
          bl[u][h] = v[h + kR];
        } else {
          float acc = __fmul_rn(k.tap[0], v[h]);
#pragma unroll
          for (int i = 1; i < kTaps; ++i) acc = __fadd_rn(acc, __fmul_rn(k.tap[i], v[h + i]));
          bl[u][h] = acc;
        }
      }
    }
    float pm[3][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      Pixel px;
      if constexpr (V == kK11NoMaps) {   // timing only: every quantity summed, no map
        px.m = __fadd_rn(__fadd_rn(__fadd_rn(bl[0][h], bl[1][h]), __fadd_rn(bl[2][h], bl[3][h])),
                         bl[4][h]);
        px.pm1 = px.pm2 = px.pm3 = 0.f;
      } else {
        px = ssim_pixel(bl[0][h], bl[1][h], bl[2][h], bl[3][h], bl[4][h], k);
      }
      pm[0][h] = px.pm1;
      pm[1][h] = px.pm2;
      pm[2][h] = px.pm3;
      if (gc + h < im.W) {
        const float xv = xs[lr + kR][c4 + h + kR], yv = ys[lr + kR][c4 + h + kR];
        m_sum = __fadd_rn(m_sum, px.m);
        d_sum = __fadd_rn(d_sum, fabsf(__fsub_rn(xv, yv)));
      }
    }
    if (kPartials && V != kK11NoMaps) {
      const long long o = static_cast<long long>(c) * plane +
                          static_cast<long long>(gr - im.r0) * im.W + gc;
      if (vec) {   // gc + 3 < W: W and gc are multiples of 4
#pragma unroll
        for (int m = 0; m < 3; ++m)
          *reinterpret_cast<float4*>(partials + o + m * stride) =
              make_float4(pm[m][0], pm[m][1], pm[m][2], pm[m][3]);
      } else {
#pragma unroll
        for (int h = 0; h < 4; ++h)
          if (gc + h < im.W)
#pragma unroll
            for (int m = 0; m < 3; ++m) partials[o + m * stride + h] = pm[m][h];
      }
    }
  }
}

// one block a tile: stage, vertical pass, horizontal pass
template <int V, bool kPartials>
__global__ void __launch_bounds__(Geo<V>::THREADS, Geo<V>::MIN_BLOCKS)
    ssim_forward_kernel(Images im, Konst k, float* __restrict__ partials,
                        float* __restrict__ block_sums) {
  using G = Geo<V>;
  __shared__ __align__(16) float xs[G::SPAN_H][G::PITCH];
  __shared__ __align__(16) float ys[G::SPAN_H][G::PITCH];
  __shared__ __align__(16) float vs[kQuantities][G::TH][G::PITCH];
  __shared__ float red[2][G::THREADS / 32];
  const int c = blockIdx.z;
  const int row0 = im.r0 + blockIdx.y * G::TH;
  const int col0 = blockIdx.x * G::TW;
  stage_tile<V>(xs, ys, im, c, row0, col0);
  __syncthreads();
  vertical_pass<V>(xs, ys, vs, k);
  __syncthreads();
  float m_sum = 0.f, d_sum = 0.f;
  horizontal_pass<V, kPartials>(xs, ys, vs, k, im, gridDim.z, c, row0, col0, partials, m_sum,
                                d_sum);
  store_block_sums<G::THREADS, kFolds<V>>(
      m_sum, d_sum, red, block_sums, (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x,
      gridDim.x * gridDim.y * gridDim.z);
}

// persistent blocks (kK11Persist): as many as the SMs hold at once, each
// taking the next tile (a device counter) until none is left, so no SM
// waits on a last, part-filled round of blocks. Each tile's sums go to its
// own row of block_sums, so their fixed-order sum does not depend on which
// block took which tile. The grid is (blocks, 1, 1); the tiles are (gx, gy,
// C), numbered x fastest.
template <int V, bool kPartials>
__global__ void __launch_bounds__(Geo<V>::THREADS, Geo<V>::MIN_BLOCKS)
    ssim_forward_persist_kernel(Images im, Konst k, int gx, int gy, int C,
                                float* __restrict__ partials, float* __restrict__ block_sums) {
  using G = Geo<V>;
  __shared__ __align__(16) float xs[G::SPAN_H][G::PITCH];
  __shared__ __align__(16) float ys[G::SPAN_H][G::PITCH];
  __shared__ __align__(16) float vs[kQuantities][G::TH][G::PITCH];
  __shared__ float red[2][G::THREADS / 32];
  __shared__ unsigned s_tile;
  const unsigned n_tiles = static_cast<unsigned>(gx) * gy * C;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&g_k11_next, 1u);
    __syncthreads();
    const unsigned t = s_tile;
    if (t >= n_tiles) break;
    const int c = t / (gx * gy), r = t - c * gx * gy;
    const int row0 = im.r0 + (r / gx) * G::TH, col0 = (r % gx) * G::TW;
    stage_tile<V>(xs, ys, im, c, row0, col0);
    __syncthreads();
    vertical_pass<V>(xs, ys, vs, k);
    __syncthreads();
    float m_sum = 0.f, d_sum = 0.f;
    horizontal_pass<V, kPartials>(xs, ys, vs, k, im, C, c, row0, col0, partials, m_sum, d_sum);
    block_sums2<G::THREADS>(m_sum, d_sum, red);
    if (threadIdx.x == 0) {
      block_sums[2 * t] = m_sum;
      block_sums[2 * t + 1] = d_sum;
    }
    __syncthreads();   // s_tile, the staged tile and red are written again next
  }
  fold_sums<G::THREADS>(red, block_sums, gridDim.x, n_tiles, n_tiles);
}

// ---------------------------------------------------------------------------
// the first design and its cost-centre variants
// ---------------------------------------------------------------------------

template <int V, bool kPartials>
__global__ void __launch_bounds__(kThreads, Geo<V>::MIN_BLOCKS) ssim_forward_first_kernel(
    Images im, Konst k, float* __restrict__ partials, float* __restrict__ block_sums) {
  __shared__ float xs[kSpan][kSpan];
  __shared__ float ys[kSpan][kSpan];
  __shared__ __align__(16) float vs[kQuantities][kTile][kSpan];   // 8-byte rows: hregs
  __shared__ float red[2][kRows];
  const int c = blockIdx.z;
  const int row0 = im.r0 + blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const float* xc = im.x + c * im.x_cs;
  const float* yc = im.y + c * im.y_cs;
  for (int i = tid; i < kSpan * kSpan; i += kThreads) {
    const int r = i / kSpan, q = i - r * kSpan;
    const int gr = row0 - kR + r, gc = col0 - kR + q;
    const bool in = gr >= 0 && gr < im.H && gc >= 0 && gc < im.W;
    xs[r][q] = in ? __ldg(xc + gr * im.x_rs + gc) : 0.f;
    ys[r][q] = in ? __ldg(yc + gr * im.y_rs + gc) : 0.f;
  }
  __syncthreads();

  for (int s = tid; s < kSegments; s += kThreads) {
    const int g = s / kSpan, q = s - g * kSpan;
    if constexpr (V == kK11FirstNoVert) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float a = xs[g * kPerThread + j + kR][q], b = ys[g * kPerThread + j + kR][q];
        vs[0][g * kPerThread + j][q] = a;
        vs[1][g * kPerThread + j][q] = b;
        vs[2][g * kPerThread + j][q] = a;
        vs[3][g * kPerThread + j][q] = b;
        vs[4][g * kPerThread + j][q] = a;
      }
    } else {
      float a[kSeg], b[kSeg], p[kSeg];
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        a[i] = xs[g * kPerThread + i][q];
        b[i] = ys[g * kPerThread + i][q];
      }
      vertical(a, &vs[0][g * kPerThread][q], k);
      vertical(b, &vs[1][g * kPerThread][q], k);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) p[i] = __fmul_rn(a[i], a[i]);
      vertical(p, &vs[2][g * kPerThread][q], k);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) p[i] = __fmul_rn(b[i], b[i]);
      vertical(p, &vs[3][g * kPerThread][q], k);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) p[i] = __fmul_rn(a[i], b[i]);
      vertical(p, &vs[4][g * kPerThread][q], k);
    }
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int gc = col0 + tx;
  const long long plane = static_cast<long long>(im.r1 - im.r0) * im.W;
  float m_sum = 0.f, d_sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int lr = threadIdx.y * kPerThread + j;
    const int gr = row0 + lr;
    if (gr >= im.r1 || gc >= im.W) continue;
    float bl[kQuantities];
#pragma unroll
    for (int u = 0; u < kQuantities; ++u) {
      if constexpr (V == kK11FirstNoHoriz) {
        bl[u] = vs[u][lr][tx + kR];
      } else if constexpr (V == kK11FirstHRegs) {
        const float2* src = reinterpret_cast<const float2*>(&vs[u][lr][tx & ~1]);
        float v[12];
#pragma unroll
        for (int w = 0; w < 6; ++w) {
          const float2 f = src[w];
          v[2 * w] = f.x;
          v[2 * w + 1] = f.y;
        }
        bl[u] = blur11(v, 1, k);
      } else {
        bl[u] = blur11(&vs[u][lr][tx], 1, k);
      }
    }
    const Pixel px = ssim_pixel(bl[0], bl[1], bl[2], bl[3], bl[4], k);
    const float xv = xs[lr + kR][tx + kR], yv = ys[lr + kR][tx + kR];
    m_sum = __fadd_rn(m_sum, px.m);
    d_sum = __fadd_rn(d_sum, fabsf(__fsub_rn(xv, yv)));
    if (kPartials) {
      const long long o = static_cast<long long>(c) * plane +
                          static_cast<long long>(gr - im.r0) * im.W + gc;
      const long long stride = plane * gridDim.z;
      partials[o] = px.pm1;
      partials[o + stride] = px.pm2;
      partials[o + 2 * stride] = px.pm3;
    }
  }
  store_block_sums<kThreads, false>(
      m_sum, d_sum, red, block_sums, (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x,
      gridDim.x * gridDim.y * gridDim.z);
}

// The persistent variant's grid: the blocks the device's SMs hold at once of
// `kernel` (asked once a device).
template <int V, bool kPartials, typename Kernel>
int resident_blocks(Kernel kernel) {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Geo<V>::THREADS, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <int V, bool kPartials>
cudaError_t launch_persistent(const Images& im, int C, const Konst& k, float* partials,
                              float* block_sums, cudaStream_t s) {
  using G = Geo<V>;
  const int gx = (im.W + G::TW - 1) / G::TW, gy = (im.r1 - im.r0 + G::TH - 1) / G::TH;
  const int resident = resident_blocks<V, kPartials>(ssim_forward_persist_kernel<V, kPartials>);
  if (resident <= 0) return cudaErrorInvalidValue;
  ssim_forward_persist_kernel<V, kPartials><<<min(gx * gy * C, resident), G::THREADS, 0, s>>>(
      im, k, gx, gy, C, partials, block_sums);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_ssim_forward(const Images& im, int C, const Konst& k, float* partials,
                                float* block_sums, cudaStream_t s) {
  using G = Geo<V>;
  const dim3 grid((im.W + G::TW - 1) / G::TW, (im.r1 - im.r0 + G::TH - 1) / G::TH, C);
  if constexpr (V >= kK11First) {
    const dim3 block(kTile, kRows);
    if (partials)
      ssim_forward_first_kernel<V, true><<<grid, block, 0, s>>>(im, k, partials, block_sums);
    else
      ssim_forward_first_kernel<V, false><<<grid, block, 0, s>>>(im, k, nullptr, block_sums);
  } else if constexpr (V == kK11Persist) {
    return partials ? launch_persistent<V, true>(im, C, k, partials, block_sums, s)
                    : launch_persistent<V, false>(im, C, k, nullptr, block_sums, s);
  } else {
    if (partials)
      ssim_forward_kernel<V, true><<<grid, G::THREADS, 0, s>>>(im, k, partials, block_sums);
    else
      ssim_forward_kernel<V, false><<<grid, G::THREADS, 0, s>>>(im, k, nullptr, block_sums);
  }
  return cudaGetLastError();
}

}  // namespace glic_ssim
