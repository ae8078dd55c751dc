// K11: the training loss's forward, SSIM and L1 over a window of rows,
// hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/ops/losses.py:45-97 (`_blur`, `ssim_map`, `ssim`, and the
// L1 of `training_loss`) and :103-130 (`training_loss_band_part`). In
// PyTorch that was ~60 image-sized launches a step: five separable blurs of
// 2 x 11 shifted multiply-adds, the map's arithmetic and two reductions.
//
// For the rows [r0, r1) of a (C, H, W) float32 image `x` and its target `y`
// (each with its own channel and row stride, unit column stride) it writes,
// per block, the sums of the SSIM map and of |x - y| over its pixels, and,
// with `partials`, the three partial maps of SURVEY C14 that K12 blurs back:
// dm/dmu1 (with blur(x^2) and blur(xy) held, so it carries the -2 mu1 dm/ds1
// and -mu2 dm/ds12 terms), dm/dsigma1^2 and dm/dsigma12, each (C, r1 - r0, W)
// at partials[q]. The map and the partial maps are bit for bit the plain
// chain's on the card (ops/losses.py `ssim_forward_plain`: one rounded
// operation each, in its order; csrc/ssim_common.cuh). The blocks' sums are
// reduced by the wrapper in a fixed order (no float atomics: the loss is the
// same from run to run and between eager steps and graph replays).
//
// What bounds it on this card: operations. Per window pixel it does ~270
// separate FP32 multiplies and adds (5 quantities x 11 taps x 2 passes x 2,
// the map, the partial maps, four IEEE divisions) and moves 20 bytes (two
// reads, three partial-map writes): at 3 x 512 x 640, ~7.9 us of FP32 lanes
// against ~5.9 us of device memory. The design stages each input once in
// shared memory (the apron costs (42 / 32)^2 of the reads, from L2), keeps a
// vertical segment's 14 inputs in registers (3.5 shared loads an output per
// quantity instead of 11) and reads the horizontal taps conflict-free.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstring>

#include "ssim_common.cuh"

namespace glic_ssim {

constexpr int kQuantities = 5;   // x, y, x^2, y^2, xy

template <bool kPartials>
__global__ void __launch_bounds__(kThreads, 4) ssim_forward_kernel(
    const float* __restrict__ x, long long x_cs, long long x_rs, const float* __restrict__ y,
    long long y_cs, long long y_rs, int H, int W, int r0, int r1, Konst k,
    float* __restrict__ partials, float* __restrict__ block_sums) {
  __shared__ float xs[kSpan][kSpan];
  __shared__ float ys[kSpan][kSpan];
  __shared__ float vs[kQuantities][kTile][kSpan];
  __shared__ float red[2][kRows];
  const int c = blockIdx.z;
  const int row0 = r0 + blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const float* xc = x + c * x_cs;
  const float* yc = y + c * y_cs;
  for (int i = tid; i < kSpan * kSpan; i += kThreads) {
    const int r = i / kSpan, q = i - r * kSpan;
    const int gr = row0 - kR + r, gc = col0 - kR + q;
    const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
    xs[r][q] = in ? __ldg(xc + gr * x_rs + gc) : 0.f;
    ys[r][q] = in ? __ldg(yc + gr * y_rs + gc) : 0.f;
  }
  __syncthreads();

  // vertical pass of x, y, x*x, y*y and x*y (each product rounded first, as
  // the plain chain's `img1 * img1` is a tensor of its own)
  for (int s = tid; s < kSegments; s += kThreads) {
    const int g = s / kSpan, q = s - g * kSpan;
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
  __syncthreads();

  // horizontal pass, the map, the partial maps and the L1 term
  const int tx = threadIdx.x;
  const int gc = col0 + tx;
  const long long plane = static_cast<long long>(r1 - r0) * W;
  float m_sum = 0.f, d_sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int lr = threadIdx.y * kPerThread + j;
    const int gr = row0 + lr;
    if (gr >= r1 || gc >= W) continue;
    const float mu1 = blur11(&vs[0][lr][tx], 1, k);
    const float mu2 = blur11(&vs[1][lr][tx], 1, k);
    const float exx = blur11(&vs[2][lr][tx], 1, k);
    const float eyy = blur11(&vs[3][lr][tx], 1, k);
    const float exy = blur11(&vs[4][lr][tx], 1, k);
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
    const float m = __fdiv_rn(num, den);
    const float xv = xs[lr + kR][tx + kR], yv = ys[lr + kR][tx + kR];
    m_sum = __fadd_rn(m_sum, m);
    d_sum = __fadd_rn(d_sum, fabsf(__fsub_rn(xv, yv)));
    if (kPartials) {
      // dm/dmu1 = 2 (mu2 (B - A) + mu1 m (C - D)) / (C D)
      const float t = __fadd_rn(__fmul_rn(mu2, __fsub_rn(B, A)),
                                __fmul_rn(__fmul_rn(mu1, m), __fsub_rn(Cm, D)));
      const long long o = static_cast<long long>(c) * plane +
                          static_cast<long long>(gr - r0) * W + gc;
      const long long stride = plane * gridDim.z;
      partials[o] = __fdiv_rn(__fmul_rn(2.f, t), den);
      partials[o + stride] = -__fdiv_rn(m, D);
      partials[o + 2 * stride] = __fdiv_rn(__fmul_rn(2.f, A), den);
    }
  }

  // the block's two sums, in a fixed order: a shuffle tree in each warp,
  // then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m_sum = __fadd_rn(m_sum, __shfl_xor_sync(0xffffffffu, m_sum, off));
    d_sum = __fadd_rn(d_sum, __shfl_xor_sync(0xffffffffu, d_sum, off));
  }
  if (tx == 0) {
    red[0][threadIdx.y] = m_sum;
    red[1][threadIdx.y] = d_sum;
  }
  __syncthreads();
  if (tid == 0) {
    float ms = red[0][0], ds = red[1][0];
#pragma unroll
    for (int w = 1; w < kRows; ++w) {
      ms = __fadd_rn(ms, red[0][w]);
      ds = __fadd_rn(ds, red[1][w]);
    }
    const long long b = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
                            gridDim.x + blockIdx.x;
    block_sums[2 * b] = ms;
    block_sums[2 * b + 1] = ds;
  }
}

}  // namespace glic_ssim

// K11 over rows [r0, r1) of x and y (C, H, W): block_sums (n_blocks, 2) of
// (sum of the map, sum of |x - y|), n_blocks = C * ceil((r1 - r0) / 32) *
// ceil(W / 32); with `partials` (3, C, r1 - r0, W) not null, the partial
// maps. konst: 13 host floats, the 11 taps, C1 and C2.
extern "C" int glic_ssim_forward(const float* x, long long x_cs, long long x_rs, const float* y,
                                 long long y_cs, long long y_rs, int C, int H, int W, int r0,
                                 int r1, const float* konst, float* partials, float* block_sums,
                                 void* stream) {
  using namespace glic_ssim;
  if (C < 1 || C > 65535 || H < 1 || W < 1 || r0 < 0 || r1 <= r0 || r1 > H || !konst)
    return static_cast<int>(cudaErrorInvalidValue);
  Konst k;
  std::memcpy(&k, konst, sizeof(Konst));
  const dim3 grid((W + kTile - 1) / kTile, (r1 - r0 + kTile - 1) / kTile, C);
  const dim3 block(kTile, kRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partials)
    ssim_forward_kernel<true><<<grid, block, 0, s>>>(x, x_cs, x_rs, y, y_cs, y_rs, H, W, r0, r1,
                                                     k, partials, block_sums);
  else
    ssim_forward_kernel<false><<<grid, block, 0, s>>>(x, x_cs, x_rs, y, y_cs, y_rs, H, W, r0,
                                                      r1, k, nullptr, block_sums);
  return static_cast<int>(cudaGetLastError());
}
