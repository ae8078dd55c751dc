// K6: the per-Gaussian preprocess backward, hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the autodiff of the JAX
// package's gaussian_lic_tpu/models/gaussians.py:84-94 activations (exp,
// the quaternion's normalisation, sigmoid), ops/projection.py:77
// project_gaussians, ops/sh.py:47 eval_sh_color and ops/rasterize.py:78
// _pack_rows (the reference's BACKWARD::preprocess and its preprocessCUDA,
// backward.cu:312-377, 599-657). In PyTorch that was autograd's backward
// of ~100 (P,) kernels, with a zero-filled (P, 15, 3) tensor for each of
// the 15 SH coefficient selects, and ~10 more for the activations.
//
// What bounds it on this card: device memory. Per Gaussian it reads the
// nine row gradients of K2's output as K2 left them (a (P, 9) view of its
// 12-float table: no pad or copy between K2 and K6) and the 232 B of inputs,
// and writes the six gradients (236 B): 504 B a Gaussian at S = 15, of
// which sh_rest and its gradient are 360, so 0.158 ms at 2^20 Gaussians at
// 3.35 TB/s; from the stored parameters it also reads the opacity logit
// (508 B, 0.159 ms), one word a thread, read and written in place. It recomputes the forward terms with K5's arithmetic
// (preprocess_common.cuh) instead of reading saved ones, which would move
// more bytes than it computes. The closed form is ops/preprocess.py's
// preprocess_backward_plain line for line, with autograd's masks on the
// plain chain: tx/ty's clamp passes inside its closed bounds, the selects on
// tz and det != 0 pass where they took the computed value, the colour's
// clamp at 0 where the colour is >= 0, coefficients above the active degree
// get zero.
//
// The first design (one thread a Gaussian, its rows read and written in
// place in device memory) took 0.914 ms on an H100, 5.8x that bound: a
// thread's 45 SH floats sit 180 B from its neighbour's, so each warp load or
// store of one coefficient touched 32 sectors for 128 useful bytes (8x the
// transactions, SH read twice), the small rows did the same at 12-48 B
// strides, and 95 registers held the B[15] / dB[15][3] arrays beside every
// forward term. This design (preprocess_backward.cuh):
//  (a) stages a block's 128 rows of every input in shared memory with
//      cp.async, neighbouring threads on neighbouring words, 16 B a thread
//      where the slab is 16-byte aligned and a word where a row shard
//      starts it elsewhere; each thread computes from its rows there and
//      writes its gradients over them, and the block stores the slabs back
//      the same way: every device-memory access is coalesced, and SH is read
//      from device memory once. A row of 45 words is odd, so the threads'
//      reads and writes of their rows hit 32 banks. The camera is staged
//      once a block. 34,304 B of shared memory at S = 15 (under the 48 KB a
//      launch gets without an opt-in), so 6 blocks (768 threads) an SM;
//  (b) computes each B_k and dB_k where it is consumed (sh_term) and runs
//      the SH section before the projection's, so their live sets do not
//      overlap;
//  (c) keeps the recomputed forward exactly K5's (every mask agrees with the
//      forward pass) and makes the backward's own divisions one correctly
//      rounded reciprocal each (__frcp_rn), multiplied.
// Its timing variants (the probe entry, preprocess_probe_backward.cu) split
// the time between the SH bytes and the projection's arithmetic.
//
// The kernel is preprocess_backward.cuh, templated on the variant; this
// entry launches its base instantiation. Plain C interface, loaded with
// ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include "preprocess_backward.cuh"

// K6. `d_attrs` is (P, 9) with row stride `d_stride` floats; S is the
// sh_rest coefficient count (>= the active degree's). Every array may start
// at any 4-byte aligned address (a row shard of a larger one). With `raw`
// != 0, scale and quat are log_scale and quat as stored, `opa_logit` (P,)
// is read, and d_scale, d_quat and d_opacity are the gradients of the
// stored parameters; otherwise opa_logit is unread (it may be null).
extern "C" int glic_preprocess_backward(
    const float* xyz, const float* scale, const float* quat, const float* opa_logit,
    const float* dc, const float* sh_rest, const float* R_cw, const float* t_cw,
    const float* full_proj, const float* cam_center, const float* d_attrs, long long d_stride,
    long long P, int S, int deg, int raw, float W, float H, float fx, float fy,
    float limx_neg, float limx_pos, float limy_neg, float limy_pos, float* d_xyz,
    float* d_scale, float* d_quat, float* d_opacity, float* d_dc, float* d_sh, void* stream) {
  using namespace glic_pre;
  auto launch = raw ? launch_preprocess_backward<kK6Base, true>
                    : launch_preprocess_backward<kK6Base, false>;
  return static_cast<int>(launch(
      xyz, scale, quat, opa_logit, dc, sh_rest, R_cw, t_cw, full_proj, cam_center, d_attrs,
      d_stride, P, S, deg, W, H, fx, fy, limx_neg, limx_pos, limy_neg, limy_pos, d_xyz,
      d_scale, d_quat, d_opacity, d_dc, d_sh, static_cast<cudaStream_t>(stream)));
}
