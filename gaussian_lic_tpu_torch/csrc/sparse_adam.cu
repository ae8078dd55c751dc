// K7: the visibility-masked sparse Adam of all six parameter groups in one
// launch, hand-written for Hopper (sm_90a).
//
// Replaces the program XLA fuses on the TPU from the JAX package's
// gaussian_lic_tpu/ops/adam.py:40 sparse_adam_update, called once per group
// by the train step (engine/trainer.py:114, parallel/sharded.py:572); the
// reference's adamUpdateCUDA (adam.cu:9-38). In PyTorch each group was ~14
// separate kernels.
//
// What bounds it on this card: device memory. Per element it reads p, g, m,
// v and its row's mask and writes p', m', v' (28 B; 59 floats a Gaussian,
// ~0.52 ms at 2^20 Gaussians at 3.35 TB/s). One thread per element of the
// groups laid end to end: a table of group descriptors (pointers, width,
// -lr, offset in the flat index), passed by value, gives each element its
// group and its row (element / width). It writes fresh p', m' and v' and
// none of its inputs (a CUDA graph's step reads its inputs again). Each
// operation is the plain version's (ops/adam.py:sparse_adam_update), in its
// order, rounded once by the *_rn intrinsics, so the outputs are its floats
// bit for bit.
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
  float* p_out;
  float* m_out;
  float* v_out;
  long long offset;  // first element of the group in the flat index
  int width;         // floats a row
  float neg_lr;
};

struct AdamGroups {
  AdamGroup g[kMaxGroups];
  int n;
};

}  // namespace glic_adam

namespace {

using namespace glic_adam;

__global__ void sparse_adam_kernel(AdamGroups gs, const bool* __restrict__ visible,
                                   long long total, float b1, float omb1, float b2, float omb2,
                                   float eps) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int k = 0;
  while (k + 1 < gs.n && e >= gs.g[k + 1].offset) ++k;
  const AdamGroup& G = gs.g[k];
  const long long i = e - G.offset;
  const float p = G.p[i], g = G.g[i], m0 = G.m[i], v0 = G.v[i];
  // m = b1 m0 + (1 - b1) g; v = b2 v0 + (1 - b2) g g; step = -lr m / (sqrt(v) + eps)
  const float m = __fadd_rn(__fmul_rn(b1, m0), __fmul_rn(omb1, g));
  const float v = __fadd_rn(__fmul_rn(b2, v0), __fmul_rn(__fmul_rn(omb2, g), g));
  const float step = __fdiv_rn(__fmul_rn(G.neg_lr, m), __fadd_rn(__fsqrt_rn(v), eps));
  const bool vis = visible[i / G.width];
  G.p_out[i] = vis ? __fadd_rn(p, step) : p;
  G.m_out[i] = vis ? m : m0;
  G.v_out[i] = vis ? v : v0;
}

}  // namespace

// K7 over `n_groups` <= 6 descriptors (host memory, read here); `total` is
// the groups' element count, their offsets increasing from 0.
extern "C" int glic_sparse_adam(const glic_adam::AdamGroup* groups, int n_groups,
                                long long total, const bool* visible, float b1, float omb1,
                                float b2, float omb2, float eps, void* stream) {
  using namespace glic_adam;
  if (n_groups < 1 || n_groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  AdamGroups gs{};
  for (int k = 0; k < n_groups; ++k) gs.g[k] = groups[k];
  gs.n = n_groups;
  constexpr int kThreads = 256;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sparse_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(gs, visible, total, b1, omb1, b2,
                                                            omb2, eps);
  return static_cast<int>(cudaGetLastError());
}
