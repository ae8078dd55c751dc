// K10: the gather of the sorted splat rows, hand-written for Hopper (sm_90a).
//
// Replaces jnp.take(rows, sorted_gauss, axis=0, mode="fill") of the JAX
// package's gaussian_lic_tpu/ops/rasterize.py:116 and :260, which XLA fuses
// on the TPU into the blend's inputs: the (M_pad, 16) float32 rows the blend
// kernels K1 and K2 stream, row sorted_gauss[i] of the (P + 1, 16) table
// (the dead id P reads its zero row). In PyTorch it was `table[ids.long()]`,
// a widening copy of the ids and an index kernel.
//
// What bounds it on this card: device memory. It reads the 4-byte ids, each
// table row that the list names once, and writes 64 B an entry (~188 MB at
// 1,782,784 entries of 2^20 Gaussians, ~0.06 ms at 3.35 TB/s). Four threads
// a row, each moving one 16-byte vector: a warp's loads are 8 whole rows and
// its stores 512 contiguous bytes. An id outside the table (none on the
// main path) reads as NaN, jnp.take's fill value.
//
// Plain C interface, loaded with ctypes by gaussian_lic_tpu_torch/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_splats_kernel(
    const float4* __restrict__ table, long long n_rows, const int* __restrict__ ids,
    long long m, float4* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m * 4) return;
  const int id = __ldg(ids + (i >> 2));
  float4 v;
  if (id >= 0 && id < n_rows) {
    v = __ldg(table + static_cast<long long>(id) * 4 + (i & 3));
  } else {
    const float nan = __int_as_float(0x7fc00000);
    v = make_float4(nan, nan, nan, nan);
  }
  out[i] = v;
}

}  // namespace

// K10: out (m, 16) = table (n_rows, 16)[ids (m,)], both 16-byte aligned.
extern "C" int glic_gather_splats(const float* table, long long n_rows, const int* ids,
                                  long long m, float* out, void* stream) {
  if (m == 0) return 0;
  const long long blocks = (m * 4 + kThreads - 1) / kThreads;
  gather_splats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), n_rows, ids, m, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
