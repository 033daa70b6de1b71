// Bucketed select-payload aggregation for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/scatter_agg.py::scatter_agg, the Pallas TPU
// kernel launched at scatter_agg.py:74.
//
//   out[b, o] = sum_j sum_t  weight_j * vals[j, b, t] * 1[idx[j, b, t] == o]
//
// Duplicate offsets add; offsets >= block drop (the TPU one-hot drops them
// too).
//
// What bounds it: bytes. Each slot is read once (4-byte value + 2-byte
// uint16 offset) and each output float is written once; there is one
// multiply-add per slot.
// Design: one CTA per destination block, with a `block`-float accumulator in
// shared memory, so the dense output is written to device memory exactly
// once and the scatter never touches global atomics. Clients are visited in
// order with a barrier between them, the order the TPU kernel revisits its
// output tile; within one client the slots add by shared-memory atomics, so
// only duplicate offsets inside one client's row can reorder (top-k payloads
// have none). The uint16 offsets are read as they are on the wire.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void scatter_agg_kernel(const float* __restrict__ vals,
                                   long long v_stride,
                                   const uint16_t* __restrict__ idx,
                                   long long i_stride,
                                   const float* __restrict__ weight, int n,
                                   int k, int block, float* __restrict__ out) {
  extern __shared__ float acc[];
  const long long b = blockIdx.x;
  for (int o = threadIdx.x; o < block; o += blockDim.x) acc[o] = 0.f;
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float w = weight[j];
    const float* v = vals + j * v_stride + b * k;
    const uint16_t* id = idx + j * i_stride + b * k;
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      const int o = id[t];
      if (o < block) atomicAdd(&acc[o], __fmul_rn(v[t], w));
    }
    __syncthreads();
  }
  float* dst = out + b * block;
  for (int o = threadIdx.x; o < block; o += blockDim.x) dst[o] = acc[o];
}

}  // namespace

// vals: [n, nb, k] float32 and idx: [n, nb, k] uint16, each with contiguous
// [nb, k] rows and leading strides v_stride / i_stride; weight: [n] float32.
// out: contiguous [nb, block] float32.
extern "C" int scatter_agg_launch(const void* vals, long long v_stride,
                                  const void* idx, long long i_stride,
                                  const void* weight, int n, int nb, int k,
                                  int block, void* out, void* stream) {
  if (nb == 0) return 0;
  const size_t smem = (size_t)block * sizeof(float);
  scatter_agg_kernel<<<(unsigned)nb, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)vals, v_stride, (const uint16_t*)idx, i_stride,
      (const float*)weight, n, k, block, (float*)out);
  return (int)cudaGetLastError();
}
