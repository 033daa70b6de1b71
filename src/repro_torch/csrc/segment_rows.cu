// Segment-sum of participant rows into the population layout for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/scatter_agg.py::segment_rows, the Pallas TPU
// kernel launched at scatter_agg.py:116.
//
//   out[i, c] = sum_{j : seg[j] == i} rows[j, c]      i < n, c < D
//
// summed over j = 0..m-1 in order from 0. Duplicate ids add; ids outside
// [0, n) drop. Rows with no id write zeros.
//
// What bounds it: bytes. With unique ids each input row is read once (only
// the output row it lands in looks at it) and each output float is written
// once; there is one add per input element.
// Design: output-stationary. blockIdx.y is the output row i, blockIdx.x a
// tile of kCols columns. The CTA first keeps the ids in shared memory, then
// every thread walks the m ids in order and adds the columns of the rows
// whose id is i into registers, and writes its columns of out once. No
// atomics, a fixed order (deterministic, bit-equal to adding the rows one
// by one), and no memset pass: rows that no id reaches are written as 0.
// Consecutive threads touch consecutive columns, so loads and stores are
// coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kCols = kThreads * kPerThread;
constexpr int kMaxIds = 4096;

__global__ void segment_rows_kernel(const float* __restrict__ rows,
                                    long long r_stride,
                                    const int32_t* __restrict__ seg, int m,
                                    long long D, float* __restrict__ out) {
  __shared__ int32_t ids[kMaxIds];
  for (int j = threadIdx.x; j < m; j += blockDim.x) ids[j] = seg[j];
  __syncthreads();
  const int i = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * kCols + threadIdx.x;
  float acc[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) acc[u] = 0.f;
  for (int j = 0; j < m; ++j) {
    if (ids[j] != i) continue;
    const float* r = rows + j * r_stride;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long c = c0 + (long long)u * kThreads;
      if (c < D) acc[u] = __fadd_rn(acc[u], r[c]);
    }
  }
  float* o = out + (long long)i * D;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long c = c0 + (long long)u * kThreads;
    if (c < D) o[c] = acc[u];
  }
}

}  // namespace

// rows: [m, D] float32 with contiguous rows and leading stride r_stride
// (elements); seg: [m] int32; out: contiguous [n, D] float32.
extern "C" int segment_rows_launch(const void* rows, long long r_stride,
                                   const void* seg, int m, long long D, int n,
                                   void* out, void* stream) {
  if (n == 0 || D == 0) return 0;
  if (m > kMaxIds || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kCols - 1) / kCols), (unsigned)n);
  segment_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, r_stride, (const int32_t*)seg, m, D, (float*)out);
  return (int)cudaGetLastError();
}
