// Block-wise magnitude top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_block.py::block_topk, the Pallas TPU
// kernel launched at topk_block.py:49 (k rounds of masked argmax).
//
// Per row of `block` floats: the k entries of largest |x|, in descending
// |x| order, ties to the lowest index (the order the masked argmax emits;
// -0.0 ties +0.0), as (values from x, int32 within-row indices).
//
// What bounds it: bytes at the roofline (each element read once, 8 bytes
// written per selected slot), but this first version is bound by shared-
// memory traffic: it sorts the whole row.
// Design: one CTA per row. Each element becomes one 64-bit key
//   ((0x7FFFFFFF - |x| bits) << 32) | index
// so an ascending sort orders by descending magnitude and then by ascending
// index, which is exactly the masked-argmax order; the row is padded to a
// power of two P with keys that sort last, sorted by a bitonic network in
// shared memory (P * 8 bytes <= 16 KB), and the first k keys are written
// out. The network handles any block size (960, 640, 320, 126, 42 ...) with
// the same code, and needs no data-dependent control flow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int P>
__global__ void block_topk_kernel(const float* __restrict__ x,
                                  long long x_stride, int nb, int block, int k,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx) {
  __shared__ unsigned long long keys[P];
  const long long row = blockIdx.x;
  const long long j = row / nb, b = row % nb;
  const float* xr = x + j * x_stride + b * block;

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    unsigned long long key = ~0ull;
    if (i < block) {
      const uint32_t a = __float_as_uint(xr[i]) & 0x7FFFFFFFu;
      key = ((unsigned long long)(0x7FFFFFFFu - a) << 32) | (uint32_t)i;
    }
    keys[i] = key;
  }
  __syncthreads();

  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = keys[lo], c = keys[hi];
        if ((a > c) == ascending) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const uint32_t i = (uint32_t)(keys[t] & 0xFFFFFFFFull);
    vals[row * k + t] = xr[i];
    idx[row * k + t] = (int)i;
  }
}

template <int P>
void launch(const float* x, long long x_stride, long long rows, int nb,
            int block, int k, float* vals, int* idx, cudaStream_t s) {
  const int threads = P / 2 < 512 ? P / 2 : 512;
  block_topk_kernel<P><<<(unsigned)rows, threads, 0, s>>>(
      x, x_stride, nb, block, k, vals, idx);
}

}  // namespace

// x: [n, nb, block] float32 with contiguous [nb, block] rows and leading
// stride x_stride. vals: contiguous [n*nb, k] float32, idx: [n*nb, k] int32.
// Blocks up to 2048 elements; k <= block.
extern "C" int block_topk_launch(const void* x, long long x_stride,
                                 long long rows, int nb, int block, int k,
                                 void* vals, void* idx, void* stream) {
  if (rows == 0) return 0;
  const float* xp = (const float*)x;
  float* vp = (float*)vals;
  int* ip = (int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (block <= 64) launch<64>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  else if (block <= 128) launch<128>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  else if (block <= 256) launch<256>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  else if (block <= 512) launch<512>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  else if (block <= 1024) launch<1024>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  else if (block <= 2048) launch<2048>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
