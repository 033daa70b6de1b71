// Fused unpack-multiply-add aggregation of bit-packed quant payloads for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/unpack_mma.py::unpack_mma, the Pallas TPU
// kernel launched at unpack_mma.py:59.
//
//   acc[b, o] = sum_j  (weight_j * scale_{j,b} / L) * (lane_o(words_{j,b}) - L)
//
// summed over the clients j = 0..n-1 in order, exactly as the TPU kernel
// revisits its output tile (acc starts at 0).
//
// What bounds it: bytes. The packed words (bits/8 bytes per element and
// client) are read once and the float result (4 bytes per element) is
// written once; the arithmetic is two flops per lane and client.
// Design: one thread per (destination block, word). Consecutive threads read
// consecutive words of a client, so every load is coalesced; the thread keeps
// its 32/bits lane accumulators in registers across the client loop (bits is
// a template parameter, so the lanes unroll), and writes the trimmed floats
// once. The client order is fixed, so the sum is deterministic and matches
// the plain PyTorch version bit for bit (-fmad=false, __fmul_rn/__fadd_rn).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BITS>
__global__ void unpack_mma_kernel(const uint32_t* __restrict__ words,
                                  long long w_stride,
                                  const float* __restrict__ scale,
                                  long long s_stride,
                                  const float* __restrict__ weight, int n,
                                  int nb, int W, int block,
                                  float* __restrict__ out) {
  constexpr int kPerWord = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nb * W) return;
  const long long b = t / W;
  const int wi = (int)(t % W);
  const float L = (float)((1 << (BITS - 1)) - 1);

  float acc[kPerWord];
#pragma unroll
  for (int l = 0; l < kPerWord; ++l) acc[l] = 0.f;
  for (int j = 0; j < n; ++j) {
    const uint32_t wd = words[j * w_stride + t];
    const float c = __fdiv_rn(__fmul_rn(weight[j], scale[j * s_stride + b]), L);
#pragma unroll
    for (int l = 0; l < kPerWord; ++l) {
      const float v = __fsub_rn((float)((wd >> (BITS * l)) & kMask), L);
      acc[l] = __fadd_rn(acc[l], __fmul_rn(c, v));
    }
  }
  float* o = out + b * block + (long long)wi * kPerWord;
  const int valid = block - wi * kPerWord;  // pad lanes of the last word drop
#pragma unroll
  for (int l = 0; l < kPerWord; ++l)
    if (l < valid) o[l] = acc[l];
}

}  // namespace

// words: [n, nb, W] uint32 with contiguous [nb, W] rows and leading stride
// w_stride; scale: [n, nb] float32 with leading stride s_stride; weight: [n]
// float32. out: contiguous [nb, block] float32.
extern "C" int unpack_mma_launch(const void* words, long long w_stride,
                                 const void* scale, long long s_stride,
                                 const void* weight, int n, int nb, int W,
                                 int block, int bits, void* out,
                                 void* stream) {
  const long long total = (long long)nb * W;
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* w = (const uint32_t*)words;
  const float* sc = (const float*)scale;
  const float* wt = (const float*)weight;
  float* o = (float*)out;
  switch (bits) {
    case 2:
      unpack_mma_kernel<2><<<grid, kThreads, 0, s>>>(w, w_stride, sc, s_stride,
                                                     wt, n, nb, W, block, o);
      break;
    case 4:
      unpack_mma_kernel<4><<<grid, kThreads, 0, s>>>(w, w_stride, sc, s_stride,
                                                     wt, n, nb, W, block, o);
      break;
    case 8:
      unpack_mma_kernel<8><<<grid, kThreads, 0, s>>>(w, w_stride, sc, s_stride,
                                                     wt, n, nb, W, block, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
