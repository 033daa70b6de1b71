// Fused EF14 quantize-and-pack for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize_ef_pack.py::quantize_ef_pack, the
// Pallas TPU kernel launched at quantize_ef_pack.py:70.
//
// Per row of `block` floats (one wire block of one client):
//   buf   = e + delta
//   scale = max |buf|
//   code  = rint(buf / safe * L)          L = 2^(bits-1) - 1, half to even
//   words = pack(code + L)                32/bits biased lanes per uint32,
//                                         lane i at bits [bits*i, bits*(i+1)),
//                                         pad lanes of the last word are 0 bits
//   e_new = buf - code / L * safe         (0 where scale == 0)
//
// What bounds it: bytes. Each element is read twice (e, delta) and written
// once (e_new) plus bits/8 bytes of words, against a handful of flops.
// Design: one CTA per row. buf lives in shared memory (<= 4 KB at block
// 1024), so e and delta are read from device memory once and the three
// passes (max, residual, words) reuse it. The max-abs is a warp-shuffle
// reduction. Each thread assembles whole words, so lanes never race. Every
// rounding step is pinned with __fadd_rn / __fdiv_rn / __fmul_rn /
// __fsub_rn (and the library is built with -fmad=false), so e_new equals the
// plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__global__ void quantize_ef_pack_kernel(
    const float* __restrict__ e, long long e_stride,
    const float* __restrict__ d, long long d_stride,
    int nb, int block, int bits, int W,
    uint32_t* __restrict__ words, float* __restrict__ scale,
    float* __restrict__ e_new) {
  extern __shared__ float buf[];
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const long long j = row / nb, b = row % nb;
  const float* er = e + j * e_stride + b * block;
  const float* dr = d + j * d_stride + b * block;

  float m = 0.f;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const float v = __fadd_rn(er[i], dr[i]);
    buf[i] = v;
    m = fmaxf(m, fabsf(v));
  }
  const float s = block_max(m, red);  // its barriers publish buf as well

  const float L = (float)((1 << (bits - 1)) - 1);
  const float safe = s > 0.f ? s : 1.f;
  float* en = e_new + row * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const float c = rintf(__fmul_rn(__fdiv_rn(buf[i], safe), L));
    const float v = s > 0.f ? __fmul_rn(__fdiv_rn(c, L), safe) : 0.f;
    en[i] = __fsub_rn(buf[i], v);
  }

  const int per_word = 32 / bits;
  const int levels = (1 << (bits - 1)) - 1;
  uint32_t* wr = words + row * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    uint32_t acc = 0u;
    for (int l = 0; l < per_word; ++l) {
      const int i = w * per_word + l;
      if (i < block) {
        const int code =
            s > 0.f ? (int)rintf(__fmul_rn(__fdiv_rn(buf[i], safe), L)) : 0;
        acc |= (uint32_t)(code + levels) << (bits * l);
      }
    }
    wr[w] = acc;
  }
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace

// e, d: [n, nb, block] float32 with contiguous [nb, block] rows and leading
// strides e_stride / d_stride (elements). Outputs are contiguous:
// words [n*nb, W] uint32, scale [n*nb] float32, e_new [n*nb, block] float32.
extern "C" int quantize_ef_pack_launch(
    const void* e, long long e_stride, const void* d, long long d_stride,
    long long rows, int nb, int block, int bits, int W,
    void* words, void* scale, void* e_new, void* stream) {
  if (rows == 0) return 0;
  const size_t smem = (size_t)block * sizeof(float);
  quantize_ef_pack_kernel<<<(unsigned)rows, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)e, e_stride, (const float*)d, d_stride, nb, block, bits,
      W, (uint32_t*)words, (float*)scale, (float*)e_new);
  return (int)cudaGetLastError();
}
