// Fused EF14 quantization step (dense output, no packing) for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/quantize_ef.py::quantize_ef, the Pallas TPU
// kernel launched at quantize_ef.py:39.
//
// Per row of `block` floats:
//   buf   = e + delta
//   scale = max |buf|
//   v     = rint(buf / safe * L) / L * safe     L = 2^(bits-1) - 1, half to
//                                               even; v = 0 where scale == 0
//   e_new = buf - v
//
// What bounds it: bytes. e and delta are read once and v and e_new written
// once (16 bytes per element) against a handful of flops.
// Design: one CTA per row, as quantize_ef_pack.cu without the word packing.
// buf lives in shared memory (4 KB at block 1024), so e and delta are read
// from device memory once and both passes (max, then v and e_new) reuse it;
// the max-abs is a warp-shuffle reduction. Every rounding step is pinned
// (__fadd_rn, __fdiv_rn, __fmul_rn, __fsub_rn, rintf; the library is built
// with -fmad=false), so v and e_new equal the plain PyTorch version bit for
// bit.
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

__global__ void quantize_ef_kernel(const float* __restrict__ e,
                                   const float* __restrict__ d, int block,
                                   int bits, float* __restrict__ v,
                                   float* __restrict__ e_new) {
  extern __shared__ float buf[];
  __shared__ float red[33];
  const long long off = (long long)blockIdx.x * block;
  const float* er = e + off;
  const float* dr = d + off;

  float m = 0.f;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const float x = __fadd_rn(er[i], dr[i]);
    buf[i] = x;
    m = fmaxf(m, fabsf(x));
  }
  const float s = block_max(m, red);  // its barriers publish buf as well

  const float L = (float)((1 << (bits - 1)) - 1);
  const float safe = s > 0.f ? s : 1.f;
  float* vr = v + off;
  float* en = e_new + off;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const float c = rintf(__fmul_rn(__fdiv_rn(buf[i], safe), L));
    const float q = s > 0.f ? __fmul_rn(__fdiv_rn(c, L), safe) : 0.f;
    vr[i] = q;
    en[i] = __fsub_rn(buf[i], q);
  }
}

}  // namespace

// e, d, v, e_new: contiguous [rows, block] float32.
extern "C" int quantize_ef_launch(const void* e, const void* d,
                                  long long rows, int block, int bits,
                                  void* v, void* e_new, void* stream) {
  if (rows == 0) return 0;
  const size_t smem = (size_t)block * sizeof(float);
  quantize_ef_kernel<<<(unsigned)rows, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const float*)e, (const float*)d, block, bits, (float*)v,
      (float*)e_new);
  return (int)cudaGetLastError();
}
