// Soft-switch gradient blend for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/switch_blend.py::switch_blend, the Pallas TPU
// kernel launched at switch_blend.py:34.
//
//   out = (1 - sigma) * g_f + sigma * g_g
//
// What bounds it: bytes. g_f and g_g are read once and out written once
// (12 bytes per element) against three flops.
// Design: a grid-stride elementwise pass, four floats per thread and step
// (16-byte loads and stores when the three buffers are 16-byte aligned, a
// scalar loop otherwise). sigma is read from device memory by each thread,
// so the host never waits for it. Each step is rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn, built with -fmad=false), so the result equals the
// plain PyTorch version's three separate operations bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float blend(float a, float b, float s, float r) {
  return __fadd_rn(__fmul_rn(r, a), __fmul_rn(s, b));
}

__global__ void switch_blend_vec4(const float4* __restrict__ gf,
                                  const float4* __restrict__ gg,
                                  const float* __restrict__ sigma,
                                  long long n4, float4* __restrict__ out) {
  const float s = *sigma;
  const float r = __fsub_rn(1.f, s);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a = gf[i], b = gg[i];
    out[i] = make_float4(blend(a.x, b.x, s, r), blend(a.y, b.y, s, r),
                         blend(a.z, b.z, s, r), blend(a.w, b.w, s, r));
  }
}

__global__ void switch_blend_scalar(const float* __restrict__ gf,
                                    const float* __restrict__ gg,
                                    const float* __restrict__ sigma,
                                    long long start, long long d,
                                    float* __restrict__ out) {
  const float s = *sigma;
  const float r = __fsub_rn(1.f, s);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < d; i += stride)
    out[i] = blend(gf[i], gg[i], s, r);
}

}  // namespace

// gf, gg, out: contiguous [d] float32; sigma: one float32 in device memory.
extern "C" int switch_blend_launch(const void* gf, const void* gg,
                                   const void* sigma, long long d, void* out,
                                   void* stream) {
  if (d == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid_cap = 132 * 8;  // a few waves of CTAs on the 132 SMs
  const bool aligned = ((uintptr_t)gf % 16 == 0) &&
                       ((uintptr_t)gg % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  long long done = 0;
  if (aligned) {
    const long long n4 = d / 4;
    if (n4 > 0) {
      const long long want = (n4 + kThreads - 1) / kThreads;
      const int grid = (int)(want < grid_cap ? want : grid_cap);
      switch_blend_vec4<<<grid, kThreads, 0, st>>>(
          (const float4*)gf, (const float4*)gg, (const float*)sigma, n4,
          (float4*)out);
      done = n4 * 4;
    }
  }
  if (done < d) {
    const long long rest = d - done;
    const long long want = (rest + kThreads - 1) / kThreads;
    const int grid = (int)(want < grid_cap ? want : grid_cap);
    switch_blend_scalar<<<grid, kThreads, 0, st>>>(
        (const float*)gf, (const float*)gg, (const float*)sigma, done, d,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
