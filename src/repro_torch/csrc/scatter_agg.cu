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
// Design: one warp (one CTA) per destination block, with a `block`-float
// accumulator in shared memory, so the dense output is
// written to device memory exactly once (16-byte stores where aligned) and
// the scatter never touches global atomics. A client's k slots go in groups
// of 128, four per lane, read with 16-byte value and 8-byte offset loads
// (32 slots, one per lane, where k or the strides are not multiples of 4).
// The warp first issues the loads of up to four groups (all n clients' slots
// for the main path's n = 4, k <= 128), so their round trips overlap, and
// only then adds, group after group in client order -- the order in which
// the plain version's index_add_ adds on the CPU, so the sum is
// deterministic and bit-equal to the plain version, duplicate offsets
// included: each lane writes its slot's number into a per-offset tag and
// reads it back; if no lane finds another's number, the group's offsets are
// distinct and add at once, else its slots add one after another in slot
// order. The uint16 offsets are read as they are on the wire.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSmemBytes = 49152; // accumulator and tags of one CTA

// The R slots of lane `lane` in group g (client j = g / gpc): values times
// the client's weight, and offsets (-1: no slot, or an offset >= block).
template <int R>
__device__ __forceinline__ void load_group(
    const float* __restrict__ vals, long long v_stride,
    const uint16_t* __restrict__ idx, long long i_stride,
    const float* __restrict__ weight, long long b, int k, int block, int g,
    int gpc, int total, int lane, float* v, int* o) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = 0.f;
    o[r] = -1;
  }
  if (g >= total) return;
  const int j = g / gpc;
  const int t = (g - j * gpc) * 32 * R + R * lane;
  if (t >= k) return;
  const float w = weight[j];
  const float* vp = vals + j * v_stride + b * k + t;
  const uint16_t* ip = idx + j * i_stride + b * k + t;
  float vv[R];
  int off[R];
  if (R == 4) {
    const float4 f = *reinterpret_cast<const float4*>(vp);
    const ushort4 u = *reinterpret_cast<const ushort4*>(ip);
    vv[0] = f.x, vv[1] = f.y, vv[2] = f.z, vv[3] = f.w;
    off[0] = u.x, off[1] = u.y, off[2] = u.z, off[3] = u.w;
  } else {
    vv[0] = vp[0];
    off[0] = ip[0];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = __fmul_rn(vv[r], w);
    o[r] = off[r] < block ? off[r] : -1;
  }
}

template <int R>
__global__ void scatter_agg_kernel(const float* __restrict__ vals,
                                   long long v_stride,
                                   const uint16_t* __restrict__ idx,
                                   long long i_stride,
                                   const float* __restrict__ weight, int n,
                                   int k, int block, bool vec_out,
                                   float* __restrict__ out) {
  constexpr int kAhead = R == 4 ? 4 : 16;   // groups loaded before adding
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* tag = smem + (size_t)block * sizeof(float);
  volatile unsigned char* vtag = tag;
  if (vec_out) {
    for (int i = lane; i < block / 4; i += 32)
      reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < block; i += 32) acc[i] = 0.f;
  }
  __syncwarp();

  const int gpc = (k + 32 * R - 1) / (32 * R);   // groups per client
  const int total = n * gpc;                     // client-major
  for (int g0 = 0; g0 < total; g0 += kAhead) {
    float v[kAhead][R];
    int o[kAhead][R];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      load_group<R>(vals, v_stride, idx, i_stride, weight, b, k, block,
                    g0 + a, gpc, total, lane, v[a], o[a]);
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (g0 + a >= total) break;
      bool clash = false;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (o[a][r] >= 0) tag[o[a][r]] = (unsigned char)(R * lane + r);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r)
        clash |= o[a][r] >= 0 && vtag[o[a][r]] != R * lane + r;
      if (__any_sync(kFull, clash)) {
        for (int l = 0; l < 32; ++l) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (lane == l && o[a][r] >= 0)
              acc[o[a][r]] = __fadd_rn(acc[o[a][r]], v[a][r]);
            __syncwarp();
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (o[a][r] >= 0) acc[o[a][r]] = __fadd_rn(acc[o[a][r]], v[a][r]);
      }
      __syncwarp();
    }
  }

  float* dst = out + b * block;
  if (vec_out) {
    for (int i = lane; i < block / 4; i += 32)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(acc)[i];
  } else {
    for (int i = lane; i < block; i += 32) dst[i] = acc[i];
  }
}

}  // namespace

// vals: [n, nb, k] float32 and idx: [n, nb, k] uint16, each with contiguous
// [nb, k] rows and leading strides v_stride / i_stride; weight: [n] float32.
// out: contiguous [nb, block] float32. 5 * block <= kSmemBytes.
extern "C" int scatter_agg_launch(const void* vals, long long v_stride,
                                  const void* idx, long long i_stride,
                                  const void* weight, int n, int nb, int k,
                                  int block, void* out, void* stream) {
  if (nb == 0) return 0;
  const size_t smem = (size_t)block * (sizeof(float) + 1);
  if (smem > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  const bool vec_in = k % 4 == 0 && v_stride % 4 == 0 && i_stride % 4 == 0 &&
                      (uintptr_t)vals % 16 == 0 && (uintptr_t)idx % 8 == 0;
  const bool vec_out = block % 4 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_in)
    scatter_agg_kernel<4><<<(unsigned)nb, 32, smem, s>>>(
        (const float*)vals, v_stride, (const uint16_t*)idx, i_stride,
        (const float*)weight, n, k, block, vec_out, (float*)out);
  else
    scatter_agg_kernel<1><<<(unsigned)nb, 32, smem, s>>>(
        (const float*)vals, v_stride, (const uint16_t*)idx, i_stride,
        (const float*)weight, n, k, block, vec_out, (float*)out);
  return (int)cudaGetLastError();
}
