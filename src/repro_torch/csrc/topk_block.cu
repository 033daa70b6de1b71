// Block-wise magnitude top-k for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_block.py::block_topk, the Pallas TPU
// kernel launched at topk_block.py:49 (k rounds of masked argmax).
//
// Per row of `block` floats: the k entries of largest |x|, in descending
// |x| order, ties to the lowest index (the order the masked argmax emits),
// as (values from x, int32 within-row indices). The magnitude is compared
// as the integer |x| bits, with every NaN mapped to one value above +inf:
// NaNs tie with each other and fall to index order, ahead of +-inf, and
// -0.0 ties +0.0 -- exactly the masked argmax's order.
//
// What bounds it: bytes at the roofline (each element read once, 8 bytes
// written per selected slot). Only k of a row's keys need ordering
// (k <= 96 on the main path), so the design never sorts the row; what is
// left is integer work per element, which this design keeps to a few
// instructions per element and bit.
//
// Radix variant (block <= 1024, k <= 128: every shape of the main path):
// one warp per row, four rows per CTA. The row's 31-bit keys go into
// registers, four per lane and load (16-byte loads when the row start is
// 16-byte aligned, coalesced scalar loads otherwise). The k-th largest key
// T is found bit by bit, each bit one warp-wide count of the keys at or
// above a candidate (the sign bit of key - candidate): the exponent field
// by counting down from the row's largest key (one or two counts in a
// top-k row), the next four bits by bisection; then only the keys that
// share those 12 bits with T (the bucket: a few per row unless the row is
// full of ties) are compacted to shared memory, and T is the right one of
// them -- by one shuffle round when the bucket fits in a warp, else by
// bisection over the remaining bits. The winners are every key above T and
// the first k - #above keys equal to T in index order (usually all of them;
// else ballots give each lane the ties at lower indices, the masked
// argmax's tie rule). They are staged in shared memory with their values,
// read again from the row (coalesced, normally from the caches) so that
// only the keys occupy registers during the search. Each winner's output slot is the
// number of winners with a larger key; if two winners share a key (they
// would share a slot, which a tag per slot shows), the slots are counted
// again with ties to the lower index.
//
// Bitonic variant (block up to 2048 with k > 128, or block > 1024): one CTA
// per row sorts 64-bit keys (inverted magnitude key << 32 | index) of the
// whole row, padded to a power of two, in shared memory. The choice between
// the two is made by shape alone (block_topk_variant).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;     // rows per CTA of the radix variant
constexpr int kMaxK = 128;    // winners a warp stages in shared memory
constexpr int kMaxRadixBlock = 1024;

// |x| as an integer, every NaN one value above +inf: < 2^31
__device__ __forceinline__ uint32_t mag_key(float v) {
  return min(__float_as_uint(v) & 0x7FFFFFFFu, 0x7F800001u);
}

// Element of slot (g, c) of a lane; see block_topk_radix.
template <bool VEC>
__device__ __forceinline__ int element(int lane, int g, int c) {
  return VEC ? 4 * (lane + 32 * g) + c : lane + 32 * (4 * g + c);
}

// The four elements of group g of a lane (0 past the row's end).
template <bool VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ xr,
                                           int block, int lane, int g,
                                           float* q) {
  if (VEC) {
    const int e = element<true>(lane, g, 0);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < block) f = *reinterpret_cast<const float4*>(xr + e);
    q[0] = f.x;
    q[1] = f.y;
    q[2] = f.z;
    q[3] = f.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = element<false>(lane, g, c);
      q[c] = e < block ? xr[e] : 0.f;
    }
  }
}

// #{i : key[i] < c}, for keys and c below 2^31: the sign bit of key - c
template <int N>
__device__ __forceinline__ int count_below(const uint32_t (&key)[N],
                                           uint32_t c) {
  uint32_t a = 0, b = 0;
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    a += (key[i] - c) >> 31;
    b += (key[i + 1] - c) >> 31;
  }
  return (int)(a + b);
}

// rank[w] = #{q < k : key_q > key_p} for winner p = 32 w + lane, w < W,
// over the staged keys (zero-padded to a multiple of 4, 16-byte aligned).
template <int W>
__device__ __forceinline__ void count_larger(const uint32_t* s_key, int k,
                                             int lane, int* rank) {
  uint32_t kp[W], a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int p = 32 * w + lane;
    kp[w] = p < k ? s_key[p] : 0x7FFFFFFFu;
    a[w] = b[w] = 0;
  }
  const uint4* s_key4 = reinterpret_cast<const uint4*>(s_key);
  for (int q = 0; q < (k + 3) >> 2; ++q) {
    const uint4 kq = s_key4[q];
#pragma unroll
    for (int w = 0; w < W; ++w) {   // (kp - kq) >> 31: 1 when kq > kp
      a[w] += (kp[w] - kq.x) >> 31;
      b[w] += (kp[w] - kq.y) >> 31;
      a[w] += (kp[w] - kq.z) >> 31;
      b[w] += (kp[w] - kq.w) >> 31;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) rank[w] = (int)(a[w] + b[w]);
}

// Exclusive prefix sum of v over the warp's lanes; *total gets the sum.
__device__ __forceinline__ int exclusive_scan(int v, int lane, int* total) {
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += y;
  }
  *total = __shfl_sync(kFull, s, 31);
  return s - v;
}

// G groups of four slots per lane. VEC: slot (g, c) holds element
// 4 (lane + 32 g) + c (one 16-byte load per group); otherwise element
// lane + 32 (4 g + c). Both orders visit a group's elements in index order
// lane by lane, which the tie ballots below rely on.
template <int G, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    block_topk_radix(const float* __restrict__ x, long long x_stride,
                     long long rows, int nb, int block, int k,
                     float* __restrict__ vals, int* __restrict__ idx) {
  constexpr int N = 4 * G;
  // per warp: first the bucket's candidate keys (at most 32 N), later the
  // k winners' keys, values, indices and slot tags
  constexpr int kBuf = 32 * N > 4 * kMaxK ? 32 * N : 4 * kMaxK;
  __shared__ __align__(16) uint32_t s_buf[kWarps][kBuf];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const long long j = row / nb, b = row % nb;
  const float* xr = x + j * x_stride + b * block;
  uint32_t* s_cand = s_buf[warp];
  uint32_t* s_key = s_buf[warp];
  float* s_val = reinterpret_cast<float*>(s_buf[warp] + kMaxK);
  int* s_idx = reinterpret_cast<int*>(s_buf[warp] + 2 * kMaxK);
  int* s_tag = reinterpret_cast<int*>(s_buf[warp] + 3 * kMaxK);

  // key: mag_key + 1, so 0 marks a slot past the row's end and never wins.
  // Only the keys stay in registers through the search (fewer registers,
  // more rows in flight); the selection below loads the row again, a
  // coalesced read of what was just read, which the caches normally serve.
  uint32_t key[N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float q[4];
    load_group<VEC>(xr, block, lane, g, q);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      key[4 * g + c] =
          element<VEC>(lane, g, c) < block ? mag_key(q[c]) + 1u : 0u;
  }

  // T, the k-th largest key: the largest t with #{key >= t} >= k. Its bits
  // down to kSplit come from counts over every key in registers: the
  // exponent field (bits 30..23) by counting down from the row's largest
  // key (T is near the top of a top-k row: one or two steps; after three
  // the search takes every bit), the rest by bisection. Only the keys that
  // share those bits with T (the bucket: a few per row unless the row is
  // full of ties) can decide the last kSplit bits, so they are compacted
  // to shared memory.
  constexpr int kSplit = 19;
  uint32_t t = 0;
  int at_t = 32 * N;   // #{key >= t}
  int from = 30;
  {
    uint32_t kmax = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) kmax = max(kmax, key[i]);
    uint32_t e = __reduce_max_sync(kFull, kmax) >> 23;
    for (int step = 0; step < 3; ++step, --e) {
      const int cnt =
          32 * N - __reduce_add_sync(kFull, count_below(key, e << 23));
      if (cnt >= k) {
        t = e << 23;
        at_t = cnt;
        from = 22;
        break;
      }
    }
  }
  for (int bit = from; bit >= kSplit; --bit) {
    const uint32_t cand = t | (1u << bit);
    const int cnt = 32 * N - __reduce_add_sync(kFull, count_below(key, cand));
    if (cnt >= k) {
      t = cand;
      at_t = cnt;
    }
  }
  int nc, pos;
  {
    int mine = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) mine += key[i] - t < (1u << kSplit);
    pos = exclusive_scan(mine, lane, &nc);
  }
  const int above = at_t - nc;   // keys past the bucket
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool in = key[i] - t < (1u << kSplit);
    if (in) s_cand[pos] = key[i];
    pos += in;
  }
  __syncwarp();
  int gt, eq;   // candidates above T and equal to T
  if (nc <= 32) {
    // one candidate per lane: T is the largest c with #{c' >= c} >= need
    const int need = k - above;
    const uint32_t c = lane < nc ? s_cand[lane] : 0u;
    int ge = 0;
#pragma unroll
    for (int m = 0; m < 32; ++m) ge += __shfl_sync(kFull, c, m) >= c;
    t = __reduce_max_sync(kFull, ge >= need ? c : 0u);
    gt = __popc(__ballot_sync(kFull, c > t));
    eq = __popc(__ballot_sync(kFull, c == t));
  } else {
    for (int bit = kSplit - 1; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      uint32_t below = 0;
      for (int i = lane; i < nc; i += 32) below += (s_cand[i] - cand) >> 31;
      if (above + nc - __reduce_add_sync(kFull, (int)below) >= k) t = cand;
    }
    gt = eq = 0;
    for (int i = lane; i < nc; i += 32) {
      gt += s_cand[i] > t;
      eq += s_cand[i] == t;
    }
    gt = __reduce_add_sync(kFull, gt);
    eq = __reduce_add_sync(kFull, eq);
  }
  const int ties = k - above - gt;  // 1 <= ties <= eq
  __syncwarp();

  // Stage the k winners (key, value, index). Usually every key equal to T
  // wins, and the winners are the keys >= T, staged lane by lane; if not,
  // the first `ties` keys equal to T in index order win (ballots give each
  // lane the ties at lower indices).
  if (ties == eq) {
    int mine = 0, total;
#pragma unroll
    for (int i = 0; i < N; ++i) mine += key[i] >= t;
    pos = exclusive_scan(mine, lane, &total);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v[4];
      load_group<VEC>(xr, block, lane, g, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool take = key[4 * g + c] >= t;
        const int e = element<VEC>(lane, g, c);
        if (take) {
          s_key[pos] = key[4 * g + c];
          s_val[pos] = v[c];
          s_idx[pos] = e;
        }
        pos += take;
      }
    }
  } else {
    const uint32_t lt = (1u << lane) - 1u;
    int tie_base = 0, win_base = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v[4];
      load_group<VEC>(xr, block, lane, g, v);
      // a group's elements in index order: VEC lane by lane, each lane's
      // four in turn; scalar one c at a time, lane by lane
#pragma unroll
      for (int c0 = 0; c0 < 4; c0 += VEC ? 4 : 1) {
        constexpr int C = VEC ? 4 : 1;
        uint32_t tb[C], wb[C];
        bool take[C];
#pragma unroll
        for (int c = 0; c < C; ++c)
          tb[c] = __ballot_sync(kFull, key[4 * g + c0 + c] == t);
        int before = tie_base;
#pragma unroll
        for (int c = 0; c < C; ++c) before += __popc(tb[c] & lt);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint32_t kk = key[4 * g + c0 + c];
          take[c] = kk > t || (kk == t && before < ties);
          before += kk == t;
          tie_base += __popc(tb[c]);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) wb[c] = __ballot_sync(kFull, take[c]);
        int at = win_base;
#pragma unroll
        for (int c = 0; c < C; ++c) at += __popc(wb[c] & lt);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (take[c]) {
            s_key[at] = key[4 * g + c0 + c];
            s_val[at] = v[c0 + c];
            s_idx[at] = element<VEC>(lane, g, c0 + c);
            ++at;
          }
          win_base += __popc(wb[c]);
        }
      }
    }
  }
  // keys past k up to a multiple of 4 are 0, which beats no winner
  const int k4 = (k + 3) & ~3;
  if (k + lane < k4) s_key[k + lane] = 0u;
  __syncwarp();

  // Output slot of winner p: the number of winners with a larger key.
  // Equal keys among the winners would share a slot: each winner writes its
  // number into a tag at its slot and reads it back, and if any finds
  // another's, the slots are counted again with ties to the lower index.
  constexpr int P = kMaxK / 32;
  int rank[P] = {};
  switch ((k + 31) >> 5) {
    case 1: count_larger<1>(s_key, k, lane, rank); break;
    case 2: count_larger<2>(s_key, k, lane, rank); break;
    case 3: count_larger<3>(s_key, k, lane, rank); break;
    default: count_larger<4>(s_key, k, lane, rank); break;
  }
  bool clash = false;
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const int p = 32 * w + lane;
    if (32 * w < k && p < k) s_tag[rank[w]] = p;
  }
  __syncwarp();
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const int p = 32 * w + lane;
    if (32 * w < k && p < k)
      clash |= reinterpret_cast<volatile int*>(s_tag)[rank[w]] != p;
  }
  if (__any_sync(kFull, clash)) {
#pragma unroll
    for (int w = 0; w < P; ++w) {
      const int p = 32 * w + lane;
      if (32 * w < k && p < k) {
        const uint32_t kp = s_key[p];
        const int ip = s_idx[p];
        int r = 0;
        for (int q = 0; q < k; ++q) {
          const uint32_t kq = s_key[q];
          r += kq > kp || (kq == kp && s_idx[q] < ip);
        }
        rank[w] = r;
      }
    }
  }
  float* vr = vals + row * k;
  int* ir = idx + row * k;
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const int p = 32 * w + lane;
    if (32 * w < k && p < k) {
      vr[rank[w]] = s_val[p];
      ir[rank[w]] = s_idx[p];
    }
  }
}

template <int P>
__global__ void block_topk_bitonic(const float* __restrict__ x,
                                   long long x_stride, int nb, int block,
                                   int k, float* __restrict__ vals,
                                   int* __restrict__ idx) {
  __shared__ unsigned long long keys[P];
  const long long row = blockIdx.x;
  const long long j = row / nb, b = row % nb;
  const float* xr = x + j * x_stride + b * block;

  // ascending (0x7FFFFFFF - magnitude key, index): descending magnitude,
  // then ascending index; padding sorts last
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    unsigned long long key = ~0ull;
    if (i < block)
      key = ((unsigned long long)(0x7FFFFFFFu - mag_key(xr[i])) << 32) |
            (uint32_t)i;
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

template <int G>
void launch_radix(bool vec, const float* x, long long x_stride,
                  long long rows, int nb, int block, int k, float* vals,
                  int* idx, cudaStream_t s) {
  const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  if (vec)
    block_topk_radix<G, true><<<grid, kWarps * 32, 0, s>>>(
        x, x_stride, rows, nb, block, k, vals, idx);
  else
    block_topk_radix<G, false><<<grid, kWarps * 32, 0, s>>>(
        x, x_stride, rows, nb, block, k, vals, idx);
}

template <int P>
void launch_bitonic(const float* x, long long x_stride, long long rows,
                    int nb, int block, int k, float* vals, int* idx,
                    cudaStream_t s) {
  const int threads = P / 2 < 512 ? P / 2 : 512;
  block_topk_bitonic<P><<<(unsigned)rows, threads, 0, s>>>(
      x, x_stride, nb, block, k, vals, idx);
}

}  // namespace

// Which kernel block_topk_launch runs for this shape: 2 radix with 16-byte
// loads, 1 radix with scalar loads (a row start that is not 16-byte
// aligned), 0 bitonic.
extern "C" int block_topk_variant(const void* x, long long x_stride,
                                  int block, int k) {
  if (block > kMaxRadixBlock || k > kMaxK) return 0;
  const bool vec = block % 4 == 0 && x_stride % 4 == 0 &&
                   (uintptr_t)x % 16 == 0;
  return vec ? 2 : 1;
}

// x: [n, nb, block] float32 with contiguous [nb, block] rows and leading
// stride x_stride. vals: contiguous [n*nb, k] float32, idx: [n*nb, k] int32.
// Blocks up to 2048 elements; 1 <= k <= block.
extern "C" int block_topk_launch(const void* x, long long x_stride,
                                 long long rows, int nb, int block, int k,
                                 void* vals, void* idx, void* stream) {
  if (rows == 0) return 0;
  const float* xp = (const float*)x;
  float* vp = (float*)vals;
  int* ip = (int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  const int variant = block_topk_variant(x, x_stride, block, k);
  if (variant != 0) {
    const bool vec = variant == 2;
    switch ((block + 127) / 128) {
      case 1: launch_radix<1>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      case 2: launch_radix<2>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      case 3: launch_radix<3>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      case 4: launch_radix<4>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      case 5: launch_radix<5>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      case 6: launch_radix<6>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      case 7: launch_radix<7>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
      default: launch_radix<8>(vec, xp, x_stride, rows, nb, block, k, vp, ip, s); break;
    }
  } else if (block <= 64) {
    launch_bitonic<64>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  } else if (block <= 128) {
    launch_bitonic<128>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  } else if (block <= 256) {
    launch_bitonic<256>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  } else if (block <= 512) {
    launch_bitonic<512>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  } else if (block <= 1024) {
    launch_bitonic<1024>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  } else if (block <= 2048) {
    launch_bitonic<2048>(xp, x_stride, rows, nb, block, k, vp, ip, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
