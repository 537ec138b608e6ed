// Probe-moment reduction for Hopper (sm_90a): one pass over a tensor gives
// the f32 vector [sum, sum_sq, sum_abs, max_abs, zero_count, nan_count,
// inf_count, numel] (+ ent_sum = sum x*log(x+1e-9) in the entropy variant).
//
// Replaces: src/repro/kernels/probe_reduce.py::_moment_kernel (Pallas, TPU),
// launched there by moments_pallas.
//
// What bounds it: device-memory bytes.  Each element is read once and costs
// about ten f32 operations, far below the operations per byte at which the
// card's f32 rate would become the limit: at [4,512,5120] bf16 the 21 MB read
// takes 6.3 us at 3.35 TB/s, the arithmetic well under 2 us.
//
// What the design does about it: each thread loads 16 bytes at a time (eight
// bf16/f16 or four f32 values), neighbouring threads on neighbouring
// addresses, and a grid of at most 1056 blocks (eight per SM) walks the
// tensor with a grid-stride loop, so every SM keeps loads in flight.  A block
// folds its elements into one partial vector (registers, then warp shuffles,
// then shared memory); a second launch of one block combines the partials in
// a fixed order.  No float atomics: the result depends only on the input and
// on the grid, which the wrapper derives from the element count.  The ragged
// tail and misaligned inputs take a scalar loop; nothing is padded or copied.
// NaN propagates through sum, sum_sq, sum_abs and max_abs (max is written out
// by hand: fmaxf would drop a NaN operand).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NCHAN = 9;  // partials always carry the entropy lane
enum { C_SUM, C_SQ, C_ABS, C_MAX, C_ZERO, C_NAN, C_INF, C_NUMEL, C_ENT };
constexpr unsigned FULL = 0xffffffffu;

struct Acc {
  float sum, sq, abs, mx, zero, nan, inf, ent;
};

__device__ __forceinline__ void acc_init(Acc& a) {
  a.sum = a.sq = a.abs = a.mx = a.zero = a.nan = a.inf = a.ent = 0.f;
}

// max(|x|) folds start from 0 (every |x| >= 0); a NaN, once in, stays.
__device__ __forceinline__ float nanmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

template <bool ENT>
__device__ __forceinline__ void fold(Acc& a, float x) {
  const float ax = fabsf(x);
  a.sum += x;
  a.sq += x * x;
  a.abs += ax;
  a.mx = nanmax(a.mx, ax);
  a.zero += (x == 0.f) ? 1.f : 0.f;
  a.nan += isnan(x) ? 1.f : 0.f;
  a.inf += isinf(x) ? 1.f : 0.f;
  if (ENT) a.ent += x * logf(x + 1e-9f);
}

__device__ __forceinline__ void combine(Acc& a, const Acc& b) {
  a.sum += b.sum;
  a.sq += b.sq;
  a.abs += b.abs;
  a.mx = nanmax(a.mx, b.mx);
  a.zero += b.zero;
  a.nan += b.nan;
  a.inf += b.inf;
  a.ent += b.ent;
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Acc b;
    b.sum = __shfl_xor_sync(FULL, a.sum, o);
    b.sq = __shfl_xor_sync(FULL, a.sq, o);
    b.abs = __shfl_xor_sync(FULL, a.abs, o);
    b.mx = __shfl_xor_sync(FULL, a.mx, o);
    b.zero = __shfl_xor_sync(FULL, a.zero, o);
    b.nan = __shfl_xor_sync(FULL, a.nan, o);
    b.inf = __shfl_xor_sync(FULL, a.inf, o);
    b.ent = __shfl_xor_sync(FULL, a.ent, o);
    combine(a, b);
  }
}

// Reduce a block's per-thread accumulators; the result is valid in thread 0.
__device__ __forceinline__ Acc block_reduce(Acc a) {
  __shared__ Acc sh[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_reduce(a);
  if (lane == 0) sh[warp] = a;
  __syncthreads();
  Acc b;
  acc_init(b);
  if (warp == 0) {
    if (lane < THREADS / 32) b = sh[lane];
    warp_reduce(b);
  }
  return b;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// One 16-byte load, widened to f32.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const __half* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}

template <typename T, bool ENT>
__global__ void __launch_bounds__(THREADS)
moments_partial(const T* __restrict__ x, long long n, float* __restrict__ partials) {
  constexpr int VEC = 16 / sizeof(T);
  Acc a;
  acc_init(a);
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const long long nvec = aligned ? n / VEC : 0;
  for (long long i = tid; i < nvec; i += stride) {
    float v[VEC];
    load16(x + i * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) fold<ENT>(a, v[j]);
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride) fold<ENT>(a, to_float(x[i]));
  const Acc b = block_reduce(a);
  if (threadIdx.x == 0) {
    float* p = partials + (long long)blockIdx.x * NCHAN;
    p[C_SUM] = b.sum; p[C_SQ] = b.sq; p[C_ABS] = b.abs; p[C_MAX] = b.mx;
    p[C_ZERO] = b.zero; p[C_NAN] = b.nan; p[C_INF] = b.inf;
    p[C_NUMEL] = 0.f; p[C_ENT] = b.ent;
  }
}

// One block: fold the per-block partials in a fixed order.  ``numel`` is the
// wrapper's exact element count (f32-rounded), written, never accumulated.
__global__ void __launch_bounds__(THREADS)
moments_combine(const float* __restrict__ partials, int n_parts, float numel,
                int n_out, float* __restrict__ out) {
  Acc a;
  acc_init(a);
  for (int i = threadIdx.x; i < n_parts; i += THREADS) {
    const float* p = partials + (long long)i * NCHAN;
    Acc b;
    b.sum = p[C_SUM]; b.sq = p[C_SQ]; b.abs = p[C_ABS]; b.mx = p[C_MAX];
    b.zero = p[C_ZERO]; b.nan = p[C_NAN]; b.inf = p[C_INF]; b.ent = p[C_ENT];
    combine(a, b);
  }
  const Acc b = block_reduce(a);
  if (threadIdx.x == 0) {
    out[C_SUM] = b.sum; out[C_SQ] = b.sq; out[C_ABS] = b.abs; out[C_MAX] = b.mx;
    out[C_ZERO] = b.zero; out[C_NAN] = b.nan; out[C_INF] = b.inf;
    out[C_NUMEL] = numel;
    if (n_out > C_ENT) out[C_ENT] = b.ent;
  }
}

template <typename T>
cudaError_t launch(const void* x, long long n, float numel, int with_entropy,
                   float* partials, int n_blocks, float* out, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (with_entropy)
    moments_partial<T, true><<<n_blocks, THREADS, 0, s>>>(xt, n, partials);
  else
    moments_partial<T, false><<<n_blocks, THREADS, 0, s>>>(xt, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moments_combine<<<1, THREADS, 0, s>>>(partials, n_blocks, numel,
                                        with_entropy ? NCHAN : NCHAN - 1, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  ``partials`` holds
// n_blocks * 9 floats, ``out`` 8 (9 with entropy); both are allocated by the
// caller.  Returns the CUDA error code of the launches (0 on success).
int probe_moments(const void* x, int dtype, long long n, float numel,
                  int with_entropy, float* partials, int n_blocks, float* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, n, numel, with_entropy, partials, n_blocks, out, s);
    case 1: return launch<__nv_bfloat16>(x, n, numel, with_entropy, partials, n_blocks, out, s);
    case 2: return launch<__half>(x, n, numel, with_entropy, partials, n_blocks, out, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
