// Forward flash attention for Hopper (sm_90a): tiled online softmax with f32
// accumulation, causal and sliding-window masks, grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_kernel (Pallas, TPU),
// launched there by flash_attention_bhsd through kernels/ops.flash_attention.
//
// Layout: q [b, sq, h, d], k and v [b, sk, kvh, d] with any strides over the
// first three dimensions (d contiguous), out [b, sq, h, d] contiguous in
// q's type.  Query head hh reads KV head hh / (h / kvh): K and V are never
// repeated.  Query row i sits at key position i + (sk - sq), so a KV prefix
// (sk > sq) lines the causal diagonal up; ragged sq and sk are masked.
//
// What bounds it on this card: arithmetic.  At the main path's shape (q
// [4,512,40,128], kv [4,512,8,128], bf16, causal) the work is 10.7 GFLOP over
// 50 MB, about 210 operations per byte.  On the tensor cores' 989 TFLOP/s the
// bound would be the 15 us it takes to move the bytes; this first version
// does its arithmetic in f32 on the CUDA cores (67 TFLOP/s), so its floor is
// about 160 us, and the work to reach the tensor cores (mma/wgmma on bf16
// tiles) is left to a later version.
//
// What the design does about it: one block of four warps per (64-row query
// tile, head, batch).  The query tile is staged once in shared memory as f32;
// K and V tiles of 32 keys are staged in turn.  Each warp owns 16 query rows:
// a lane scores one key against its 16 rows (16-byte shared-memory loads,
// rows padded by four floats so the loads do not conflict), the running max
// and sum are warp shuffles, the probabilities go through shared memory, and
// each lane accumulates D/32 output columns of its 16 rows in registers.
// Tiles that the causal or window mask hides from every row of the query
// tile are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 32;       // keys per staged tile
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // query rows per warp
constexpr float NEG = -1e30f;    // the masked score (finite: no inf - inf)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + BK * (D + 4) + BK * D + WARPS * RPW * BK) * 4;
}

// D: head dim rounded up to 32, 64 or 128; the true head dim ``d`` <= D is
// zero-padded in shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          int sq, int sk, int h, int kvh, int d,
          long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh,
          long long vsb, long long vss, long long vsh,
          long long osb, long long oss, long long osh,
          float scale, int causal, int window) {
  constexpr int DP = D + 4;   // padded row: conflict-free float4 loads
  constexpr int JD = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][DP]
  float* Ks = Qs + BQ * DP;     // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][D]
  float* Ps = Vs + BK * D;      // [WARPS][RPW][BK]

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kh = hh / (h / kvh);
  const int offs = sk - sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const T* qb = q + bb * qsb + hh * qsh;
  const T* kb = k + bb * ksb + kh * ksh;
  const T* vb = v + bb * vsb + kh * vsh;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_float(qb[(long long)(q0 + r) * qss + c]);
    Qs[r * DP + c] = x;
  }

  // keys every row of this tile masks: past the last row's diagonal, or at
  // or before the first row's window start
  const int q_lo = q0 + offs;
  const int q_hi = min(q0 + BQ, sq) - 1 + offs;
  int kv_end = sk;
  if (causal) kv_end = max(0, min(sk, q_hi + 1));
  int kv_start = 0;
  if (window > 0) kv_start = max(0, q_lo - window + 1);

  float m[RPW], l[RPW], acc[RPW][JD];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[r][j] = 0.f;
  }

  for (int j0 = kv_start; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < BK * D; i += WARPS * 32) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (j0 + r < sk && c < d) {
        kx = to_float(kb[(long long)(j0 + r) * kss + c]);
        vx = to_float(vb[(long long)(j0 + r) * vss + c]);
      }
      Ks[r * DP + c] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * DP;
    const float* qrow = Qs + warp * RPW * DP;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qx = *reinterpret_cast<const float4*>(qrow + r * DP + c);
        s[r] += qx.x * kx.x + qx.y * kx.y + qx.z * kx.z + qx.w * kx.w;
      }
    }

    const int kpos = j0 + lane;
    float* prow = Ps + warp * RPW * BK;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + warp * RPW + r + offs;
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float sv = ok ? s[r] * scale : NEG;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float corr = expf(m[r] - m_new);
      const float p = ok ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[r][j] *= corr;
      prow[r * BK + lane] = p;
    }
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vx[JD];
#pragma unroll
      for (int j = 0; j < JD; ++j) vx[j] = Vs[kk * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = prow[r * BK + kk];
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[r][j] += p * vx[j];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + bb * osb + (long long)row * oss + hh * osh;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = lane + 32 * j;
      if (c < d) orow[c] = from_float<T>(acc[r][j] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int h, int kvh, int d, const long long* st,
                   float scale, int causal, int window, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;  // opt in to >48 KB once per kernel
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd<T, D><<<grid, WARPS * 32, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kvh, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int b, int sq, int sk, int h, int kvh, int d,
                       const long long* st, float scale, int causal, int window,
                       cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, b, sq, sk, h, kvh, d, st, scale, causal, window, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, sq, sk, h, kvh, d, st, scale, causal, window, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, b, sq, sk, h, kvh, d, st, scale, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// strides: 12 element strides, (batch, seq, head) of q, k, v, then out; the
// head dimension is contiguous in all four.  Returns the CUDA error code.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int sq, int sk, int h, int kvh, int d,
                    const long long* strides, float scale, int causal,
                    int window, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, b, sq, sk, h, kvh, d, strides, scale, causal, window, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kvh, d, strides, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
