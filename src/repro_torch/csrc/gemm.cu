// The two GEMM schedules of the paper's case study for Hopper (sm_90a):
// C = A @ B, A [M,K] and B [K,N] row-major float32 or bfloat16 (both alike),
// C [M,N] float32, f32 accumulation.
//
// Replaces: src/repro/kernels/gemm.py::_cache_blocked_kernel (B3, ATLAS-like)
// and ::_panel_kernel (B4, GotoBLAS-like), Pallas kernels for a TPU.
//
// What bounds them: operations.  At the case study's 16384 x 16384 x 256 f32
// the 137.4 GFLOP take 2.05 ms at the 67 TFLOP/s of f32 FMA on the CUDA
// cores, the 1.11 GB of A, B and C once 0.33 ms at 3.35 TB/s.  These first
// versions keep the math on the CUDA cores (no tensor cores, no TMA).
//
// What each keeps is its global -> shared traffic, because that is what the
// case study's counters (HBM_BYTES, VMEM_TILE_REFILLS) describe:
//
// * cache_blocked: one block per (BM, BN) output tile.  It walks K in BK
//   steps; each step copies A[BM,BK] and B[BK,BN] into shared memory once.
//   The f32 accumulator stays in registers and C is written once.
// * panel_streaming: one block per A panel (M/BM blocks).  The block copies
//   its whole panel A[BM,K] into shared memory once -- nothing else reads A
//   from global memory -- then walks every N tile, streaming B[K,BN] through
//   a STAGE_K-row stage, and writes each C tile.  On the TPU the sequential
//   grid with N innermost gave this for free; blocks run in parallel here,
//   so the loop over N lives inside the block.  The panel is K*(BM+PAD)
//   elements of shared memory: K is bounded (Goto's trade-off), and the
//   wrapper refuses a K whose panel and stage pass 227 KB.
//
// Inside a block, 256 threads each own a TM x TN (TN = 8) tile of the
// accumulator, split in two halves along each axis so that the float4 reads
// of neighbouring threads fall on distinct banks.  A is stored transposed in
// shared memory (As[k][m], rows padded by PAD elements) so that a thread
// reads its TM values of one k as vectors; pairs of threads copy 32 bytes
// of one row of A, and the padding puts a pair's two stores 16 banks apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TN = 8;                    // accumulator columns per thread
constexpr int PAD = 4;                   // As row padding, elements
constexpr int STAGE_K = 32;              // rows of B per panel_streaming stage

// four consecutive values of shared memory as floats
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}

// A[m0:m0+BM, k0:k0+kt] -> As[k][m] (row stride BM+PAD).  16-byte loads;
// thread pair (2p, 2p+1) reads vectors 2q and 2q+1 of row p % BM, one full
// 32-byte sector.  kt is a multiple of two vectors.
template <typename T, int BM>
__device__ __forceinline__ void load_a(const T* __restrict__ A, int lda,
                                       int m0, int k0, int kt, T* As) {
  constexpr int V = 16 / sizeof(T);
  const int units = BM * (kt / V);
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int pair = u >> 1;
    const int m = pair % BM;
    const int q = (pair / BM) * 2 + (u & 1);
    const uint4 v = *reinterpret_cast<const uint4*>(
        A + static_cast<size_t>(m0 + m) * lda + k0 + q * V);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) As[(q * V + i) * (BM + PAD) + m] = e[i];
  }
}

// B[k0:k0+kt, n0:n0+BN] -> Bs[k][n] (row stride BN), 16 bytes a thread.
template <typename T, int BN>
__device__ __forceinline__ void load_b(const T* __restrict__ B, int ldb,
                                       int k0, int n0, int kt, T* Bs) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = BN / V;  // vectors per row
  const int units = kt * VPR;
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int k = u / VPR, c = u % VPR;
    *reinterpret_cast<uint4*>(Bs + k * BN + c * V) =
        *reinterpret_cast<const uint4*>(
            B + static_cast<size_t>(k0 + k) * ldb + n0 + c * V);
  }
}

// acc += As[0:kt, rows] x Bs[0:kt, cols] for this thread's rows and columns:
// rows ty*TM/2 + i and BM/2 + ty*TM/2 + i, columns tx*4 + j and
// BN/2 + tx*4 + j.
template <typename T, int BM, int BN, int TM>
__device__ __forceinline__ void fma_tile(const T* As, const T* Bs, int kt,
                                         float (&acc)[TM][TN], int tx,
                                         int ty) {
#pragma unroll 2
  for (int k = 0; k < kt; ++k) {
    float a[TM], b[TN];
    const T* ar = As + k * (BM + PAD) + ty * (TM / 2);
#pragma unroll
    for (int i = 0; i < TM / 2; i += 4) {
      ld4(ar + i, a + i);
      ld4(ar + BM / 2 + i, a + TM / 2 + i);
    }
    const T* br = Bs + k * BN + tx * 4;
    ld4(br, b);
    ld4(br + BN / 2, b + 4);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int BM, int BN, int TM>
__device__ __forceinline__ void store_c(float* __restrict__ C, int ldc, int m0,
                                        int n0, const float (&acc)[TM][TN],
                                        int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i < TM / 2 ? 0 : BM / 2 - TM / 2) + ty * (TM / 2) + i;
    float* row = C + static_cast<size_t>(m0 + r) * ldc + n0 + tx * 4;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + BN / 2) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <int BM, int BN>
struct Layout {
  static constexpr int TX = BN / TN;       // threads along N
  static constexpr int TY = THREADS / TX;  // threads along M
  static constexpr int TM = BM / TY;       // accumulator rows per thread
  static_assert(TX * TY == THREADS, "BN/8 must divide 256");
  static_assert(TM % 8 == 0, "each half of TM must be whole float4 reads");
};

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
cache_blocked(const T* __restrict__ A, const T* __restrict__ B,
              float* __restrict__ C, int M, int N, int K) {
  using L = Layout<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [BK][BM + PAD]
  T* Bs = As + BK * (BM + PAD);        // [BK][BN]
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[L::TM][TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<T, BM>(A, K, m0, k0, BK, As);
    load_b<T, BN>(B, N, k0, n0, BK, Bs);
    __syncthreads();
    fma_tile<T, BM, BN, L::TM>(As, Bs, BK, acc, tx, ty);
    __syncthreads();
  }
  store_c<BM, BN, L::TM>(C, N, m0, n0, acc, tx, ty);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
panel_streaming(const T* __restrict__ A, const T* __restrict__ B,
                float* __restrict__ C, int M, int N, int K) {
  using L = Layout<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [K][BM + PAD], the resident panel
  T* Bs = As + K * (BM + PAD);         // [STAGE_K][BN]
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int m0 = blockIdx.x * BM;
  load_a<T, BM>(A, K, m0, 0, K, As);  // the one read of this panel of A
  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[L::TM][TN];
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += STAGE_K) {
      load_b<T, BN>(B, N, k0, n0, STAGE_K, Bs);
      __syncthreads();  // the first one also publishes the panel
      fma_tile<T, BM, BN, L::TM>(As + k0 * (BM + PAD), Bs, STAGE_K, acc, tx,
                                 ty);
      __syncthreads();
    }
    store_c<BM, BN, L::TM>(C, N, m0, n0, acc, tx, ty);
  }
}

// Shapes are checked by the caller (kernels/gemm.py blocking: divisibility
// and the 227 KB of shared memory a block may have); a block that asks for
// more shared memory than the card gives fails here, at the attribute.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int BM, int BN, int BK>
int launch_cache_blocked(const void* a, const void* b, float* c, int m, int n,
                         int k, cudaStream_t s) {
  const size_t smem = (BK * (BM + PAD) + BK * BN) * sizeof(T);
  auto kern = cache_blocked<T, BM, BN, BK>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n / BN, m / BM), THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), c, m, n, k);
  return cudaGetLastError();
}

template <typename T, int BM, int BN>
int launch_panel_streaming(const void* a, const void* b, float* c, int m,
                           int n, int k, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(k) * (BM + PAD) + STAGE_K * BN) * sizeof(T);
  auto kern = panel_streaming<T, BM, BN>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<m / BM, THREADS, smem, s>>>(static_cast<const T*>(a),
                                     static_cast<const T*>(b), c, m, n, k);
  return cudaGetLastError();
}

template <typename T>
int cache_blocked_t(const void* a, const void* b, float* c, int m, int n,
                    int k, int bm, int bn, int bk, cudaStream_t s) {
  if (bm == 128 && bn == 128 && bk == 128)
    return launch_cache_blocked<T, 128, 128, 128>(a, b, c, m, n, k, s);
  if (bm == 256 && bn == 128 && bk == 64)
    return launch_cache_blocked<T, 256, 128, 64>(a, b, c, m, n, k, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int panel_streaming_t(const void* a, const void* b, float* c, int m, int n,
                      int k, int bm, int bn, cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return launch_panel_streaming<T, 128, 128>(a, b, c, m, n, k, s);
  if (bm == 128 && bn == 256)
    return launch_panel_streaming<T, 128, 256>(a, b, c, m, n, k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a and b alike); c is float32.  The
// blockings are the instantiated ones (kernels/gemm.py BLOCKINGS), and the
// shapes multiples of them as kernels/gemm.py blocking checks.  Returns the
// CUDA error code of the launch.
int gemm_cache_blocked(const void* a, const void* b, float* c, int dtype,
                       int m, int n, int k, int bm, int bn, int bk,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return cache_blocked_t<float>(a, b, c, m, n, k, bm, bn, bk, s);
    case 1: return cache_blocked_t<__nv_bfloat16>(a, b, c, m, n, k, bm, bn, bk, s);
    default: return cudaErrorInvalidValue;
  }
}

int gemm_panel_streaming(const void* a, const void* b, float* c, int dtype,
                         int m, int n, int k, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return panel_streaming_t<float>(a, b, c, m, n, k, bm, bn, s);
    case 1: return panel_streaming_t<__nv_bfloat16>(a, b, c, m, n, k, bm, bn, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
