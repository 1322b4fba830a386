// Weight-only int8 GEMM for Hopper (sm_90a):
//
//     y = bf16(x) @ bf16( bf16(w_int8) * bf16(scale) )     (f32 accumulation)
//
// x (M, K) float32 or bf16, row-major; w (K, N) int8, row-major (the JAX
// layout); scale (N,) float32 per output channel; y (M, N) in x's dtype.
//
// Replaces the Pallas TPU kernel mindaudio_tpu/ops/quant.py:60
// `_int8_matmul_kernel` (reached by `int8_matmul`, quant.py:131). It
// computes the same function: the scale and the dequantized product are
// both rounded to bf16 (quant.py:71-72), products accumulate in f32, and the
// store narrows to x's dtype (quant.py:165-166). Bias stays outside, as it
// does there.
//
// What bounds it on the H100: at the serving shapes it is memory-bound. At
// the encoder FFN (M=4096, K=256, N=2048, bf16) the least traffic is
// 2 MB of x + 0.5 MB of int8 w + 16.8 MB of y ~= 19.4 MB, 5.8 us at
// 3.35 TB/s, against 4.3 GFLOP = 4.3 us at 989 TFLOP/s of bf16 tensor cores.
// The int8 weight is the point of the format: it halves the weight stream
// against bf16 and never exists in device memory at bf16 width.
//
// What this design does about it (first, simple version): one block per
// 64x128 output tile; each K-step of 32 stages the x tile (converted to
// bf16 on the way in) and the int8 w tile in shared memory, dequantizes the
// w tile there to bf16 once per block per K-step, and runs WMMA 16x16x16
// bf16 products with f32 accumulators (8 warps, 32x32 each). Rows, columns
// and K are masked in the kernel, so any M, N (4233 on the vocab
// projection) and K work. 16-byte vector loads are used where the rows are
// aligned. There is no software pipelining, TMA, wgmma or persistence yet:
// x is re-read once per 128-column tile from L2, and the loads do not
// overlap the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BM = 64;   // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // K per step
constexpr int WARPS_M = 2, WARPS_N = 4;  // 8 warps, each a 32x32 sub-tile
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
// shared row pitches in bf16 elements: +8 keeps WMMA's ldm a multiple of 8
// and staggers banks between rows
constexpr int XS_LD = BK + 8;
constexpr int WS_LD = BN + 8;

static_assert(THREADS == BM * (BK / 8), "one 8-element x chunk per thread");
static_assert(THREADS == BK * (BN / 16), "one 16-element w chunk per thread");

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, T* __restrict__ y,
                   int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[BK * WS_LD];
  __shared__ __align__(32) __nv_bfloat16 sb[BN];
  __shared__ __align__(32) float ep[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * 32;

  // bf16(scale), as the TPU kernel rounds it (zero past N)
  for (int j = tid; j < BN; j += THREADS)
    sb[j] = __float2bfloat16_rn(n0 + j < N ? s[n0 + j] : 0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // per-thread staging coordinates inside the tiles
  const int xr = tid / (BK / 8), xc = (tid % (BK / 8)) * 8;
  const int wr = tid / (BN / 16), wc = (tid % (BN / 16)) * 16;
  const bool x_vec = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool w_vec = (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // x tile -> bf16 in shared memory
      const int gm = m0 + xr, gk = k0 + xc;
      __align__(16) __nv_bfloat16 v[8];
      if (gm < M && gk + 8 <= K && x_vec) {
        const T* src = x + (size_t)gm * K + gk;
        if constexpr (std::is_same<T, float>::value) {
          const float4 a = reinterpret_cast<const float4*>(src)[0];
          const float4 b = reinterpret_cast<const float4*>(src)[1];
          v[0] = to_bf16(a.x); v[1] = to_bf16(a.y); v[2] = to_bf16(a.z); v[3] = to_bf16(a.w);
          v[4] = to_bf16(b.x); v[5] = to_bf16(b.y); v[6] = to_bf16(b.z); v[7] = to_bf16(b.w);
        } else {
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (gm < M && gk + e < K) ? to_bf16(x[(size_t)gm * K + gk + e])
                                        : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(&xs[xr * XS_LD + xc]) = *reinterpret_cast<const uint4*>(v);
    }
    {  // int8 w tile -> dequantized bf16 in shared memory
      const int gk = k0 + wr, gn = n0 + wc;
      __align__(16) int8_t q[16];
      if (gk < K && gn + 16 <= N && w_vec) {
        *reinterpret_cast<int4*>(q) = *reinterpret_cast<const int4*>(w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          q[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e] : int8_t(0);
      }
      __align__(16) __nv_bfloat16 d[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)  // exact product in f32, one bf16 rounding
        d[e] = __float2bfloat16_rn(static_cast<float>(q[e]) * __bfloat162float(sb[wc + e]));
      uint4* dst = reinterpret_cast<uint4*>(&ws[wr * WS_LD + wc]);
      dst[0] = reinterpret_cast<const uint4*>(d)[0];
      dst[1] = reinterpret_cast<const uint4*>(d)[1];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &xs[(wm + 16 * i) * XS_LD + kk], XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &ws[kk * WS_LD + wn + 16 * j], WS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp bounces one 16x16 accumulator at a time through its
  // own shared scratch, then writes the in-range part in y's dtype
  float* e = ep[warp];
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(e, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm + 16 * i + r, gn = n0 + wn + 16 * j + c0;
      if (gm < M) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (gn + c < N) store_out(&y[(size_t)gm * N + gn + c], e[r * 16 + c0 + c]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Launches on `stream`
// and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* s, void* y,
                                  int M, int N, int K, int dtype, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    int8_matmul_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(s), static_cast<float*>(y), M, N, K);
  } else if (dtype == 1) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
