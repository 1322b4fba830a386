// Microbenchmark of the CTC recursion's chain: how long one dependent step
// of the alpha recursion takes on this card, and what each part of a step
// adds. Not on any path of the port; `chip_smoke.py` runs it and prints the
// ladder. ctc_dp.cu's kernels take `T` such steps, so T times the latency of
// variant (a) is their chain floor: measured, not a lower bound (faster
// arithmetic or another layout may step quicker).
//
// Every variant runs T steps of the forward recursion of one sequence per
// block (all frames valid), thread 0 stamping %globaltimer (ns) and clock64()
// (SM cycles) before and after the loop; the last row goes to `out` so that
// nothing is optimised away. The variants add one part of a step at a time:
//
//   0  (a)  the row in registers, one warp a sequence, neighbours by
//           __shfl_sync (ctc_dp.cu's layout: K = ceil(S/32) states a lane),
//           lse3 plus the add of a log-prob already in a register
//   1  (a') (a) with __expf/__logf (ex2.approx/lg2.approx): what fast
//           intrinsics would save; the port does not use them
//   2  (b)  the row in shared memory, one thread a state, two buffers and
//           one __syncthreads() a step (the block kernels'), log-prob in a register
//   3  (c)  (b) with the log-prob loaded from device memory one step ahead
//   4  (d)  (c) with the alpha row stored: the block kernels' step, less its
//           strided loop
//   5  (a+) (a) with the alpha row stored to device memory every step, which
//           ctc_dp.cu avoids by staging a chunk of rows in shared memory
//   6  (e)  ctc_dp.cu's band step for wide rows: ceil(S/64) warps a sequence,
//           each a band of 64 states in registers (K = 2 a lane) stepping as
//           (a), the two edge states of each step passed up to the next band
//           by the band kernels' own exchange (ctc_band.cuh: a ring of tagged
//           64-bit words in shared memory, a wait once a group of 4 steps).
//           Up to S = 1024; variants 0-5 take S <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ctc_band.cuh"

namespace {

constexpr float LOG_EPS = -1e5f;
constexpr unsigned FULL = 0xffffffffu;

template <bool FAST>
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (FAST) return m + __logf(__expf(a - m) + __expf(b - m) + __expf(c - m));
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// allowed(s) as the flagship's labels give it: every odd label state but the
// first may skip (no repeats); the blanks may not
__device__ __forceinline__ float allow_of(int s) { return (s >= 2 && (s & 1)) ? 0.f : LOG_EPS; }

template <int K, bool FAST, bool STORE>
__global__ void __launch_bounds__(32)
probe_registers(const float* __restrict__ logp, float* __restrict__ out,
                float* __restrict__ alphas, unsigned long long* __restrict__ ns,
                unsigned long long* __restrict__ cycles, int T, int S) {
  const int lane = threadIdx.x, b = blockIdx.x;
  const int from1 = (lane + 31) & 31, from2 = (lane + 30) & 31;
  float a[K], lp[K], allow[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + 32 * j;
    a[j] = s == 0 ? 0.f : LOG_EPS;
    lp[j] = s < S ? logp[(size_t)b * T * S + s] : 0.f;
    allow[j] = allow_of(s);
  }
  __syncwarp();
  const uint64_t t0 = globaltimer();
  const long long c0 = clock64();
  for (int t = 0; t < T; ++t) {
    float r1[K], r2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      r1[j] = __shfl_sync(FULL, a[j], from1);
      r2[j] = __shfl_sync(FULL, a[j], from2);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float p1 = lane >= 1 ? r1[j] : (j > 0 ? r1[j - 1] : LOG_EPS);
      const float p2 = lane >= 2 ? r2[j] : (j > 0 ? r2[j - 1] : LOG_EPS);
      a[j] = lp[j] + lse3<FAST>(a[j], p1, p2 + allow[j]);
    }
    if (STORE) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (lane + 32 * j < S) alphas[((size_t)b * T + t) * S + lane + 32 * j] = a[j];
    }
  }
  __syncwarp();
  const long long c1 = clock64();
  const uint64_t t1 = globaltimer();
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (lane + 32 * j < S) out[(size_t)b * S + lane + 32 * j] = a[j];
  if (lane == 0) {
    ns[b] = t1 - t0;
    cycles[b] = c1 - c0;
  }
}

// variant (e): ctc_dp.cu's forward band step, less its row loads and
// stores: blockDim.x = 32 * ceil(S / BAND), the exchange of ctc_band.cuh as
// the band kernel drives it (a group of GROUP steps between two waits, the
// last group short). Thread 0 stamps after a __syncthreads() on either side
// of the loop, so the time covers every band.
template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
probe_bands(const float* __restrict__ logp, float* __restrict__ out,
            unsigned long long* __restrict__ ns, unsigned long long* __restrict__ cycles, int T,
            int S) {
  static_assert(32 * K == BAND, "a band is K registers of 32 lanes");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int b = blockIdx.x, base = w * BAND, width = min(BAND, S - base);
  const bool below = w > 0;
  BandEdges edge = band_edges(warps, lane, w, w - 1, w + 1 < warps ? w + 1 : -1, 31, 30);
  const int from1 = (lane + 31) & 31, from2 = (lane + 30) & 31;
  float a[K], lp[K], allow[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = base + lane + 32 * j;
    a[j] = s == 0 ? 0.f : LOG_EPS;
    lp[j] = logp[(size_t)b * T * S + base + min(lane + 32 * j, width - 1)];
    allow[j] = allow_of(s);
  }
  float e1 = LOG_EPS, e2 = LOG_EPS;
  __syncthreads();  // the edge rings are set up
  const uint64_t t0 = globaltimer();
  const long long c0 = clock64();
  auto step = [&](int t, bool release) {
    float r1[K], r2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      r1[j] = __shfl_sync(FULL, a[j], from1);
      r2[j] = __shfl_sync(FULL, a[j], from2);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float p1 = lane >= 1 ? r1[j] : (j > 0 ? r1[j - 1] : e1);
      const float p2 = lane >= 2 ? r2[j] : (j > 0 ? r2[j - 1] : e2);
      a[j] = lp[j] + lse3<false>(a[j], p1, p2 + allow[j]);
    }
    if (release)
      edge.put_at<true>(t, a[K - 1]);
    else
      edge.put_at<false>(t, a[K - 1]);
    float top, top1;
    edge.get_at(t, top, top1);
    e1 = below ? top : LOG_EPS;
    e2 = below ? (lane == 1 ? top : top1) : LOG_EPS;
  };
  int g0 = 0;
  for (; g0 + GROUP <= T; g0 += GROUP) {
    edge.open_group(g0, g0 + GROUP);
#pragma unroll
    for (int s = 0; s < GROUP; ++s) step(g0 + s, s == GROUP - 1);
    edge.close_group(g0, g0 + GROUP, lane);
  }
  if (g0 < T) {  // the last steps, fewer than a group
    edge.open_group(g0, T);
#pragma unroll
    for (int s = 0; s < GROUP; ++s)
      if (g0 + s < T) step(g0 + s, g0 + s == T - 1);
  }
  __syncthreads();
  const long long c1 = clock64();
  const uint64_t t1 = globaltimer();
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (lane + 32 * j < width) out[(size_t)b * S + base + lane + 32 * j] = a[j];
  if (threadIdx.x == 0) {
    ns[b] = t1 - t0;
    cycles[b] = c1 - c0;
  }
}

// variants (b), (c), (d): blockDim.x >= S threads, state s on thread s
template <bool LOAD, bool STORE>
__global__ void probe_shared(const float* __restrict__ logp, float* __restrict__ out,
                             float* __restrict__ alphas, unsigned long long* __restrict__ ns,
                             unsigned long long* __restrict__ cycles, int T, int S) {
  extern __shared__ float smem[];
  float* prev = smem;
  float* cur = smem + S + 2;
  const int b = blockIdx.x, s = threadIdx.x;
  const bool live = s < S;
  const size_t base = (size_t)b * T * S;
  const float allow = allow_of(s);
  if (live) prev[s + 2] = s == 0 ? 0.f : LOG_EPS;
  if (s < 2) prev[s] = cur[s] = LOG_EPS;
  float lp_next = live ? logp[base + s] : 0.f;
  __syncthreads();
  const uint64_t t0 = globaltimer();
  const long long c0 = clock64();
  for (int t = 0; t < T; ++t) {
    const float lp = lp_next;
    if (LOAD && live && t + 1 < T) lp_next = logp[base + (size_t)(t + 1) * S + s];
    if (live) {
      const float v = lp + lse3<false>(prev[s + 2], prev[s + 1], prev[s] + allow);
      cur[s + 2] = v;
      if (STORE) alphas[base + (size_t)t * S + s] = v;
    }
    __syncthreads();
    float* tmp = prev; prev = cur; cur = tmp;
  }
  const long long c1 = clock64();
  const uint64_t t1 = globaltimer();
  if (live) out[(size_t)b * S + s] = prev[s + 2];
  if (s == 0) {
    ns[b] = t1 - t0;
    cycles[b] = c1 - c0;
  }
}

template <typename F>
cudaError_t with_k(int k, F f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ctc_probe_variants() { return 7; }

// One launch of `variant` over B sequences of T steps: the last rows into
// out (B, S), and per block the loop's ns and cycles. `alphas` (B, T, S) is
// written by variants 4 and 5 only. S <= 128 (variant 6: S <= 1024). Returns
// cudaGetLastError().
extern "C" int ctc_probe_launch(int variant, const void* logp, void* out, void* alphas,
                                void* ns, void* cycles, int B, int T, int S, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > (variant == 6 ? BAND * MAX_WARPS : 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(logp);
  float* o = static_cast<float*>(out);
  auto* n = static_cast<unsigned long long*>(ns);
  auto* c = static_cast<unsigned long long*>(cycles);
  const int threads = (S + 31) / 32 * 32;
  const size_t smem = 2 * (S + 2) * sizeof(float);
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0:
    case 1:
    case 5:
      err = with_k((S + 31) / 32, [&](auto kk) {
        constexpr int K = decltype(kk)::value;
        float* al = static_cast<float*>(alphas);
        if (variant == 0) probe_registers<K, false, false><<<B, 32, 0, st>>>(lp, o, al, n, c, T, S);
        if (variant == 1) probe_registers<K, true, false><<<B, 32, 0, st>>>(lp, o, al, n, c, T, S);
        if (variant == 5) probe_registers<K, false, true><<<B, 32, 0, st>>>(lp, o, al, n, c, T, S);
        return cudaSuccess;
      });
      break;
    case 2:
      probe_shared<false, false><<<B, threads, smem, st>>>(lp, o, nullptr, n, c, T, S);
      break;
    case 3:
      probe_shared<true, false><<<B, threads, smem, st>>>(lp, o, nullptr, n, c, T, S);
      break;
    case 4:
      probe_shared<true, true><<<B, threads, smem, st>>>(lp, o, static_cast<float*>(alphas), n,
                                                         c, T, S);
      break;
    case 6: {
      const int warps = (S + BAND - 1) / BAND;
      probe_bands<BAND_K><<<B, 32 * warps, band_smem_bytes(warps), st>>>(lp, o, n, c, T, S);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ctc_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
