// CTC forward/backward dynamic program for Hopper (sm_90a).
//
// Forward: the Graves alpha recursion over the extended label sequence
// [b, l0, b, l1, ..., b] (S = 2L+1) for every frame, every alpha row written
// out as the residual of the backward pass, and the per-sequence loss taken
// from the row at the last valid frame. Backward: the reverse beta recursion
// and dL/dlogp_ext = -exp(alpha + beta + loss) * g.
//
//   logp    (B, T, S) float32   log-probs gathered at the extended labels
//   lens    (B,)      int32     valid frames
//   llens   (B,)      int32     label lengths
//   allowed (B, S)    uint8     1 where the s-2 skip may be taken
//   alphas  (B, T, S) float32   forward output / backward input
//   loss    (B,)      float32
//   g       (B,)      float32   upstream cotangent of the loss
//   grad    (B, T, S) float32
//
// Replaces the Pallas TPU kernels mindaudio_tpu/ops/pallas_ctc.py:76
// `_fwd_kernel` and :110 `_bwd_kernel`, and the loss read-out of
// `_ctc_dp_fwd` (:208-216). The arithmetic is theirs: "minus infinity" is
// -1e5 (the masks are additive and gradients of infeasible rows must come
// out finite), lse3 takes the max out, alpha_0 = [0, -1e5, ...] before the
// first frame, frames at t >= len carry the previous row, beta = term at
// t == len-1 and -1e5 beyond, and the backward carries w = logp + beta.
//
// What bounds it on the H100: not bytes (3 * B*T*S*4 bytes for the pair, a
// microsecond at B=32, T=256, S=41) but the chain of T dependent steps. What
// this design does about it: the whole T loop runs inside one launch, one
// block per sequence and one thread per extended label (a strided loop when
// S exceeds the block), the row in shared memory in two buffers so that a
// step costs one __syncthreads(), and the next frame's log-probs (and alphas)
// are loaded into registers before the barrier so that device-memory latency
// overlaps the step. The TPU kernel's time-major layout, (8, 128) padding
// and T-chunked grid are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG_EPS = -1e5f;
constexpr int MAX_THREADS = 1024;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// shared memory: allow[S] | row0[S+2] | row1[S+2]; a row keeps two LOG_EPS
// pads in front so that the s-1 and s-2 reads need no branch
__global__ void ctc_fwd_kernel(const float* __restrict__ logp, const int* __restrict__ lens,
                               const int* __restrict__ llens,
                               const uint8_t* __restrict__ allowed,
                               float* __restrict__ alphas, float* __restrict__ loss,
                               int T, int S) {
  extern __shared__ float smem[];
  float* allow = smem;
  float* prev = smem + S;
  float* cur = prev + S + 2;
  const int b = blockIdx.x, tid = threadIdx.x, stride = blockDim.x;
  const int len = clampi(lens[b], 0, T);
  const size_t base = (size_t)b * T * S;

  for (int s = tid; s < S; s += stride) {
    allow[s] = allowed[(size_t)b * S + s] ? 0.f : LOG_EPS;
    prev[s + 2] = s == 0 ? 0.f : LOG_EPS;
  }
  if (tid < 2) prev[tid] = cur[tid] = LOG_EPS;
  __syncthreads();

  float lp_next = (tid < S && len > 0) ? logp[base + tid] : 0.f;
  for (int t = 0; t < T; ++t) {
    const bool live = t < len;
    const float lp_first = lp_next;
    if (tid < S && t + 1 < len) lp_next = logp[base + (size_t)(t + 1) * S + tid];
    for (int s = tid; s < S; s += stride) {
      const float a = prev[s + 2];
      float v = a;  // frames past the length carry the row
      if (live) {
        const float lp = s == tid ? lp_first : logp[base + (size_t)t * S + s];
        v = lp + lse3(a, prev[s + 1], prev[s] + allow[s]);
      }
      cur[s + 2] = v;
      alphas[base + (size_t)t * S + s] = v;
    }
    __syncthreads();
    float* tmp = prev; prev = cur; cur = tmp;
  }

  if (tid == 0) {  // prev is the row at the last valid frame
    const int l = clampi(llens[b], 0, (S - 1) / 2);
    const float a2 = prev[2 * l + 2];
    float ll = a2;
    if (l > 0) {
      const float a1 = prev[2 * l + 1];
      ll = fmaxf(a2, a1) + log1pf(expf(-fabsf(a2 - a1)));
    }
    loss[b] = -ll;
  }
}

// shared memory: allow2[S] | w0[S+2] | w1[S+2]; a row keeps two LOG_EPS pads
// at the end for the s+1 and s+2 reads. allow2[s] is allowed(s+2).
__global__ void ctc_bwd_kernel(const float* __restrict__ logp, const float* __restrict__ alphas,
                               const int* __restrict__ lens, const int* __restrict__ llens,
                               const uint8_t* __restrict__ allowed,
                               const float* __restrict__ loss, const float* __restrict__ g,
                               float* __restrict__ grad, int T, int S) {
  extern __shared__ float smem[];
  float* allow2 = smem;
  float* wnext = smem + S;
  float* wcur = wnext + S + 2;
  const int b = blockIdx.x, tid = threadIdx.x, stride = blockDim.x;
  const int len = clampi(lens[b], 0, T);
  const int l2 = 2 * clampi(llens[b], 0, (S - 1) / 2);
  const float loss_b = loss[b], g_b = g[b];
  const size_t base = (size_t)b * T * S;

  for (int s = tid; s < S; s += stride) {
    allow2[s] = (s + 2 < S && allowed[(size_t)b * S + s + 2]) ? 0.f : LOG_EPS;
    wnext[s] = LOG_EPS;
  }
  if (tid < 2) wnext[S + tid] = wcur[S + tid] = LOG_EPS;
  __syncthreads();

  float lp_next = 0.f, al_next = 0.f;
  if (tid < S && T > 0) {
    lp_next = logp[base + (size_t)(T - 1) * S + tid];
    al_next = alphas[base + (size_t)(T - 1) * S + tid];
  }
  for (int t = T - 1; t >= 0; --t) {
    const float lp_first = lp_next, al_first = al_next;
    if (tid < S && t > 0) {
      lp_next = logp[base + (size_t)(t - 1) * S + tid];
      al_next = alphas[base + (size_t)(t - 1) * S + tid];
    }
    for (int s = tid; s < S; s += stride) {
      float beta = LOG_EPS;
      if (t == len - 1) {
        beta = (s == l2 || (s == l2 - 1 && l2 > 0)) ? 0.f : LOG_EPS;
      } else if (t < len - 1) {
        beta = lse3(wnext[s], wnext[s + 1], wnext[s + 2] + allow2[s]);
      }
      const size_t at = base + (size_t)t * S + s;
      const float lp = s == tid ? lp_first : logp[at];
      const float al = s == tid ? al_first : alphas[at];
      grad[at] = -expf(al + beta + loss_b) * g_b;
      wcur[s] = lp + beta;
    }
    __syncthreads();
    float* tmp = wnext; wnext = wcur; wcur = tmp;
  }
}

inline int block_threads(int S) { return min(MAX_THREADS, (S + 31) / 32 * 32); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Both launchers run on `stream`, never synchronise, and return
// cudaGetLastError() (0 on success).
extern "C" int ctc_dp_fwd_launch(const void* logp, const void* lens, const void* llens,
                                 const void* allowed, void* alphas, void* loss,
                                 int B, int T, int S, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (3 * (size_t)S + 4) * sizeof(float);
  cudaError_t err = allow_smem(ctc_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_fwd_kernel<<<B, block_threads(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int*>(lens),
      static_cast<const int*>(llens), static_cast<const uint8_t*>(allowed),
      static_cast<float*>(alphas), static_cast<float*>(loss), T, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_dp_bwd_launch(const void* logp, const void* alphas, const void* lens,
                                 const void* llens, const void* allowed, const void* loss,
                                 const void* g, void* grad, int B, int T, int S,
                                 void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (3 * (size_t)S + 4) * sizeof(float);
  cudaError_t err = allow_smem(ctc_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_bwd_kernel<<<B, block_threads(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const float*>(alphas),
      static_cast<const int*>(lens), static_cast<const int*>(llens),
      static_cast<const uint8_t*>(allowed), static_cast<const float*>(loss),
      static_cast<const float*>(g), static_cast<float*>(grad), T, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ctc_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
