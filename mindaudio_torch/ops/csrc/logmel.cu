// Fused log-mel spectrogram for Hopper (sm_90a): framing, window*DFT, power,
// mel projection and log in one kernel, the signal read once.
//
//   x    (B, T) float32            signal (not padded: the kernel reads zeros
//                                  before sample 0 and from sample T on)
//   wr   (n_fft, n_freq) float32   window[n] * cos(-2 pi n f / n_fft)
//   wi   (n_fft, n_freq) float32   window[n] * sin(-2 pi n f / n_fft)
//   fb   (n_freq, n_mels) float32  mel filterbank
//   band (2, n_mels) int32         first and one-past-last nonzero row of
//                                  each filterbank column
//   out  (B, n_frames, n_mels) float32 = log(max(power @ fb, log_floor))
//
// Frame i covers samples [i*hop - pad, i*hop - pad + n_fft) of x, with
// pad = n_fft/2 for centered framing and 0 otherwise.
//
// Replaces the Pallas TPU kernel mindaudio_tpu/ops/pallas_mel.py:96 `_kernel`
// (reached by `fused_logmel`, pallas_mel.py:165). It computes the same
// function from the same host-built tables; the TPU kernel's lane-padded
// (n_sub, hop_pad) signal layout, its K shifted copies and its padded tables
// are not carried over: a frame is read at x[i*hop + n] from shared memory.
//
// What bounds it on the H100: operations. At (128, 160000), n_fft 400, hop
// 160, 80 mels it does 4.5e10 float32 operations against 123 MB moved, so
// 0.67 ms at the 67 TFLOP/s float32 peak against 0.04 ms of traffic. What this
// design does about it (first, simple version): one block per (batch, 32
// frames) copies the block's overlapping signal span to shared memory once;
// a thread accumulates re and im for one frequency and 8 frames in registers
// with plain float32 FMAs (a warp shares its frames, so the signal read is a
// broadcast and the table read is coalesced; where the hop is a multiple of 4
// samples the signal is read 16 bytes at a time, which halves the loads per
// FMA); the power tile stays in shared memory and is projected on the mel
// bank there, each mel bin over its own band of frequencies only (a triangle
// covers a few rows of the dense bank; the rows it skips hold zeros). The
// spectrum never goes to device memory. There are no tensor cores here yet (a
// TF32/bf16 split product is the later redesign).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAMES_PER_BLOCK = 32;
constexpr int FRAMES_PER_THREAD = 8;
constexpr int LANES = 32;  // threads over frequency: one warp
constexpr int GROUPS = FRAMES_PER_BLOCK / FRAMES_PER_THREAD;
constexpr int THREADS = LANES * GROUPS;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

// shared memory: sig[span] | power[FRAMES_PER_BLOCK * n_freq]
__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ x, const float* __restrict__ wr,
              const float* __restrict__ wi, const float* __restrict__ fb,
              const int* __restrict__ band, float* __restrict__ out, long long T,
              int n_frames, int blocks_per_row, int n_fft, int hop, int n_freq, int n_mels,
              int pad, float log_floor) {
  extern __shared__ float smem[];
  const int span = (FRAMES_PER_BLOCK - 1) * hop + n_fft;
  float* sig = smem;
  float* power = smem + span;

  const int b = blockIdx.x / blocks_per_row;
  const int frame0 = (blockIdx.x % blocks_per_row) * FRAMES_PER_BLOCK;
  const int lane = threadIdx.x, group = threadIdx.y;
  const int tid = group * LANES + lane;
  const float* xb = x + (size_t)b * T;

  const long long start = (long long)frame0 * hop - pad;
  for (int i = tid; i < span; i += THREADS) {
    const long long p = start + i;
    sig[i] = (p >= 0 && p < T) ? xb[p] : 0.f;
  }
  __syncthreads();

  const float* frames = sig + group * FRAMES_PER_THREAD * hop;
  for (int f = lane; f < n_freq; f += LANES) {
    float re[FRAMES_PER_THREAD], im[FRAMES_PER_THREAD];
#pragma unroll
    for (int j = 0; j < FRAMES_PER_THREAD; ++j) re[j] = im[j] = 0.f;
    int n = 0;
    if (hop % 4 == 0) {  // frame starts are 16-byte aligned in shared memory
      for (; n + 4 <= n_fft; n += 4) {
        float c[4], s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c[q] = wr[(size_t)(n + q) * n_freq + f];
          s[q] = wi[(size_t)(n + q) * n_freq + f];
        }
#pragma unroll
        for (int j = 0; j < FRAMES_PER_THREAD; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(frames + j * hop + n);
          re[j] = fmaf(v.x, c[0], re[j]); im[j] = fmaf(v.x, s[0], im[j]);
          re[j] = fmaf(v.y, c[1], re[j]); im[j] = fmaf(v.y, s[1], im[j]);
          re[j] = fmaf(v.z, c[2], re[j]); im[j] = fmaf(v.z, s[2], im[j]);
          re[j] = fmaf(v.w, c[3], re[j]); im[j] = fmaf(v.w, s[3], im[j]);
        }
      }
    }
    for (; n < n_fft; ++n) {
      const float c = wr[(size_t)n * n_freq + f];
      const float s = wi[(size_t)n * n_freq + f];
#pragma unroll
      for (int j = 0; j < FRAMES_PER_THREAD; ++j) {
        const float v = frames[j * hop + n];
        re[j] = fmaf(v, c, re[j]);
        im[j] = fmaf(v, s, im[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FRAMES_PER_THREAD; ++j)
      power[(group * FRAMES_PER_THREAD + j) * n_freq + f] = re[j] * re[j] + im[j] * im[j];
  }
  __syncthreads();

  for (int idx = tid; idx < FRAMES_PER_BLOCK * n_mels; idx += THREADS) {
    const int fr = idx / n_mels, m = idx % n_mels;
    if (frame0 + fr >= n_frames) break;  // idx grows with fr
    const float* p = power + fr * n_freq;
    float acc = 0.f;
    for (int f = band[m]; f < band[n_mels + m]; ++f)
      acc = fmaf(p[f], fb[(size_t)f * n_mels + m], acc);
    out[((size_t)b * n_frames + frame0 + fr) * n_mels + m] = logf(fmaxf(acc, log_floor));
  }
}

}  // namespace

// Launches on `stream`, never synchronises, returns cudaGetLastError()
// (0 on success).
extern "C" int logmel_launch(const void* x, const void* wr, const void* wi, const void* fb,
                             const void* band, void* out, int B, long long T, int n_frames,
                             int n_fft, int hop, int n_freq, int n_mels, int pad,
                             float log_floor, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  if (n_fft <= 0 || hop <= 0 || n_freq <= 0 || n_mels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks_per_row = (n_frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK;
  const long long blocks = (long long)B * blocks_per_row;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t span = (size_t)(FRAMES_PER_BLOCK - 1) * hop + n_fft;
  const size_t smem = (span + (size_t)FRAMES_PER_BLOCK * n_freq) * sizeof(float);
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  logmel_kernel<<<static_cast<unsigned>(blocks), dim3(LANES, GROUPS), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<const float*>(fb),
      static_cast<const int*>(band), static_cast<float*>(out), T, n_frames, blocks_per_row,
      n_fft, hop, n_freq, n_mels, pad, log_floor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* logmel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
