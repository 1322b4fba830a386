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
// first frame, frames at t >= len carry the previous row, and the backward
// carries w = logp + beta. Two departures, both in the backward, so that
// its gradient is the derivative of the forward's loss:
// - beta at t == len-1 is 0 at the two final states and minus infinity
//   elsewhere (the TPU kernel: -1e5), as are the states past S, which do not
//   exist; lse3_excl gives minus infinity, not NaN, where all three terms
//   are. On a row that cannot be aligned (T < L + repeats) the loss is near
//   1e5, and a -1e5 there also counted the paths that end elsewhere at the
//   same weight as the loss's own; a state from which no final state can be
//   reached now gets exactly 0.
// - the gradient at frames t >= len is 0, as the loss does not depend on
//   them. The TPU kernel's -exp(alpha - 1e5 + loss) there is not 0 where the
//   loss itself is near 1e5 (a row with no frames but with labels: -g/2 at
//   state 0).
//
// What bounds it on the H100: not bytes (3 * B*T*S*4 bytes for the pair, a
// microsecond at B=32, T=256, S=41) but the chain of `len` dependent steps,
// each a log-sum-exp of three neighbours of the previous row. The least
// latency of one such step is measured by csrc/ctc_probe.cu; T times that
// latency is a kernel's chain floor. What this design does about it:
//
// - One warp per sequence (S <= 32 * MAX_K). Lane `lane` holds the K states
//   s = lane + 32*j in registers. The s-1 and s-2 neighbours come by warp
//   shuffles of the same register; lanes 0 and 1 take them from register
//   j-1 of lanes 31 and 30 (the backward: s+1, s+2 from register j+1 of
//   lanes 0 and 1). No shared row, no block barrier on the chain. All K
//   registers are shuffled before any lse3, so that their chains overlap.
// - The log-probs (and, backward, the alphas) are copied a chunk of frames
//   ahead by cp.async into a ring of STAGES slots in shared memory that only
//   the warp's own lanes read, so a load's latency is paid once per chunk,
//   off the chain, and a slot needs only __syncwarp().
// - Alpha and gradient rows are written into the slot over the log-probs
//   just read and leave for device memory once per chunk, coalesced; a step
//   is one block of code without a branch (the backward takes each row's exp
//   a step later, beside the next lse3).
// - One sequence (one warp) a block: with b = blockIdx.x the compiler sees
//   the control flow as uniform and puts no divergence checks before the
//   shuffles (four sequences a block measured slower on the H100).
//
// Wider rows, 32 * MAX_K < S <= 32 * BAND_K * MAX_WARPS (257 to 1023,
// DeepSpeech2's S = 701 among them), take the band kernels: several warps a
// sequence.
//
// - The row is cut into W = ceil(S / (32 * BAND_K)) bands of 32 * BAND_K
//   states; warp w holds band w in registers in the one-warp layout (K =
//   BAND_K states a lane), so that within a band a step is the one-warp
//   step. More warps put more of the SM's four schedulers on one sequence:
//   a step of a 701-state row is thousands of instructions, which one warp
//   would issue one after the other. What bounds the band path is that
//   issue on one SM (three warps on three of its schedulers at S = 701) and
//   the exchange's latency, not bytes.
// - The forward's dependence runs only up in s, the backward's only down.
//   So a warp needs from its neighbour only the two edge states of the step
//   before (forward: the two top states of the band below; backward: the two
//   bottom w = logp + beta of the band above). The neighbour stores each as
//   one 64-bit word {value, step} into a ring of EDGE_RING steps in shared
//   memory. No barrier is on the chain: the warps run as a wavefront, each
//   GROUP steps behind the band it reads, and wait for it once a group
//   (acquire loads of the group's last pair, which its writer stores with
//   release), not once a step. A step stores and loads its pair without a
//   branch: on the H100 a wait, or a store taken by two lanes, in every step
//   cost more than the exchange itself. Before a group overwrites a step
//   that its reader may not have read, the writer waits until the reader has
//   published (a count in shared memory, every half ring) that it has.
//   ctc_band.cuh holds the band layout's constants, its shared memory's
//   size and this exchange, which ctc_probe.cu's rung (e) times alone.
// - Nothing is staged in shared memory: each step stores its alpha
//   (gradient) row to device memory from registers, and the log-probs
//   (backward: and alphas) of a group of steps are loaded into registers
//   while the group before runs, so that every memory access is spread over
//   the steps. On the H100, staging a chunk of rows through shared memory
//   (the one-warp path's design) made the band kernels slower than the block
//   kernels at this width: each warp's burst of copies at a chunk's end held
//   up the bands that read its edges. The chain ends at `len`; frames past
//   it are written off the chain. Shared memory holds only the edge rings
//   (and, at the forward's end, the last row, for the loss).
// - BAND_K = 2: on the H100 a step of three states a lane took more than
//   twice as long as one of two (the compiler's schedule of three lse3
//   chains); one state a lane needs twice the warps and exchanges.
//   DeepSpeech2's S = 701 is 11 warps of 64 states. MAX_WARPS = 16 (512
//   threads) leaves each thread up to 128 registers: at 768 threads (80
//   registers) the backward ran slower on the H100, its loads of the next
//   group sunk to the group's end.
//
// Rows wider still (S >= 1025) take the block kernels, the port's first design
// kept as it was but for the zero gradient past the length: the choice is by
// shape alone, in ops/ctc_dp.py `kernel_plan` (the path and the threads of a
// block; on the one-warp and block paths also K, the chunk and the shared
// memory), which passes it to the launchers. The band launcher lays out its
// block itself (BAND_K, GROUP, `band_smem_bytes`).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ctc_band.cuh"

namespace {

constexpr float LOG_EPS = -1e5f;
constexpr float NEG_INF = -__builtin_huge_valf();  // beta where no final state is reachable
constexpr int MAX_K = 8;  // registers per lane on the one-warp path: S <= 256
constexpr int STAGES = 2;  // ring slots: chunk c+1 lands while chunk c is read
constexpr int MAX_THREADS = 1024;  // a block on the block path
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// lse3 for the backward, whose terms may all be minus infinity: the max is
// taken out as at least -FLT_MAX, so that each exp is of -inf (0) and the
// sum's log is -inf, not NaN; where any term is finite it is lse3 exactly
__device__ __forceinline__ float lse3_excl(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float mm = fmaxf(m, -3.402823466e38f);
  return m + logf(expf(a - mm) + expf(b - mm) + expf(c - mm));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// a load of read-only device memory kept where it stands among the edge
// exchange's instructions (left to the compiler, a group's loads for the
// group after sink to the group's end, and the next group waits on them)
__device__ __forceinline__ float load_early(const float* at) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(at));
  return v;
}

// a store to device memory that lanes with `live` false skip, without a
// branch (left to the compiler, an expression computed for the store moves
// into a divergent branch of its own)
__device__ __forceinline__ void store_if(float* at, float v, bool live) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t@p st.global.f32 [%0], %1;\n\t}"
               ::"l"(at), "f"(v), "r"(static_cast<int>(live)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest `N` groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `n` contiguous floats from device memory into a ring slot, thread `i` of
// `stride` copying elements i, i + stride, ...
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int i, int stride) {
  for (int e = i; e < n; e += stride) cp_async4(dst + e, src + e);
}

// Frames [0, len) in chunks of `chunk`, forward: chunk c is frames
// [c*chunk, c*chunk + n). Backward: chunk c ends where chunk c-1 began, at
// len - c*chunk, so the walk from len-1 down to 0 meets whole chunks first
// and the short one (if any) last.
__device__ __forceinline__ int chunk_start(int c, int len, int chunk, bool reverse) {
  return reverse ? max(len - (c + 1) * chunk, 0) : c * chunk;
}

__device__ __forceinline__ int chunk_frames(int c, int len, int chunk, bool reverse) {
  return reverse ? len - c * chunk - chunk_start(c, len, chunk, true)
                 : min(chunk, len - c * chunk);
}

// ---------------------------------------------------------------- one warp

// shared memory: STAGES slots of chunk*S log-probs; each step
// writes its alpha row over the log-probs it has read, and the chunk's rows
// go out together when it ends (a store a step on the chain costs more than
// the step's arithmetic)
template <int K>
__global__ void __launch_bounds__(32)
ctc_fwd_warp_kernel(const float* __restrict__ logp, const int* __restrict__ lens,
                    const int* __restrict__ llens, const uint8_t* __restrict__ allowed,
                    float* __restrict__ alphas, float* __restrict__ loss, int T, int S,
                    int chunk) {
  extern __shared__ float ring[];
  const int lane = threadIdx.x, b = blockIdx.x;
  const int slot_size = chunk * S;
  const int len = clampi(lens[b], 0, T);
  const float* lp_seq = logp + (size_t)b * T * S;
  float* al_seq = alphas + (size_t)b * T * S;
  const int from1 = (lane + 31) & 31, from2 = (lane + 30) & 31;

  float a[K], allow[K];
  int at[K];  // the state's column in a frame; states past S use the last one
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + 32 * j;
    a[j] = s == 0 ? 0.f : LOG_EPS;
    allow[j] = (s < S && allowed[(size_t)b * S + s]) ? 0.f : LOG_EPS;
    at[j] = min(s, S - 1);
  }

  const int chunks = (len + chunk - 1) / chunk;
  if (chunks > 0) stage(ring, lp_seq, chunk_frames(0, len, chunk, false) * S, lane, 32);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)  // the next chunk into the other slot, read a chunk from now
      stage(ring + ((c + 1) % STAGES) * slot_size, lp_seq + (size_t)(c + 1) * slot_size,
            chunk_frames(c + 1, len, chunk, false) * S, lane, 32);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // every lane's copies of chunk c are in
    float* slot = ring + (c % STAGES) * slot_size;
    const int n = chunk_frames(c, len, chunk, false);
    for (int k = 0; k < n; ++k) {  // one step, without a branch
      // every register's neighbours first, so that the K lse3 chains overlap
      float x1[K], x2[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        x1[j] = __shfl_sync(FULL, a[j], from1);
        x2[j] = __shfl_sync(FULL, a[j], from2);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {  // lanes 0 and 1 take register j-1 of lanes 31 and 30
        const int below = j > 0 ? j - 1 : 0;
        const float p1 = lane >= 1 ? x1[j] : (j > 0 ? x1[below] : LOG_EPS);
        const float p2 = lane >= 2 ? x2[j] : (j > 0 ? x2[below] : LOG_EPS);
        a[j] = slot[k * S + at[j]] + lse3(a[j], p1, p2 + allow[j]);
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (lane + 32 * j < S) slot[k * S + lane + 32 * j] = a[j];
    }
    __syncwarp();
    float* out = al_seq + (size_t)c * slot_size;
    for (int e = lane; e < n * S; e += 32) out[e] = slot[e];
    __syncwarp();  // every lane is done with slot c before chunk c+2 refills it
  }
  cp_async_wait<0>();

  for (int t = len; t < T; ++t) {  // frames past the length carry the row
    float* out = al_seq + (size_t)t * S;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lane + 32 * j < S) out[lane + 32 * j] = a[j];
  }

  // the loss from states 2l and 2l-1 of the row at the last valid frame, read
  // back through the idle ring: selecting a register by l2 would move the
  // whole row to local memory
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (lane + 32 * j < S) ring[lane + 32 * j] = a[j];
  __syncwarp();
  if (lane == 0) {
    const int l2 = 2 * clampi(llens[b], 0, (S - 1) / 2);
    const float a2 = ring[l2];
    float ll = a2;
    if (l2 > 0) {
      const float a1 = ring[l2 - 1];
      ll = fmaxf(a2, a1) + log1pf(expf(-fabsf(a2 - a1)));
    }
    loss[b] = -ll;
  }
}

// shared memory: STAGES slots of chunk*S log-probs then chunk*S alphas, and
// 32 words (one a lane); each gradient row is written over the log-probs of
// its frame, and the chunk's rows go out together when it ends. A row's exp
// is taken in the next step, beside that step's lse3, and lanes without a
// state store into the dump: the step stays one branch-free block of code.
template <int K>
__global__ void __launch_bounds__(32)
ctc_bwd_warp_kernel(const float* __restrict__ logp, const float* __restrict__ alphas,
                    const int* __restrict__ lens, const int* __restrict__ llens,
                    const uint8_t* __restrict__ allowed, const float* __restrict__ loss,
                    const float* __restrict__ g, float* __restrict__ grad, int T, int S,
                    int chunk) {
  extern __shared__ float ring[];
  const int lane = threadIdx.x, b = blockIdx.x;
  const int slot_size = chunk * S;
  float* dump = ring + STAGES * 2 * slot_size + lane;
  const int len = clampi(lens[b], 0, T);
  const int l2 = 2 * clampi(llens[b], 0, (S - 1) / 2);
  const float loss_b = loss[b], g_b = g[b];
  const size_t base = (size_t)b * T * S;
  const float* lp_seq = logp + base;
  const float* al_seq = alphas + base;
  float* gr_seq = grad + base;
  const int from1 = (lane + 1) & 31, from2 = (lane + 2) & 31;

  float w[K], allow2[K], term[K];  // w = logp + beta of the frame after this one
  int at[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + 32 * j;
    w[j] = NEG_INF;
    allow2[j] = (s + 2 < S && allowed[(size_t)b * S + s + 2]) ? 0.f : LOG_EPS;
    term[j] = (s == l2 || (s == l2 - 1 && l2 > 0)) ? 0.f : NEG_INF;
    at[j] = min(s, S - 1);
  }

  // frames past the length: the loss does not depend on them
  for (int t = len; t < T; ++t) {
    float* out = gr_seq + (size_t)t * S;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lane + 32 * j < S) out[lane + 32 * j] = 0.f;
  }

  const int chunks = (len + chunk - 1) / chunk;
  auto fill = [&](int c) {
    float* slot = ring + (c % STAGES) * 2 * slot_size;
    const size_t from = (size_t)chunk_start(c, len, chunk, true) * S;
    const int n = chunk_frames(c, len, chunk, true) * S;
    stage(slot, lp_seq + from, n, lane, 32);
    stage(slot + slot_size, al_seq + from, n, lane, 32);
  };
  if (chunks > 0) fill(0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fill(c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    float* slot = ring + (c % STAGES) * 2 * slot_size;
    const int t0 = chunk_start(c, len, chunk, true), n = chunk_frames(c, len, chunk, true);
    float arg[K];  // alpha + beta + loss of the row before, not yet exponentiated
    float* to[K];  // where its gradients go
    float lp[K], al[K];  // frame t0 + k, read before the row before is stored
    auto load = [&](int k) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        lp[j] = slot[k * S + at[j]];
        al[j] = slot[slot_size + k * S + at[j]];
      }
    };
    // with beta at frame t0 + k
    auto finish = [&](int k, const float* beta) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        // states past S keep w = -inf: they are the s+1, s+2 of the last states
        const bool live = lane + 32 * j < S;
        w[j] = live ? lp[j] + beta[j] : NEG_INF;
        arg[j] = al[j] + beta[j] + loss_b;
        to[j] = live ? slot + k * S + lane + 32 * j : dump;
      }
    };
    int k = n - 1;
    if (c == 0) {  // the last valid frame: beta = term
      load(k);
      finish(k, term);
      --k;
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        arg[j] = LOG_EPS;
        to[j] = dump;
      }
    }
    for (; k >= 0; --k) {  // one step, without a branch
      float x1[K], x2[K], gr[K], beta[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        x1[j] = __shfl_sync(FULL, w[j], from1);
        x2[j] = __shfl_sync(FULL, w[j], from2);
      }
      load(k);
#pragma unroll
      for (int j = 0; j < K; ++j) gr[j] = -expf(arg[j]) * g_b;  // off the chain
#pragma unroll
      for (int j = 0; j < K; ++j) {  // lanes 31 and 30 take register j+1 of lanes 0 and 1
        const int above = j + 1 < K ? j + 1 : j;
        const float q1 = lane <= 30 ? x1[j] : (j + 1 < K ? x1[above] : NEG_INF);
        const float q2 = lane <= 29 ? x2[j] : (j + 1 < K ? x2[above] : NEG_INF);
        beta[j] = lse3_excl(w[j], q1, q2 + allow2[j]);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) *to[j] = gr[j];  // the row before, its exp long done
      finish(k, beta);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) *to[j] = -expf(arg[j]) * g_b;
    __syncwarp();
    float* out = gr_seq + (size_t)t0 * S;
    for (int e = lane; e < n * S; e += 32) out[e] = slot[e];
    __syncwarp();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- bands

// Forward, warp w on states [w * BAND, w * BAND + width). Step t stores its
// alpha row to device memory and its two top states (lanes 31 and 30,
// register K-1) for the band above, then loads the band below's pair of
// step t for step t+1: lanes 0 and 1 of register 0 take it as their s-1 and
// s-2. The log-probs of a group of steps are loaded into registers while
// the group before runs.
template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ctc_fwd_band_kernel(const float* __restrict__ logp, const int* __restrict__ lens,
                    const int* __restrict__ llens, const uint8_t* __restrict__ allowed,
                    float* __restrict__ alphas, float* __restrict__ loss, int T, int S) {
  static_assert(32 * K == BAND, "a band is K registers of 32 lanes");
  extern __shared__ __align__(16) float row_smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int b = blockIdx.x, base = w * BAND, width = min(BAND, S - base);
  const int len = clampi(lens[b], 0, T);
  const bool below = w > 0;
  BandEdges edge = band_edges(warps, lane, w, w - 1, w + 1 < warps ? w + 1 : -1, 31, 30);
  const float* lp_seq = logp + (size_t)b * T * S + base;
  float* al_seq = alphas + (size_t)b * T * S + base;
  const int from1 = (lane + 31) & 31, from2 = (lane + 30) & 31;

  float a[K], allow[K];
  int at[K];  // the state's column in the band; states past S use the last one
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = base + lane + 32 * j;
    a[j] = s == 0 ? 0.f : LOG_EPS;
    allow[j] = (s < S && allowed[(size_t)b * S + s]) ? 0.f : LOG_EPS;
    at[j] = min(lane + 32 * j, width - 1);
  }
  // lanes 0 (s-1 and s-2) and 1 (s-2) of register 0: the band below's top
  // states of the step before, at first its initial row (-1e5; none below band 0)
  float e1 = LOG_EPS, e2 = LOG_EPS;
  float lps[GROUP][K];  // the log-probs of the group's frames
  auto load = [&](int slot, int t) {  // frame t (past the last, the last: never used)
    const float* row = lp_seq + (size_t)min(t, T - 1) * S;
#pragma unroll
    for (int j = 0; j < K; ++j) lps[slot][j] = row[at[j]];
  };
#pragma unroll
  for (int s = 0; s < GROUP; ++s) load(s, s);
  __syncthreads();  // the edge rings are set up

  // one step, without a branch; RELEASE on a group's last
  auto step = [&](int t, int slot, bool release) {
    float x1[K], x2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      x1[j] = __shfl_sync(FULL, a[j], from1);
      x2[j] = __shfl_sync(FULL, a[j], from2);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {  // lanes 0 and 1 take register j-1 of lanes 31 and 30
      const int below_j = j > 0 ? j - 1 : 0;
      const float p1 = lane >= 1 ? x1[j] : (j > 0 ? x1[below_j] : e1);
      const float p2 = lane >= 2 ? x2[j] : (j > 0 ? x2[below_j] : e2);
      a[j] = lps[slot][j] + lse3(a[j], p1, p2 + allow[j]);
    }
    load(slot, t + GROUP);  // the same slot of the next group
    // lane 31: the top state, lane 30: top-1
    if (release)
      edge.put_at<true>(t, a[K - 1]);
    else
      edge.put_at<false>(t, a[K - 1]);
    float top, top1;
    edge.get_at(t, top, top1);
    e1 = below ? top : LOG_EPS;
    e2 = below ? (lane == 1 ? top : top1) : LOG_EPS;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lane + 32 * j < width) al_seq[(size_t)t * S + lane + 32 * j] = a[j];
  };
  int g0 = 0;
  for (; g0 + GROUP <= len; g0 += GROUP) {
    edge.open_group(g0, g0 + GROUP);
#pragma unroll
    for (int s = 0; s < GROUP; ++s) step(g0 + s, s, s == GROUP - 1);
    edge.close_group(g0, g0 + GROUP, lane);
  }
  if (g0 < len) {  // the last steps, fewer than a group
    edge.open_group(g0, len);
#pragma unroll
    for (int s = 0; s < GROUP; ++s)
      if (g0 + s < len) step(g0 + s, s, g0 + s == len - 1);
  }

  for (int t = len; t < T; ++t) {  // frames past the length carry the row
    float* out = al_seq + (size_t)t * S;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lane + 32 * j < width) out[lane + 32 * j] = a[j];
  }

  // the loss from states 2l and 2l-1 of the row at the last valid frame,
  // which may lie in two bands: the row through shared memory, over the
  // edge rings
  __syncthreads();  // every warp is done with the edge rings
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (lane + 32 * j < width) row_smem[base + lane + 32 * j] = a[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int l2 = 2 * clampi(llens[b], 0, (S - 1) / 2);
    const float a2 = row_smem[l2];
    float ll = a2;
    if (l2 > 0) {
      const float a1 = row_smem[l2 - 1];
      ll = fmaxf(a2, a1) + log1pf(expf(-fabsf(a2 - a1)));
    }
    loss[b] = -ll;
  }
}

// Backward, warp w on the same band, walking the frames down from len-1
// (step i on frame len-1-i). Step i stores the gradient row of the frame
// after (its exp taken beside this step's lse3) and its two bottom wv =
// logp + beta (lanes 0 and 1, register 0) for the band below, then loads
// the band above's pair of step i for step i+1: lanes 31 (s+1 and s+2) and
// 30 (s+2) of register K-1 take it. Step 0 (beta = term) is a group of its
// own. The step is the one-warp backward's.
template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ctc_bwd_band_kernel(const float* __restrict__ logp, const float* __restrict__ alphas,
                    const int* __restrict__ lens, const int* __restrict__ llens,
                    const uint8_t* __restrict__ allowed, const float* __restrict__ loss,
                    const float* __restrict__ g, float* __restrict__ grad, int T, int S) {
  static_assert(32 * K == BAND, "a band is K registers of 32 lanes");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int b = blockIdx.x, base = w * BAND, width = min(BAND, S - base);
  const int len = clampi(lens[b], 0, T);
  const int l2 = 2 * clampi(llens[b], 0, (S - 1) / 2);
  const float loss_b = loss[b], g_b = g[b];
  const bool above = w + 1 < warps;
  BandEdges edge = band_edges(warps, lane, w, above ? w + 1 : -1, w > 0 ? w - 1 : -1, 0, 1);
  const size_t seq = (size_t)b * T * S + base;
  const float* lp_seq = logp + seq;
  const float* al_seq = alphas + seq;
  float* gr_seq = grad + seq;
  const int from1 = (lane + 1) & 31, from2 = (lane + 2) & 31;

  float wv[K], allow2[K], term[K];  // wv = logp + beta of the frame after this one
  int at[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = base + lane + 32 * j;
    wv[j] = NEG_INF;
    allow2[j] = (s + 2 < S && allowed[(size_t)b * S + s + 2]) ? 0.f : LOG_EPS;
    term[j] = (s == l2 || (s == l2 - 1 && l2 > 0)) ? 0.f : NEG_INF;
    at[j] = min(lane + 32 * j, width - 1);
  }
  // lanes 31 (s+1 and s+2) and 30 (s+2) of register K-1: the band above's
  // bottom wv of the step before (minus infinity above the last band)
  float e1 = NEG_INF, e2 = NEG_INF;
  float lps[GROUP][K], als[GROUP][K];  // the log-probs and alphas of the group's frames
  auto load = [&](int slot, int i) {  // step i's frame (past frame 0, frame 0: never used)
    const size_t row = (size_t)max(len - 1 - i, 0) * S;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      lps[slot][j] = load_early(lp_seq + row + at[j]);
      als[slot][j] = load_early(al_seq + row + at[j]);
    }
  };
  float arg[K];  // alpha + beta + loss of the frame after, not yet exponentiated
  // with beta at step i; then the gradient-to-be, and the edges
  auto finish = [&](int i, int slot, const float* beta, bool release) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // states past S keep wv = -inf: they are the s+1, s+2 of the last states
      wv[j] = lane + 32 * j < width ? lps[slot][j] + beta[j] : NEG_INF;
      arg[j] = als[slot][j] + beta[j] + loss_b;
    }
    // lane 0: the bottom state, lane 1: bottom+1
    if (release)
      edge.put_at<true>(i, wv[0]);
    else
      edge.put_at<false>(i, wv[0]);
    float bottom, bottom1;
    edge.get_at(i, bottom, bottom1);
    e1 = above ? bottom : NEG_INF;
    e2 = above ? (lane == 30 ? bottom : bottom1) : NEG_INF;
  };
  auto store_grad = [&](int t) {  // frame t's gradient, from the arg of its step
#pragma unroll
    for (int j = 0; j < K; ++j)
      store_if(gr_seq + (size_t)t * S + lane + 32 * j, -expf(arg[j]) * g_b, lane + 32 * j < width);
  };
  if (len > 0) load(0, 0);  // step 0's frame
  __syncthreads();  // the edge rings are set up

  for (int t = len; t < T; ++t)  // frames past the length: the loss does not depend on them
    for (int e = lane; e < width; e += 32) gr_seq[(size_t)t * S + e] = 0.f;

  // one step, without a branch; RELEASE on a group's last
  auto step = [&](int i, int slot, bool release) {
    float x1[K], x2[K], beta[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      x1[j] = __shfl_sync(FULL, wv[j], from1);
      x2[j] = __shfl_sync(FULL, wv[j], from2);
    }
    store_grad(len - i);  // the frame after's gradient, off the chain
#pragma unroll
    for (int j = 0; j < K; ++j) {  // lanes 31 and 30 take register j+1 of lanes 0 and 1
      const int above_j = j + 1 < K ? j + 1 : j;
      const float q1 = lane <= 30 ? x1[j] : (j + 1 < K ? x1[above_j] : e1);
      const float q2 = lane <= 29 ? x2[j] : (j + 1 < K ? x2[above_j] : e2);
      beta[j] = lse3_excl(wv[j], q1, q2 + allow2[j]);
    }
    finish(i, slot, beta, release);
    load(slot, i + GROUP);  // the same slot of the next group
  };
  if (len > 0) {
    // step 0, the last valid frame: beta = term, a group of its own
    edge.open_group(0, 1);
    finish(0, 0, term, true);
    edge.close_group(0, 1, lane);
#pragma unroll
    for (int s = 0; s < GROUP; ++s) load(s, 1 + s);  // the first group's frames
    int g0 = 1;
    for (; g0 + GROUP <= len; g0 += GROUP) {
      edge.open_group(g0, g0 + GROUP);
#pragma unroll
      for (int s = 0; s < GROUP; ++s) step(g0 + s, s, s == GROUP - 1);
      edge.close_group(g0, g0 + GROUP, lane);
    }
    if (g0 < len) {  // the last steps, fewer than a group
      edge.open_group(g0, len);
#pragma unroll
      for (int s = 0; s < GROUP; ++s)
        if (g0 + s < len) step(g0 + s, s, g0 + s == len - 1);
    }
    store_grad(0);
  }
}

// ---------------------------------------------------------------- one block

// Wide rows, the port's first design: one thread a state (a strided loop beyond
// MAX_THREADS), the row in shared memory in two buffers so that a step costs
// one __syncthreads(), the next frame's log-probs (and alphas) loaded into a
// register one step ahead. Nothing is staged, so any row whose three shared
// rows fit in 227 KB is taken.

// shared memory: allow[S] | row0[S+2] | row1[S+2]; a row keeps two LOG_EPS
// pads in front so that the s-1 and s-2 reads need no branch
__global__ void ctc_fwd_block_kernel(const float* __restrict__ logp,
                                     const int* __restrict__ lens,
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

// shared memory: allow2[S] | w0[S+2] | w1[S+2]; a row keeps two -inf pads
// at the end for the s+1 and s+2 reads. allow2[s] is allowed(s+2).
__global__ void ctc_bwd_block_kernel(const float* __restrict__ logp,
                                     const float* __restrict__ alphas,
                                     const int* __restrict__ lens,
                                     const int* __restrict__ llens,
                                     const uint8_t* __restrict__ allowed,
                                     const float* __restrict__ loss,
                                     const float* __restrict__ g, float* __restrict__ grad,
                                     int T, int S) {
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
    wnext[s] = NEG_INF;
  }
  if (tid < 2) wnext[S + tid] = wcur[S + tid] = NEG_INF;
  __syncthreads();

  float lp_next = 0.f, al_next = 0.f;
  if (tid < S) {
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
        beta = (s == l2 || (s == l2 - 1 && l2 > 0)) ? 0.f : NEG_INF;
      } else if (t < len - 1) {
        beta = lse3_excl(wnext[s], wnext[s + 1], wnext[s + 2] + allow2[s]);
      }
      const size_t at = base + (size_t)t * S + s;
      const float lp = s == tid ? lp_first : logp[at];
      const float al = s == tid ? al_first : alphas[at];
      // frames past the length: the loss does not depend on them
      grad[at] = t < len ? -expf(al + beta + loss_b) * g_b : 0.f;
      wcur[s] = lp + beta;
    }
    __syncthreads();
    float* tmp = wnext; wnext = wcur; wcur = tmp;
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

enum Path { WARP = 0, BAND_PATH = 1, BLOCK = 2 };

// the one-warp path: k = ceil(S/32) <= MAX_K, one warp; the band path:
// ceil(S/BAND) warps (5 to MAX_WARPS), its k, chunk and shared memory not
// read; the block path: whole warps up to a block
bool plan_ok(int path, int S, int k, int threads, int chunk) {
  switch (path) {
    case WARP:
      return threads == 32 && chunk >= 1 && k <= MAX_K && k == (S + 31) / 32;
    case BAND_PATH:
      return S > 32 * MAX_K && threads == 32 * ((S + BAND - 1) / BAND) &&
             threads <= 32 * MAX_WARPS;
    case BLOCK:
      return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
  }
  return false;
}

// f(integral_constant k) for k in 1..MAX_K
template <typename F>
cudaError_t with_k(int k, F f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Both launchers run on `stream`, never synchronise, and return
// cudaGetLastError() (0 on success). The plan (path: 0 one warp, 1 bands,
// 2 one block; k, threads a block, chunk, dynamic shared memory) comes from
// ops/ctc_dp.py `kernel_plan`, which sizes the one-warp and block paths'
// shared memory; the band path reads only the threads and sizes its own.
extern "C" int ctc_dp_fwd_launch(const void* logp, const void* lens, const void* llens,
                                 const void* allowed, void* alphas, void* loss, int B, int T,
                                 int S, int path, int k, int threads, int chunk, long long smem,
                                 void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || S <= 0 || smem < 0 || !plan_ok(path, S, k, threads, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(logp);
  const int* ln = static_cast<const int*>(lens);
  const int* ll = static_cast<const int*>(llens);
  const uint8_t* al = static_cast<const uint8_t*>(allowed);
  float* out = static_cast<float*>(alphas);
  float* ls = static_cast<float*>(loss);
  cudaError_t err = cudaSuccess;
  if (path == BLOCK) {
    err = allow_smem(ctc_fwd_block_kernel, smem);
    if (err == cudaSuccess)
      ctc_fwd_block_kernel<<<B, threads, smem, st>>>(lp, ln, ll, al, out, ls, T, S);
  } else if (path == BAND_PATH) {
    const size_t bytes = band_smem_bytes(threads / 32);
    err = allow_smem(ctc_fwd_band_kernel<BAND_K>, bytes);
    if (err == cudaSuccess)
      ctc_fwd_band_kernel<BAND_K><<<B, threads, bytes, st>>>(lp, ln, ll, al, out, ls, T, S);
  } else {
    err = with_k(k, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      cudaError_t e = allow_smem(ctc_fwd_warp_kernel<K>, smem);
      if (e == cudaSuccess)
        ctc_fwd_warp_kernel<K><<<B, 32, smem, st>>>(lp, ln, ll, al, out, ls, T, S, chunk);
      return e;
    });
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_dp_bwd_launch(const void* logp, const void* alphas, const void* lens,
                                 const void* llens, const void* allowed, const void* loss,
                                 const void* g, void* grad, int B, int T, int S, int path, int k,
                                 int threads, int chunk, long long smem, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || S <= 0 || smem < 0 || !plan_ok(path, S, k, threads, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(logp);
  const float* alph = static_cast<const float*>(alphas);
  const int* ln = static_cast<const int*>(lens);
  const int* ll = static_cast<const int*>(llens);
  const uint8_t* al = static_cast<const uint8_t*>(allowed);
  const float* ls = static_cast<const float*>(loss);
  const float* gg = static_cast<const float*>(g);
  float* out = static_cast<float*>(grad);
  cudaError_t err = cudaSuccess;
  if (path == BLOCK) {
    err = allow_smem(ctc_bwd_block_kernel, smem);
    if (err == cudaSuccess)
      ctc_bwd_block_kernel<<<B, threads, smem, st>>>(lp, alph, ln, ll, al, ls, gg, out, T, S);
  } else if (path == BAND_PATH) {
    const size_t bytes = band_smem_bytes(threads / 32);
    err = allow_smem(ctc_bwd_band_kernel<BAND_K>, bytes);
    if (err == cudaSuccess)
      ctc_bwd_band_kernel<BAND_K><<<B, threads, bytes, st>>>(lp, alph, ln, ll, al, ls, gg, out, T,
                                                             S);
  } else {
    err = with_k(k, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      cudaError_t e = allow_smem(ctc_bwd_warp_kernel<K>, smem);
      if (e == cudaSuccess)
        ctc_bwd_warp_kernel<K><<<B, 32, smem, st>>>(lp, alph, ln, ll, al, ls, gg, out, T, S,
                                                    chunk);
      return e;
    });
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ctc_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
