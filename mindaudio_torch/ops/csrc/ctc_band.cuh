// The CTC band path's layout and edge exchange: what ctc_dp.cu's band kernels
// and ctc_probe.cu's rung (e) share, so that the probe times the kernels' own
// protocol and both size their shared memory by one formula.
//
// A sequence of S states takes ceil(S / BAND) warps, warp w holding the band
// [w * BAND, w * BAND + BAND) as BAND_K registers a lane. The forward passes
// each step's two top states of a band up to the band above, the backward the
// two bottom ones down: one 64-bit word an edge state and step, the value's
// bits low and the step high (never-written words carry step -1), in a ring
// of EDGE_RING steps in shared memory. Every lane stores a word every step,
// branch-free: the two edge lanes into the ring, the others into a dump word
// of their own. The last step of a group of GROUP steps stores with release
// semantics, and the reader waits once a group, with acquire loads, until
// both words of the group's last step carry that step: every word of the
// group is then visible, and the reader's steps load them without a check or
// a branch. Before a group overwrites a step that its reader may not have
// read, the writer waits until the reader has published (a count in shared
// memory, every EDGE_HALF steps) that it has.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BAND_K = 2;  // registers per lane on the band path
constexpr int BAND = 32 * BAND_K;  // states a band (a warp) holds
constexpr int MAX_WARPS = 16;  // warps a block on the band path: S <= BAND * MAX_WARPS
constexpr int GROUP = 4;  // steps between two waits for a neighbour's edges
constexpr int EDGE_RING = 64;  // steps an edge ring holds
constexpr int EDGE_HALF = EDGE_RING / 2;  // a reader publishes its count every half
static_assert(EDGE_HALF % GROUP == 0, "a group never straddles a half of the ring");

// shared memory of a band block of `warps` warps, a warp's: its edge ring
// (EDGE_RING steps of two words), a dump word a lane, and a read count
constexpr size_t band_smem_bytes(int warps) {
  return (size_t)warps * ((EDGE_RING * 2 + 32) * 8 + 4);
}
static_assert(band_smem_bytes(1) >= 4 * BAND, "the forward's last row fits over the rings");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long edge_word(float v, int step) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(step)) << 32) |
         __float_as_uint(v);
}

template <bool RELEASE>
__device__ __forceinline__ void put_edge(unsigned at, unsigned long long word) {
  if (RELEASE)
    asm volatile("st.release.cta.shared.u64 [%0], %1;" ::"r"(at), "l"(word) : "memory");
  else
    asm volatile("st.shared.u64 [%0], %1;" ::"r"(at), "l"(word) : "memory");
}

// the pair at `at` (two words), loaded plainly after the group's wait
__device__ __forceinline__ void get_edges(unsigned at, float& lo, float& hi) {
  unsigned long long x, y;
  asm volatile("ld.shared.u64 %0, [%2];\n\tld.shared.u64 %1, [%2+8];"
               : "=l"(x), "=l"(y) : "r"(at) : "memory");
  lo = __uint_as_float(static_cast<unsigned>(x));
  hi = __uint_as_float(static_cast<unsigned>(y));
}

// spin until both words of the pair at `at` carry `step`
__device__ __forceinline__ void wait_edges(unsigned at, int step) {
  unsigned long long x, y;
  do {
    asm volatile("ld.acquire.cta.shared.u64 %0, [%2];\n\tld.acquire.cta.shared.u64 %1, [%2+8];"
                 : "=l"(x), "=l"(y) : "r"(at) : "memory");
  } while (static_cast<int>(x >> 32) != step || static_cast<int>(y >> 32) != step);
}

// the reader of a band's edges publishes, once a half of the ring, how many
// steps it has read (after a __syncwarp(): every lane's loads are done); the
// writer waits on it before it overwrites a step the reader may not have read
__device__ __forceinline__ void publish_read(unsigned at, int steps) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(at), "r"(steps) : "memory");
}

__device__ __forceinline__ void wait_read(unsigned at, int steps) {
  int seen;
  do {
    asm volatile("ld.acquire.cta.shared.u32 %0, [%1];" : "=r"(seen) : "r"(at) : "memory");
  } while (seen < steps);
}

// The edge rings of a band block, set up by every thread before the
// caller's __syncthreads(): every word step -1, every count 0. A band that
// writes for a neighbour stores from `lane_a` (the pair's first word) and
// `lane_b`; its other lanes, and a band with no neighbour to write for,
// store into their dump words. A band with no neighbour to read from loads
// from its dump and ignores what it loads. The writer of step i overwrites
// step i - EDGE_RING, so it first waits (`need`) until its reader has read
// that far; `seen` keeps the last count it read.
struct BandEdges {
  unsigned put, get;  // shared addresses of this lane's word and of the pair it loads, at step 0
  int put_stride, get_stride;  // bytes a step
  unsigned reads_mine, reads_reader;  // the read counts: this band's, and its reader's
  bool reads, writes;  // a band to read from, to write for
  int seen;

  __device__ __forceinline__ void need(int steps) {
    if (writes && seen < steps) {
      wait_read(reads_reader, steps);
      seen = steps;
    }
  }
  // the word this lane writes at step i, with release on a group's last
  template <bool RELEASE>
  __device__ __forceinline__ void put_at(int i, float v) {
    put_edge<RELEASE>(put + put_stride * (i & (EDGE_RING - 1)), edge_word(v, i));
  }
  __device__ __forceinline__ void get_at(int i, float& lo, float& hi) {
    get_edges(get + get_stride * (i & (EDGE_RING - 1)), lo, hi);
  }
  // before the steps [g0, g1): room for them, and their pairs from the source
  __device__ __forceinline__ void open_group(int g0, int g1) {
    need(g1 - EDGE_RING);
    if (reads) wait_edges(get + get_stride * ((g1 - 1) & (EDGE_RING - 1)), g1 - 1);
  }
  // after the steps [g0, g1): every lane's loads are done; publish a half
  __device__ __forceinline__ void close_group(int g0, int g1, int lane) {
    if (g0 / EDGE_HALF != g1 / EDGE_HALF) {
      __syncwarp();
      if (reads && lane == 0) publish_read(reads_mine, g1);
    }
  }
};

__device__ __forceinline__ BandEdges band_edges(int warps, int lane, int w, int source,
                                                int reader, int lane_a, int lane_b) {
  extern __shared__ __align__(16) unsigned long long band_smem[];
  unsigned long long* edges = band_smem;
  unsigned long long* dumps = edges + (size_t)warps * EDGE_RING * 2;
  int* counts = reinterpret_cast<int*>(dumps + 32 * warps);
  for (int i = threadIdx.x; i < warps * (EDGE_RING * 2 + 32); i += blockDim.x) edges[i] = ~0ull;
  for (int i = threadIdx.x; i < warps; i += blockDim.x) counts[i] = 0;
  BandEdges e;
  const bool mine = reader >= 0 && (lane == lane_a || lane == lane_b);
  e.put = smem_addr(mine ? edges + (size_t)w * EDGE_RING * 2 + (lane == lane_a ? 0 : 1)
                         : dumps + 32 * w + lane);
  e.put_stride = mine ? 16 : 0;
  e.get = smem_addr(source >= 0 ? edges + (size_t)source * EDGE_RING * 2 : dumps + 32 * w);
  e.get_stride = source >= 0 ? 16 : 0;
  e.reads_mine = smem_addr(counts + w);
  e.reads_reader = smem_addr(counts + max(reader, 0));
  e.reads = source >= 0;
  e.writes = reader >= 0;
  e.seen = 0;
  return e;
}

}  // namespace
