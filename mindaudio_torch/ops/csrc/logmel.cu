// Fused log-mel spectrogram for Hopper (sm_90a): framing, window*DFT on the
// tensor cores, power, mel projection and log in one kernel, the signal read
// once; neither the frame matrix nor the spectrum goes to device memory.
//
//   x     (B, T) float32   signal (not padded: the kernel reads zeros before
//                          sample 0 and from sample T on)
//   table (passes * k_pad / 8, 2, 208, 8) float32: the ring slots in the
//         order the kernel reads them, one per pass p and k8 step, each its
//         hi = tf32(w) tile then its lo = tf32(w - hi) tile, 208 rows of 8
//         in the 32-byte swizzle (row r's 16-byte halves swapped where
//         r & 4), where w (passes * 208, k_pad) has in row 208 p + 2 j + s
//         window[n] * (s ? sin : cos)(-2 pi n f / n_fft) at f = 104 p + j
//         (zeros past n_freq and past n_fft): the cos and sin of one
//         frequency are adjacent columns of the product
//   band  (4, n_mels) int32  first and one-past-last nonzero row of each mel
//         column, the offset of its weights in `wts`, and its column of the
//         carry tile where it spans two passes or more (else -1)
//   wts   (nnz,) float32   each mel column's nonzero rows, band after band
//   out   (B, n_frames, n_mels) float32 = log(max(power @ fb, log_floor))
//
// Frame i covers samples [i*hop - pad, i*hop - pad + n_fft) of x, with
// pad = n_fft/2 for centered framing and 0 otherwise. The wrapper
// (ops/logmel.py `kernel_plan`) chooses frames per block, span rows and
// pitch and ring depth, and refuses what does not fit; `logmel_smem_bytes`
// here is the layout it plans against.
//
// Replaces the Pallas TPU kernel mindaudio_tpu/ops/pallas_mel.py:96 `_kernel`
// (reached by `fused_logmel`, pallas_mel.py:165): the same function from the
// same host-built tables; the TPU kernel's lane-padded signal layout and its
// K shifted copies are not carried over.
//
// What bounds it on the H100: operations at the accuracy it is held to. One
// TF32 pass misses rtol = atol = 1e-3 at the one-bin mel bands of the HTK
// bank (cancellation in a small power), so both precisions take three passes,
// lo*hi + hi*lo + hi*hi with f32 accumulation (the operands split as
// x = tf32(x) + tf32(x - tf32(x))): at (128, 160000), n_fft 400, 3 x 4.12e10
// operations, 0.250 ms at the 495 TFLOP/s TF32 peak, against 0.037 ms of
// traffic. The design:
// - A tile is `fpb` = 128 frames of one row (two consumer warpgroups of 64
//   rows), or 64 where a longer frame does not leave room (n_fft 1024). One
//   persistent block per SM walks its tiles; it copies a tile's overlapping
//   span of signal to shared memory once (the next tile's while the last
//   power tile of this one is handed over), hop samples a row, rows `pitch`
//   words apart with pitch = 4 (mod 8) so that the 8 rows of an A fragment
//   fall in 8 distinct bank quads.
// - A (the frames) is Toeplitz, A[r, k] = x[r*hop + k], which no wgmma
//   shared-memory layout describes: each thread loads its m64k8 fragment
//   from the span, splits it into hi and lo in registers, and issues three
//   wgmma m64n208k8 tf32 (A from registers) into one f32 accumulator.
// - B (the split table) streams from L2 by one bulk copy a ring slot (13,312
//   bytes: a k8 slice of hi and lo, stored on the host in the order and the
//   32-byte swizzle wgmma reads; tensor-map boxes 32 bytes wide, one request
//   a row, streamed it markedly slower), issued by one producer thread
//   through full/empty mbarriers, as many slots ahead as shared memory holds
//   (3-8), without a break between tiles; the whole table is read from L2
//   once per tile.
// - A pass covers 104 frequencies (N = 208). Its power goes from the
//   accumulators (cos, sin of a frequency in one thread) to a shared tile,
//   which three more warps project onto the mel bands, over each band's
//   nonzero rows only, while the consumers run the next pass; a band that
//   ends in the pass stores its log, one that goes on keeps its partial sums
//   in a small carry tile, so shared memory does not grow with n_freq. Nothing
//   follows a block's last pass, so there every warp projects.
// Tried and dropped: sharing each slot between the two CTAs of a cluster by
// multicast (it took about twice as long).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int PASS_FREQ = 104;         // frequencies per pass
constexpr int PASS_N = 2 * PASS_FREQ;  // product columns per pass: cos, sin interleaved
constexpr int KSTEP = 8;               // K per ring slot: one wgmma k8 step
constexpr int K_ALIGN = 2 * KSTEP;     // k_pad multiple: the consumer loop takes 2 slots a turn
constexpr int POWER_PITCH = 108;       // power tile row pitch, words: 4 (mod 8), no conflicts
constexpr int TILE_BYTES = PASS_N * KSTEP * 4;  // a k8 slice of hi (or lo): 208 rows of 32 bytes
constexpr int SLOT_BYTES = 2 * TILE_BYTES;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;     // 227 KB per block
constexpr int ALIGN_SLACK = 1024;      // room to align the base
constexpr int ERR_PLAN = -1;           // launch code: a plan the kernel does not take

static_assert(TILE_BYTES % 256 == 0, "32-byte swizzle atoms are 256 bytes");

struct Params {
  const float* x;
  const float* table;
  const int* band;
  const float* wts;
  float* out;
  long long T;
  int tiles;  // B * blocks_per_row: (row, fpb frames) tiles
  int n_frames, blocks_per_row, hop, pad, n_mels, nnz, carries, passes, ksteps, fpb, rows, pitch,
      stages;
  float log_floor;
};

// shared memory layout (bytes from the 1024-aligned base): ring | span |
// power | carry | band | wts | full, empty barriers
struct Layout {
  int span, power, carry, band, wts, bars, total;
  __host__ __device__ Layout(int fpb, int rows, int pitch, int n_mels, int nnz, int carries,
                             int stages) {
    span = stages * SLOT_BYTES;
    power = span + rows * pitch * 4;
    carry = power + fpb * POWER_PITCH * 4;
    band = carry + fpb * carries * 4;
    wts = band + 4 * n_mels * 4;
    bars = (wts + nnz * 4 + 7) / 8 * 8;
    total = bars + 2 * stages * 8 + ALIGN_SLACK;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// named barriers between the consumers (which write the power tile) and the
// mel warps (which read it): POWER_FULL, the tile is written; POWER_EMPTY,
// it is read; one side arrives, the other waits, `count` is both sides.
// CONSUMERS: the consumer warpgroups alone, around the span's reuse.
constexpr int POWER_FULL = 1, POWER_EMPTY = 2, CONSUMERS = 3, MEL_THREADS = 96;
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// 4 bytes global -> shared without a register round trip; zeros where `n` is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
// `bytes` contiguous bytes from `src` -> shared memory at `dst`, completing
// the barrier at `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 32-byte swizzle: rows of 8
// tf32 (32 bytes), 8-row groups 256 bytes apart; the base is 256-aligned
__device__ __forceinline__ uint64_t sw32_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N product groups still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching the accumulators across the async product
__device__ __forceinline__ void fence_acc(float (&d)[PASS_N / 2]) {
#pragma unroll
  for (int i = 0; i < PASS_N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64x8, tf32 in registers: a[0] row g col t, a[1] row g+8 col t,
// a[2] row g col t+4, a[3] row g+8 col t+4) x B (8x208 from `db`)
__device__ __forceinline__ void wgmma_m64n208k8(float (&d)[PASS_N / 2], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38,"
      " %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64,"
      " %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77,"
      " %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90,"
      " %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103}, "
      "{%104, %105, %106, %107}, %108, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The mel projection of pass `pass` for the items it, it + stride, ... from
// `id`: item it is 8 frames from r0 = 8 (it / n_mels) and band
// m = it % n_mels (consecutive threads on consecutive bands, sharing each
// band's weights over 8 frames). A band that ends in this pass stores its
// log; one that goes on keeps its partial sums in the carry tile (one column
// for each band that spans two or more passes). The same items go to the
// same threads in every pass but the block's last (which all threads share,
// after a barrier), so a carry column is read back by the thread that wrote
// it or after that barrier.
__device__ __forceinline__ void project(const Params p, int pass, int id, int stride, int valid,
                                        const float* power, float* carry, const int* band,
                                        const float* wts, float* out) {
  const int n_mels = p.n_mels, items = p.fpb / 8 * n_mels;
  const int f0 = pass * PASS_FREQ, f1 = f0 + PASS_FREQ;
  int r0 = id / n_mels * 8, m = id - r0 / 8 * n_mels;
  const int dr = stride / n_mels * 8, dm = stride % n_mels;
  for (int it = id; it < items && r0 < valid; it += stride) {
    const int lo = band[m], hi = band[n_mels + m];
    // an empty band stores log(log_floor) in the first pass
    if (lo < hi ? hi > f0 && lo < f1 : pass == 0) {
      const float* pr = power + r0 * POWER_PITCH - f0;
      const float* wr = wts + band[2 * n_mels + m] - lo;
      float* cr = carry + r0 * p.carries + band[3 * n_mels + m];  // -1: no carry column
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = lo < f0 ? cr[r * p.carries] : 0.f;
      for (int f = max(lo, f0), fe = min(hi, f1); f < fe; ++f) {
        const float w = wr[f];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = fmaf(pr[r * POWER_PITCH + f], w, acc[r]);
      }
      if (hi <= f1) {
        float* orow = out + static_cast<size_t>(r0) * n_mels + m;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < valid) orow[r * n_mels] = __logf(fmaxf(acc[r], p.log_floor));
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) cr[r * p.carries] = acc[r];
      }
    }
    r0 += dr;
    m += dm;
    if (m >= n_mels) {
      m -= n_mels;
      r0 += 8;
    }
  }
}

// the span of signal of tile `tile` -> shared memory: sample s of the tile
// (frame0 * hop - pad + s) at row s / hop, column s % hop; zeros outside
// [0, T); a warp a row at a time, by `threads` threads from `tid`, every
// copy in flight before the wait (cp.async.wait_group by each thread)
__device__ __forceinline__ void copy_span(const Params p, uint32_t span_s, int tile, int tid,
                                          int threads) {
  const int b = tile / p.blocks_per_row, frame0 = (tile - b * p.blocks_per_row) * p.fpb;
  const float* xb = p.x + static_cast<size_t>(b) * p.T;
  const long long start = static_cast<long long>(frame0) * p.hop - p.pad;
  const int lane = tid % 32;
  for (int q = tid / 32; q < p.rows; q += threads / 32) {
    const long long q0 = start + static_cast<long long>(q) * p.hop;
    for (int c = lane; c < p.hop; c += 32) {
      const long long at = q0 + c;
      const bool in = at >= 0 && at < p.T;
      cp_async4(span_s + 4 * (q * p.pitch + c), in ? xb + at : xb, in ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile;
// this thread rows r = 16 warp + g and r + 8, columns t and t + 4 of each
// k8 step, and of each 8-column group c of the product the columns
// 8c + 2t, 8c + 2t + 1: the cos and sin of frequency 4c + t of the pass.
// Once the last pass of a tile has read the span, the consumers copy the
// next tile's span into it while they hand over the last power tile. After
// the block's last pass nothing is left to overlap, so they project it too.
__device__ __forceinline__ void consume_tiles(const Params p, uint32_t base_s, uint32_t span_s,
                                              const float* span, float* power, float* carry,
                                              const int* band, const float* wts,
                                              uint32_t full_s, uint32_t empty_s, int sides) {
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, consumers = p.fpb / 64 * 128;
  const int hop = p.hop, pitch = p.pitch, wrap = pitch - hop;
  const float* rowp = span + (wg * 64 + warp * 16 + g) * pitch;
  float* pw = power + wg * 64 * POWER_PITCH;
  float acc[PASS_N / 2];
  int slot = 0;
  uint32_t phase = 0;
  int k_off = t, k_rem = t;  // span offset and k % hop of this thread's column t

  // A fragment of the next k8 step, split into hi and lo; advances the column
  auto fragment = [&](uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int off4 = k_off + 4 + (k_rem + 4 >= hop ? wrap : 0);
    const float v[4] = {rowp[k_off], rowp[k_off + 8 * pitch], rowp[off4], rowp[off4 + 8 * pitch]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = tf32_rna(v[i]);
      lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
    }
    k_off += KSTEP;
    k_rem += KSTEP;
    if (k_rem >= hop) {  // hop >= 8: one wrap at most
      k_rem -= hop;
      k_off += wrap;
    }
  };
  // the products that read ring slot `i` are done: this warp's arrival
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty_s + 8 * i);
  };
  // one ring slot: its three products, then the slot before it released
  auto consume = [&](const uint32_t (&hi)[4], const uint32_t (&lo)[4], bool release_prev) {
    mbar_wait(full_s + 8 * slot, phase);
    const uint64_t db_hi = sw32_desc(base_s + slot * SLOT_BYTES);
    const uint64_t db_lo = sw32_desc(base_s + slot * SLOT_BYTES + TILE_BYTES);
    fence_acc(acc);
    wgmma_fence();
    wgmma_m64n208k8(acc, lo, db_hi);  // the small terms first
    wgmma_m64n208k8(acc, hi, db_lo);
    wgmma_m64n208k8(acc, hi, db_hi);
    wgmma_commit();
    wgmma_wait<1>();  // the slot before this one is read; this one runs on
    fence_acc(acc);
    if (release_prev) release(slot == 0 ? p.stages - 1 : slot - 1);
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  };

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    if (tile != static_cast<int>(blockIdx.x)) {  // this tile's span, copied during the last
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      named_sync(CONSUMERS, consumers);
    }
    for (int pass = 0; pass < p.passes; ++pass) {
#pragma unroll
      for (int i = 0; i < PASS_N / 2; ++i) acc[i] = 0.f;
      k_off = k_rem = t;
      // two register sets: a set is rewritten only after its products finished
      uint32_t hi0[4], lo0[4], hi1[4], lo1[4];
      for (int ks = 0; ks < p.ksteps; ks += 2) {
        fragment(hi0, lo0);
        consume(hi0, lo0, ks > 0);
        fragment(hi1, lo1);
        consume(hi1, lo1, true);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(slot == 0 ? p.stages - 1 : slot - 1);
      if (pass == p.passes - 1 && tile + static_cast<int>(gridDim.x) < p.tiles) {
        named_sync(CONSUMERS, consumers);  // both warpgroups are done with the span
        copy_span(p, span_s, tile + gridDim.x, threadIdx.x, consumers);
      }

      // power of this pass's 104 frequencies -> the warpgroup's rows of the tile
      if (pass > 0 || tile != static_cast<int>(blockIdx.x))
        named_sync(POWER_EMPTY, sides);  // the mel warps have read the last one
#pragma unroll
      for (int c = 0; c < PASS_N / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = acc[4 * c + 2 * h], im = acc[4 * c + 2 * h + 1];
          pw[(warp * 16 + g + 8 * h) * POWER_PITCH + 4 * c + t] = re * re + im * im;
        }
      if (pass < p.passes - 1 || tile + static_cast<int>(gridDim.x) < p.tiles) {
        named_arrive(POWER_FULL, sides);
      } else {  // the block's last pass: every thread but the producer's warp projects
        const int b = tile / p.blocks_per_row, frame0 = (tile - b * p.blocks_per_row) * p.fpb;
        named_sync(POWER_FULL, sides);
        project(p, pass, MEL_THREADS + threadIdx.x, sides, p.n_frames - frame0, power, carry,
                band, wts, p.out + (static_cast<size_t>(b) * p.n_frames + frame0) * p.n_mels);
      }
    }
  }
}

// Warp-specialized and persistent: a block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (a tile is `fpb` frames of one row).
// Warpgroups 0 .. fpb/64 - 1 consume (A fragments, the products, the power
// tile, the next tile's span); in the last warpgroup, the first thread keeps
// the ring of table slices full by bulk copies across tiles, and warps 1-3
// project each pass's power tile onto the mel bands while the consumers run
// the next pass. Per ring slot two mbarriers: `full` (the slot's copy
// landed), `empty` (the products that read the slot are done: one arrival
// per consumer warp).
__global__ void __launch_bounds__(384, 1) logmel_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base_s = (raw_s + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base_s - raw_s);
  const Layout lay(p.fpb, p.rows, p.pitch, p.n_mels, p.nnz, p.carries, p.stages);
  float* power = reinterpret_cast<float*>(smem + lay.power);
  float* carry = reinterpret_cast<float*>(smem + lay.carry);
  int* band = reinterpret_cast<int*>(smem + lay.band);
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  const uint32_t full_s = base_s + lay.bars, empty_s = full_s + 8 * p.stages;
  const uint32_t span_s = base_s + lay.span;

  const int wgs = p.fpb / 64;  // consumer warpgroups
  const int steps = p.passes * p.ksteps;  // ring slots a tile
  const int tiles = (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's
  // the producer's load of step s: K slice of a tile's step s % steps; the
  // table holds a tile's slots in that order, each hi then lo, contiguous
  auto issue = [&](int s) {
    const uint32_t bar = full_s + 8 * (s % p.stages);
    mbar_arrive_expect_tx(bar, SLOT_BYTES);
    bulk_load(base_s + (s % p.stages) * SLOT_BYTES,
              p.table + static_cast<size_t>(s % steps) * (SLOT_BYTES / 4), SLOT_BYTES, bar);
  };
  const int producer = wgs * 128;  // the thread that issues every load
  if (threadIdx.x == producer) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full_s + 8 * i, 1);
      mbar_init(empty_s + 8 * i, wgs * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < min(p.stages, tiles * steps); ++s) issue(s);  // before the span copy
  }
  copy_span(p, span_s, blockIdx.x, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < 4 * p.n_mels; i += blockDim.x) band[i] = __ldg(p.band + i);
  for (int i = threadIdx.x; i < p.nnz; i += blockDim.x) wts[i] = __ldg(p.wts + i);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int sides = wgs * 128 + MEL_THREADS;  // threads on the power tile's barriers

  if (threadIdx.x == producer) {
    for (int s = p.stages; s < tiles * steps; ++s) {
      mbar_wait(empty_s + 8 * (s % p.stages), ((s / p.stages) - 1) & 1);
      issue(s);
    }
  } else if (threadIdx.x >= producer + 32) {  // the mel warps
    const int id = threadIdx.x - producer - 32;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int b = tile / p.blocks_per_row, frame0 = (tile - b * p.blocks_per_row) * p.fpb;
      float* out = p.out + (static_cast<size_t>(b) * p.n_frames + frame0) * p.n_mels;
      for (int pass = 0; pass < p.passes; ++pass) {
        const bool last = pass == p.passes - 1 && tile + static_cast<int>(gridDim.x) >= p.tiles;
        named_sync(POWER_FULL, sides);
        project(p, pass, id, last ? sides : MEL_THREADS, p.n_frames - frame0, power, carry, band,
                wts, out);
        if (!last) named_arrive(POWER_EMPTY, sides);
      }
    }
  } else if (threadIdx.x < producer) {
    consume_tiles(p, base_s, span_s, reinterpret_cast<const float*>(smem + lay.span), power,
                  carry, band, wts, full_s, empty_s, sides);
  }
}

}  // namespace

// Dynamic shared memory a launch with this plan asks for, in bytes.
extern "C" int logmel_smem_bytes(int fpb, int rows, int pitch, int n_mels, int nnz, int carries,
                                 int stages) {
  return Layout(fpb, rows, pitch, n_mels, nnz, carries, stages).total;
}

// {PASS_FREQ, K_ALIGN, POWER_PITCH, SLOT_BYTES, MAX_STAGES, SMEM_LIMIT}, which
// the wrapper's plan assumes
extern "C" void logmel_constants(int* out) {
  out[0] = PASS_FREQ;
  out[1] = K_ALIGN;
  out[2] = POWER_PITCH;
  out[3] = SLOT_BYTES;
  out[4] = MAX_STAGES;
  out[5] = SMEM_LIMIT;
}

// Launches on `stream`, never synchronises, returns cudaGetLastError() (0 on
// success), or ERR_PLAN for a plan the kernel does not take.
extern "C" int logmel_launch(const void* x, const void* table, const void* band, const void* wts,
                             void* out, int B, long long T, int n_frames, int hop, int pad,
                             int n_mels, int nnz, int carries, int passes, int k_pad, int fpb,
                             int rows, int pitch, int stages, float log_floor, int sms,
                             void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  if (sms <= 0) return ERR_PLAN;
  const int smem = Layout(fpb, rows, pitch, n_mels, nnz, carries, stages).total;
  if ((fpb != 64 && fpb != 128) || hop < KSTEP || pitch < hop || pitch % 8 != 4 ||
      n_mels <= 0 || nnz < 0 || carries < 0 || passes <= 0 || k_pad <= 0 || k_pad % K_ALIGN != 0 ||
      stages < 2 || stages > MAX_STAGES || static_cast<long long>(rows) * hop <
      static_cast<long long>(fpb - 1) * hop + k_pad || smem > SMEM_LIMIT)
    return ERR_PLAN;
  const int blocks_per_row = (n_frames + fpb - 1) / fpb;
  if (static_cast<long long>(B) * blocks_per_row >= 2147483647LL) return ERR_PLAN;
  const int blocks = B * blocks_per_row;

  static bool configured = false;  // above 48 KB only after opting in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.table = static_cast<const float*>(table);
  p.band = static_cast<const int*>(band);
  p.wts = static_cast<const float*>(wts);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.n_frames = n_frames; p.blocks_per_row = blocks_per_row; p.hop = hop; p.pad = pad;
  p.n_mels = n_mels; p.nnz = nnz; p.carries = carries; p.passes = passes;
  p.ksteps = k_pad / KSTEP; p.fpb = fpb; p.rows = rows; p.pitch = pitch; p.stages = stages;
  p.log_floor = log_floor;
  p.tiles = blocks;
  logmel_kernel<<<static_cast<unsigned>(std::min(blocks, sms)), (fpb / 64 + 1) * 128, smem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* logmel_error_string(int code) {
  if (code == ERR_PLAN) return "a launch plan the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
