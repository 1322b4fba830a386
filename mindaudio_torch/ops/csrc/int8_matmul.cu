// Weight-only int8 GEMM for Hopper (sm_90a):
//
//     y = bf16(x) @ bf16( bf16(w_int8) * bf16(scale) )     (f32 accumulation)
//
// x (M, K) float32 or bf16, rows `ldx` elements apart; w (K, N) int8, rows
// `ldw` bytes apart (the JAX (K, N) layout, optionally padded in N); scale
// (N,) float32 per output channel; y (M, N) in x's dtype.
//
// Replaces the Pallas TPU kernel mindaudio_tpu/ops/quant.py:60
// `_int8_matmul_kernel` (reached by `int8_matmul`, quant.py:131). It
// computes the same function: the scale and the dequantized product are
// both rounded to bf16 (quant.py:71-72), products accumulate in f32, and the
// store narrows to x's dtype (quant.py:165-166). Bias stays outside.
//
// What bounds it on the H100: every serving shape is memory-bound. At the
// encoder FFN (M=4096, K=256, N=2048, bf16) the least traffic is 2 MB of x +
// 0.5 MB of int8 w + 16.8 MB of y ~= 19.4 MB, 5.8 us at 3.35 TB/s, against
// 4.3 GFLOP = 4.3 us at 989 TFLOP/s. In practice what binds is the work a
// block chains behind each load (dequantization, products, epilogue), the
// bytes each block reads (x again for every N tile, the int8 slice again
// for every M tile), and at the small shapes the latency of a short walk.
//
// The design:
// - Output tile 128x128. Two consumer warpgroups of 64 rows each run wgmma
//   m64n128k16 (bf16 in, f32 accumulators in registers) on operands in
//   shared memory, one product group kept in flight. Both operands are
//   K-major with the 128-byte swizzle: the dequantizing threads write w
//   transposed (n rows of 64 k), so A and B share one descriptor form and no
//   transpose bit is needed.
// - Two producer warpgroups fill a ring of 4 slots of 64-deep K slices by
//   TMA (x as bf16, the int8 w slice; zeros past the edges), 3 slices ahead,
//   and dequantize slice it + 1 while the consumers multiply slice it.
//   mbarriers per slot: full (TMA landed), ready (dequantized), empty
//   (products done). The float32 x path, and an x or w that TMA cannot
//   address (not 16-byte aligned), take plain loads into the same ring,
//   converted to bf16 on the way in.
// - Dequantization uses no int-to-float conversion (quarter rate): a byte
//   permute makes 2^23 + (q + 128) exactly, one subtraction gives q, and one
//   bf16x2 multiply by (bf16(scale), bf16(scale)) rounds once, which is the
//   TPU kernel's rounding.
// - A block walks a contiguous run of output tiles ordered N tile first, M
//   tile innermost (the TPU kernel's grid order), counting rather than
//   dividing. Where K <= 256 the whole dequantized 256x128 bf16 weight slice
//   stays resident and is dequantized once per N tile of the run, not once
//   per M tile; where K is longer each 64x128 slice is dequantized once per
//   K stage for both warpgroups' 64-row tiles.
// - The epilogue narrows to bf16 in shared memory and writes the tile with
//   two TMA stores, which clip the edges; y is written once, at its true
//   width. Where a row of y is not a multiple of 16 bytes (N = 4233) TMA
//   cannot address it: the tile goes out as the 16-byte-aligned chunks of
//   each row, consecutive threads on consecutive chunks, plus at most 7
//   single elements at each end. f32 outputs are stored from the registers,
//   a quad of lanes on a 32-byte sector.
// - Split-K where there are fewer tiles than SMs and K is long (the wrapper
//   chooses the split, quant.py `split_k`): each split writes f32 partial
//   tiles to a workspace the wrapper allocates, and a second kernel,
//   `splitk_reduce_kernel`, sums the splits in a fixed order and narrows
//   (the wrapper counts its launches apart). No atomics: the result does
//   not change from run to run.
// Rows, columns and K are masked, so any M, N and K work.

#include <cuda.h>  // CUtensorMap and its enums only; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int BM = 128;    // output rows per tile (two warpgroups of 64)
constexpr int BN = 128;    // output columns per tile
constexpr int BK = 64;     // K per stage: four wgmma k16 steps, one 128-byte row
constexpr int STAGES = 4;  // ring depth of x and int8 w slices: loads run 3 ahead
constexpr int NB = 4;      // bf16 weight buffers: the resident slice (K <= 256) or one per slot
constexpr int RESIDENT_KT = NB;
constexpr int THREADS = 256;  // per role: two consumer and two producer warpgroups

constexpr int A_BYTES = BM * BK * 2;        // one x slice, bf16
constexpr int B_BYTES = BN * BK * 2;        // one dequantized w slice, bf16, transposed
constexpr int Q_BYTES = BK * BN;            // one int8 w slice
constexpr int R_BYTES = A_BYTES + Q_BYTES;  // one ring slot: x slice, then int8 slice
constexpr int C_LD = BN + 8;  // ragged-N output tile row pitch, bf16: 272 bytes, no bank conflicts
constexpr int OFF_B = 0;
constexpr int OFF_R = OFF_B + NB * B_BYTES;
constexpr int OFF_C = OFF_R + STAGES * R_BYTES;   // the bf16 output tile
constexpr int OFF_BAR = OFF_C + BM * C_LD * 2;    // full, ready, empty: one each per slot
constexpr int SMEM_BYTES = OFF_BAR + 3 * 8 * STAGES;
constexpr int SMEM_ALLOC = SMEM_BYTES + 1024;     // room to align the base to 1024
constexpr int ERR_TMA_ENCODE = -1;  // launch code: a TMA descriptor could not be encoded

static_assert(R_BYTES % 1024 == 0 && OFF_C % 1024 == 0 && SMEM_ALLOC <= 232448,
              "swizzled tiles need 1024-byte alignment; 227 KB per block at most");

struct Params {
  const void* x;
  const int8_t* w;
  const float* s;
  void* y;
  float* ws;  // split-K partial tiles (splits, M, ldws), or null
  int M, N, K, ldx, ldw, ldy, ldws;
  int m_tiles, tiles, kt;  // tiles = m_tiles * n_tiles; kt = K stages
  int x_tma, w_tma, y_tma, y_vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// the two consumer warpgroups only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
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
// a 2-D box of `tmap` at (c0 innermost, c1) -> shared memory, completing `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tmap, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* tmap, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::
                   "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the stores have read shared memory
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma descriptor of a K-major operand: rows of 64 bf16 (128 bytes), 8-row
// groups 1024 bytes apart, 128-byte swizzle (16-byte chunk c of row r stored
// at chunk c ^ (r % 8), as TMA's CU_TENSOR_MAP_SWIZZLE_128B lays it); the
// base is 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
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
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// 8 elements of x from `src` (those at e < left, on a valid row) as bf16
__device__ __forceinline__ uint4 load8_bf16(const float* src, bool row_ok, int left) {
  float v[8];
  if (row_ok && left >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (row_ok && e < left) ? src[e] : 0.f;
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src, bool row_ok, int left) {
  if (row_ok && left >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(src));
  uint16_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (row_ok && e < left) ? __bfloat16_as_ushort(src[e]) : static_cast<uint16_t>(0);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = v[2 * i] | (static_cast<uint32_t>(v[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x rows m0.., K columns k0..k0+63 -> A slot by plain loads (bf16, 128 rows,
// 128-byte swizzle): the float32 path and an x that TMA cannot address
template <typename T>
__device__ __forceinline__ void load_x_plain(const Params& p, uint8_t* a, int m0, int k0,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int q = tid + THREADS * i, r = q >> 3, c = q & 7;
    const int gm = m0 + r, gk = k0 + 8 * c;
    const T* src = static_cast<const T*>(p.x) + static_cast<size_t>(gm) * p.ldx + gk;
    *reinterpret_cast<uint4*>(a + r * 128 + ((c ^ (r & 7)) << 4)) =
        load8_bf16(src, gm < p.M, p.K - gk);
  }
}

// int8 w rows k0..k0+63, columns n0..n0+127 -> Q slot by plain loads, in the
// layout TMA gives (128-byte swizzle): a w that TMA cannot address
__device__ __forceinline__ void load_w_plain(const Params& p, uint8_t* q, int k0, int n0,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
    const int qi = tid + THREADS * i, r = qi >> 3, c = qi & 7;
    const int gk = k0 + r, gn = n0 + 16 * c;
    const int8_t* src = p.w + static_cast<size_t>(gk) * p.ldw + gn;
    __align__(16) int8_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = (gk < p.K && gn + e < p.N) ? src[e] : int8_t(0);
    *reinterpret_cast<uint4*>(q + r * 128 + ((c ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// (bf16(scale), bf16(scale)) of this thread's columns n0 + 4 * lane + j
__device__ __forceinline__ void load_scales(const Params& p, uint32_t (&sc)[4], int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + 4 * lane + j;
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(gn < p.N ? __ldg(p.s + gn) : 0.f));
    sc[j] = b | (b << 16);
  }
}

// Q slot (64 k x 128 n int8, 128-byte swizzle) -> B buffer (128 n x 64 k
// bf16, K-major, 128-byte swizzle). Warp w takes k rows 8w..8w+7, lane l the
// columns 4l..4l+3: it reads one word from each of the 8 rows (a warp reads
// whole rows) and writes four 16-byte chunks, lane pairs rotated through the
// four columns so that 8 lanes write 8 distinct banks. Each int8 becomes an
// exact float by a byte permute into 2^23 + (q + 128) and one subtraction
// (no int-to-float conversion, which runs at a quarter of the rate), two of
// them an exact bf16 pair; then one bf16x2 multiply by the scale rounds once.
// That is the TPU kernel's rounding: bf16(scale), then the exact product
// q * bf16(scale) rounded to bf16.
__device__ __forceinline__ void dequant(const uint8_t* q, uint8_t* bt, const uint32_t (&sc)[4],
                                        int tid) {
  const int kc = tid >> 5, lane = tid & 31;
  uint32_t wv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    wv[r] = *reinterpret_cast<const uint32_t*>(q + (8 * kc + r) * 128 + (((lane >> 2) ^ r) << 4) +
                                               (lane & 3) * 4) ^
            0x80808080u;  // each byte q + 128
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jj = (j + (lane >> 1)) & 3;  // this step's column of the four
    const uint32_t s2 = jj == 0 ? sc[0] : jj == 1 ? sc[1] : jj == 2 ? sc[2] : sc[3];
    const uint32_t sel = 0x7440u | jj;     // byte jj, then 0x00, 0x00, 0x4B
    uint32_t out[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float lo = __uint_as_float(__byte_perm(wv[2 * h], 0x4B000000u, sel)) - 8388736.f;
      const float hi = __uint_as_float(__byte_perm(wv[2 * h + 1], 0x4B000000u, sel)) - 8388736.f;
      const __nv_bfloat162 v =
          __hmul2(__floats2bfloat162_rn(lo, hi), *reinterpret_cast<const __nv_bfloat162*>(&s2));
      out[h] = *reinterpret_cast<const uint32_t*>(&v);
    }
    const int n = 4 * lane + jj;
    *reinterpret_cast<uint4*>(bt + n * 128 + ((kc ^ (n & 7)) << 4)) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

__device__ __forceinline__ float cvt_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 cvt_out(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// The epilogue. A thread holds rows r0 and r0 + 8 of its warpgroup's 64, and
// of each 8-column group c the columns 8c + 2 * (lane % 4) + {0, 1}:
// acc[4c + 2h + {0, 1}] is row r0 + 8h. `dst` points at the tile's (0, 0).

// f32 (the float32 path, and split-K partial tiles): pairs as 8-byte stores,
// a quad of lanes on one 32-byte sector; single stores where pairs are not
// 8-byte aligned
__device__ __forceinline__ void store_acc_f32(const float (&acc)[64], float* dst, int ld, int r0,
                                              int rows, int cols, bool pairs, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = 8 * c + 2 * (lane & 3);
      float* out = dst + static_cast<size_t>(r) * ld + col;
      if (pairs && col < cols) {  // cols is even or ld pads the row
        *reinterpret_cast<float2*>(out) = make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      } else {
        if (col < cols) out[0] = acc[4 * c + 2 * h];
        if (col + 1 < cols) out[1] = acc[4 * c + 2 * h + 1];
      }
    }
  }
}

// bf16 rows TMA can address: the tile narrowed into shared memory as two
// 128x64 halves in TMA's 128-byte swizzle (the 8 rows of a warp's store on
// 8 distinct chunks), then two TMA stores, which clip the edges
__device__ __forceinline__ void store_acc_bf16_tma(const float (&acc)[64], uint8_t* cbuf,
                                                   uint32_t cbuf_s, const CUtensorMap* tmap,
                                                   int m0, int n0, int N, int r0, int tid) {
  const int lane = tid & 31;
  if (tid == 0) bulk_wait_read();  // the last tile's stores have read the buffer
  consumer_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
      *reinterpret_cast<uint32_t*>(cbuf + (c / 8) * (BM * 128) + r * 128 +
                                   (((c % 8) ^ (r & 7)) << 4) + (lane & 3) * 4) =
          pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
  fence_proxy_async();  // generic writes -> the TMA engine's reads
  consumer_sync();
  if (tid == 0) {
    tma_store(tmap, cbuf_s, n0, m0);
    if (n0 + BN / 2 < N) tma_store(tmap, cbuf_s + BM * 128, n0 + BN / 2, m0);
    bulk_commit();
  }
}

// bf16 rows that are not (N = 4233: 8466 bytes): the tile goes through shared
// memory, then each row is written as the 16-byte-aligned chunks that lie
// inside it (consecutive threads on consecutive chunks) plus at most 7
// single elements at each end
__device__ __forceinline__ void store_acc_bf16_ragged(const float (&acc)[64], uint8_t* cbuf,
                                                      __nv_bfloat16* dst, int ld, int r0, int rows,
                                                      int cols, int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
      *reinterpret_cast<uint32_t*>(cbuf + ((r0 + 8 * h) * C_LD + 8 * c + 2 * (lane & 3)) * 2) =
          pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  consumer_sync();
  const uint16_t* cs = reinterpret_cast<const uint16_t*>(cbuf);
  for (int q = tid; q < BM * (BN / 8); q += THREADS) {
    const int r = q / (BN / 8), ch = q % (BN / 8);
    if (r >= rows) continue;
    __nv_bfloat16* row = dst + static_cast<size_t>(r) * ld;
    const int head = min(cols, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                                                15) / 2);
    const int chunks = (cols - head) / 8, tail = head + 8 * chunks;
    const uint16_t* src = cs + r * C_LD;
    if (ch < chunks) {
      const int c0 = head + 8 * ch;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = src[c0 + 2 * i] | (static_cast<uint32_t>(src[c0 + 2 * i + 1]) << 16);
      *reinterpret_cast<uint4*>(row + c0) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    // lane ch of the row also writes head element ch and tail element ch - 8
    const int col = ch < 8 ? ch : tail + ch - 8;
    if (ch < 8 ? col < head : col < cols) row[col] = __ushort_as_bfloat16(src[col]);
  }
}

// A step of a block's walk: iteration `it`, K stage kk of tile (mt, nt);
// `first` on the run's first tile. Advanced by counting, not by dividing.
struct Walk {
  int it, kk, mt, nt;
  bool first;
  __device__ __forceinline__ void next(int m_tiles, int kb, int ke) {
    ++it;
    if (++kk == ke) {
      kk = kb;
      first = false;
      if (++mt == m_tiles) {
        mt = 0;
        ++nt;
      }
    }
  }
};

// Warp-specialized: warpgroups 0 and 1 consume (products, epilogue),
// warpgroups 2 and 3 produce (TMA or plain loads, dequantization). Per ring
// slot three mbarriers: `full` (the TMA copies landed), `ready` (the slot's
// weight slice is dequantized, plain loads written), `empty` (the products
// that read the slot are done). The producers dequantize slice it + 1 while
// the consumers multiply slice it, and keep the loads 3 slices ahead.
template <typename T>
__global__ void __launch_bounds__(2 * THREADS, 1)
int8_matmul_kernel(const Params p, const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_y) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base_s = (raw_s + 1023u) & ~1023u;  // 128-byte swizzle atoms are 1024-aligned
  uint8_t* smem = smem_raw + (base_s - raw_s);
  const uint32_t full_s = base_s + OFF_BAR, ready_s = full_s + 8 * STAGES,
                 empty_s = ready_s + 8 * STAGES;

  // this block's run of tiles (N tile outer, M tile inner) and K range
  const int G = gridDim.x, splits = gridDim.y, split = blockIdx.y;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * p.tiles / G);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.tiles / G);
  const int kb = static_cast<int>(static_cast<long long>(split) * p.kt / splits);
  const int ke = static_cast<int>(static_cast<long long>(split + 1) * p.kt / splits);
  const int iters = (t1 - t0) * (ke - kb);
  // K <= 256 (and more than one stage): the dequantized slice stays resident
  const bool resident = p.kt >= 2 && p.kt <= RESIDENT_KT;
  const Walk start = {0, kb, t0 % p.m_tiles, t0 / p.m_tiles, true};
  // the weight buffer of a step: its K stage's where resident, else its slot's
  auto bslot = [&](const Walk& w) { return resident ? w.kk : w.it % STAGES; };
  // resident: dequantize on the first tile of each N tile of the run only
  auto needs_dequant = [&](const Walk& w) { return !resident || w.first || w.mt == 0; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_s + 8 * i, 1);
      mbar_init(ready_s + 8 * i, THREADS);
      mbar_init(empty_s + 8 * i, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {  // producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n");
    const int tid = threadIdx.x - THREADS, lane = tid & 31;
    // the loads of step `w` into its slot: TMA by thread 0 (one arrival on
    // `full` with the bytes to expect), plain loads by every thread
    auto issue = [&](const Walk& w) {
      const int slot = w.it % STAGES, m0 = w.mt * BM, n0 = w.nt * BN;
      const int off = OFF_R + slot * R_BYTES;
      const bool dq = needs_dequant(w);
      if (!p.x_tma) load_x_plain<T>(p, smem + off, m0, w.kk * BK, tid);
      if (dq && !p.w_tma) load_w_plain(p, smem + off + A_BYTES, w.kk * BK, n0, tid);
      if (tid == 0) {
        const uint32_t bar = full_s + 8 * slot;
        mbar_arrive_expect_tx(bar, (p.x_tma ? A_BYTES : 0) + (dq && p.w_tma ? Q_BYTES : 0));
        if (p.x_tma) tma_load(base_s + off, &tm_x, w.kk * BK, m0, bar);
        if (dq && p.w_tma) tma_load(base_s + off + A_BYTES, &tm_w, n0, w.kk * BK, bar);
      }
    };
    uint32_t sc[4];  // bf16x2(scale) of this thread's 4 columns of N tile sc_nt
    int sc_nt = -1;
    Walk ahead = start;  // the next step to load
    for (; ahead.it < min(iters, STAGES - 1); ahead.next(p.m_tiles, kb, ke)) issue(ahead);
    for (Walk w = start; w.it < iters; w.next(p.m_tiles, kb, ke)) {
      const int slot = w.it % STAGES;
      if (needs_dequant(w)) {
        mbar_wait(full_s + 8 * slot, (w.it / STAGES) & 1);
        if (resident && w.it > 0 && w.kk == kb)  // the last N tile's products are done
          mbar_wait(empty_s + 8 * ((w.it - 1) % STAGES), ((w.it - 1) / STAGES) & 1);
        if (w.nt != sc_nt) {
          load_scales(p, sc, w.nt * BN, lane);
          sc_nt = w.nt;
        }
        dequant(smem + OFF_R + slot * R_BYTES + A_BYTES, smem + OFF_B + bslot(w) * B_BYTES, sc,
                tid);
      }
      fence_proxy_async();  // generic-proxy writes (dequant, plain loads) -> wgmma's reads
      mbar_arrive(ready_s + 8 * slot);
      if (ahead.it < iters) {  // into the slot of w.it - 1, once its products are done
        if (w.it > 0) mbar_wait(empty_s + 8 * ((w.it - 1) % STAGES), ((w.it - 1) / STAGES) & 1);
        issue(ahead);
        ahead.next(p.m_tiles, kb, ke);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
    float acc[64];
    int pending = -1;  // the step whose products may still run, its slot not yet released
    for (Walk w = start; w.it < iters; w.next(p.m_tiles, kb, ke)) {
      const int it = w.it, slot = it % STAGES, kk = w.kk, mt = w.mt, nt = w.nt;
      mbar_wait(full_s + 8 * slot, (it / STAGES) & 1);
      mbar_wait(ready_s + 8 * slot, (it / STAGES) & 1);
      if (kk == kb) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const uint64_t da = sw128_desc(base_s + OFF_R + slot * R_BYTES + wg * 64 * 128);
      const uint64_t db = sw128_desc(base_s + OFF_B + bslot(w) * B_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)  // k16 step j starts 32 bytes further into each row
        wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j);
      wgmma_commit();
      // keep this slice's products running into the next slice's wait; the
      // last slice of a tile finishes here for the epilogue
      if (kk == ke - 1) {
        wgmma_wait<0>();
      } else {
        wgmma_wait<1>();
      }
      fence_acc(acc);
      if (pending >= 0) mbar_arrive(empty_s + 8 * (pending % STAGES));
      pending = it;
      if (kk == ke - 1) {
        mbar_arrive(empty_s + 8 * slot);
        pending = -1;
      }

      if (kk == ke - 1) {  // epilogue
        const int m0 = mt * BM, n0 = nt * BN;
        const int rows = min(BM, p.M - m0), cols = min(BN, p.N - n0);
        const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
        if (splits > 1) {  // f32 partial tile of this split; ldws % 4 == 0
          store_acc_f32(acc, p.ws + (static_cast<size_t>(split) * p.M + m0) * p.ldws + n0,
                        p.ldws, r0, rows, cols, true, lane);
        } else if constexpr (std::is_same<T, float>::value) {
          store_acc_f32(acc, static_cast<float*>(p.y) + static_cast<size_t>(m0) * p.ldy + n0,
                        p.ldy, r0, rows, cols, p.y_vec, lane);
        } else if (p.y_tma) {
          store_acc_bf16_tma(acc, smem + OFF_C, base_s + OFF_C, &tm_y, m0, n0, p.N, r0, tid);
        } else {
          store_acc_bf16_ragged(acc, smem + OFF_C,
                                static_cast<T*>(p.y) + static_cast<size_t>(m0) * p.ldy + n0,
                                p.ldy, r0, rows, cols, tid);
        }
      }
    }
    if (tid == 0) bulk_wait();  // the TMA stores are done before the block's memory goes
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// y = narrow(sum over splits of the partial tiles), the splits in order; four
// columns a thread where N % 4 == 0
template <typename TO>
__global__ void __launch_bounds__(256) splitk_reduce_kernel(const float* __restrict__ ws,
                                                            TO* __restrict__ y, int M, int N,
                                                            int ldws, int ldy, int splits) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (N % 4 == 0) {
    const int quads = N / 4;
    for (size_t i = first; i < static_cast<size_t>(M) * quads; i += stride) {
      const int m = static_cast<int>(i / quads), n = static_cast<int>(i % quads) * 4;
      float4 a = *reinterpret_cast<const float4*>(ws + static_cast<size_t>(m) * ldws + n);
      for (int s = 1; s < splits; ++s) {
        const float4 b = *reinterpret_cast<const float4*>(
            ws + (static_cast<size_t>(s) * M + m) * ldws + n);
        a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
      }
      store4(y + static_cast<size_t>(m) * ldy + n, a);
    }
    return;
  }
  for (size_t i = first; i < static_cast<size_t>(M) * N; i += stride) {
    const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
    float a = ws[static_cast<size_t>(m) * ldws + n];
    for (int s = 1; s < splits; ++s) a += ws[(static_cast<size_t>(s) * M + m) * ldws + n];
    y[static_cast<size_t>(m) * ldy + n] = cvt_out(a, static_cast<TO*>(nullptr));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {  // libcuda's cuTensorMapEncodeTiled, found at run time, not linked
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
#endif
  }
  return fn;
}

// a row-major (rows, cols) tensor whose rows are `stride` bytes apart, read
// or written in boxes of (box_rows, box_cols) with the 128-byte swizzle;
// zeros past the edges. False where the driver has no encoder or refuses.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rows, int cols,
            long long stride, int box_rows, int box_cols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const Params& p, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
           const CUtensorMap& tm_y, int splits, int sms, cudaStream_t st) {
  static bool configured = false;  // above 48 KB only after opting in, once per kernel
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int blocks = std::max(1, std::min(p.tiles, sms / splits));
  int8_matmul_kernel<T><<<dim3(blocks, splits), 2 * THREADS, SMEM_ALLOC, st>>>(p, tm_x, tm_w, tm_y);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long work = static_cast<long long>(p.M) * (p.N % 4 == 0 ? p.N / 4 : p.N);
    const int grid = static_cast<int>(std::min((work + 255) / 256, 8LL * sms));
    splitk_reduce_kernel<T><<<grid, 256, 0, st>>>(p.ws, static_cast<T*>(p.y), p.M, p.N, p.ldws,
                                                  p.ldy, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). ldx, ldw: row strides
// of x (elements) and w (bytes); y is dense (M, N). splits > 1 needs `ws`,
// float32 (splits, M, round_up(N, 4)). sms: the card's SM count. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* s, void* y, void* ws,
                                  int M, int N, int K, int ldx, int ldw, int dtype, int splits,
                                  int sms, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || sms < 1 || (splits > 1 && ws == nullptr) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.s = static_cast<const float*>(s);
  p.y = y;
  p.ws = static_cast<float*>(ws);
  p.M = M; p.N = N; p.K = K; p.ldx = ldx; p.ldw = ldw; p.ldy = N;
  p.ldws = (N + 3) / 4 * 4;
  p.m_tiles = (M + BM - 1) / BM;
  p.tiles = p.m_tiles * ((N + BN - 1) / BN);
  p.kt = (K + BK - 1) / BK;
  if (splits > p.kt || (splits > 1 && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA takes 16-byte aligned bases and row strides; the plain paths are
  // chosen from those tests alone, and a descriptor that TMA could take but
  // the driver does not encode is an error, never a quiet fall-back
  CUtensorMap tm_x = {}, tm_w = {}, tm_y = {};
  p.x_tma = dtype == 1 && aligned16(x) && ldx % 8 == 0;
  p.w_tma = aligned16(w) && ldw % 16 == 0;
  p.y_tma = dtype == 1 && splits == 1 && aligned16(y) && N % 8 == 0;
  p.y_vec = aligned16(y) && N % 2 == 0;  // f32 y: 8-byte pairs
  if ((p.x_tma && !encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2LL * ldx, BM, BK)) ||
      (p.w_tma && !encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, ldw, BK, BN)) ||
      (p.y_tma && !encode(&tm_y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, M, N, 2LL * N, BM, BN / 2)))
    return ERR_TMA_ENCODE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, tm_x, tm_w, tm_y, splits, sms, st)
                    : launch<__nv_bfloat16>(p, tm_x, tm_w, tm_y, splits, sms, st);
}

// dynamic shared memory the GEMM kernel asks for, in bytes
extern "C" int int8_matmul_smem_bytes() { return SMEM_ALLOC; }

// the output tile and K stage, {BM, BN, BK}, which the wrapper's split-K
// chooser assumes
extern "C" void int8_matmul_tile(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
}

extern "C" const char* int8_matmul_error_string(int code) {
  if (code == ERR_TMA_ENCODE) return "cuTensorMapEncodeTiled is missing or refused a descriptor";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
