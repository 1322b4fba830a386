// Grouped GEMM over ragged row groups, for Hopper (sm_90a): the expert FFN
// of the dropless mixture of experts (parallel/moe.py, capacity_factor=None).
//
// The rows of a (M, K) are sorted into G groups: group g holds rows
// offs[g]:offs[g + 1] and is multiplied by its own matrix. Two kernels:
//
//   grouped_gemm_kernel        c[rows of g] = epi(a[rows of g] @ b[g] (+ bias[g]))
//                              b (G, K, N), or (G, N, K) read as its
//                              transpose (the input gradient's form)
//   grouped_gemm_wgrad_kernel  dw[g] = x[rows of g]^T @ dy[rows of g]   (K1, N) float32
//                              db[g] = column sums of dy[rows of g]      (N,) float32
//                              by chunks of a group's rows into a workspace,
//                              which grouped_gemm_wgrad_reduce_kernel sums
//
// The epilogues of the product (`epi`): 0 none (plus bias where given);
// 1, the expert FFN's first product: z = a @ b + bias is written in a's type
// and c = dropout(swish(z)) from z as stored; 2, its gradient: c = (a @ b^T)
// * keep * scale * swish'(z) for the z given. The dropout's bytes are read
// row by row through src (the row of `bits` that each sorted row came from),
// so they stay in the order they were drawn: a value is kept where its byte
// is >= thresh and multiplied by scale.
//
// Replaces no TPU kernel: the JAX package's MoE multiplies a dense one-hot
// dispatch tensor into capacity-padded expert blocks, which drops tokens past
// the capacity; these kernels run every routed row and pad nothing.
//
// The offsets live in device memory and are read by the kernels, so nothing
// is read back to the host and the grid depends on the shapes alone: the
// product takes ceil(M / BM) + G row tiles (what any split of M rows into G
// groups needs; a group's rows take ceil(rows / BM) tiles, in order, and a
// tile past the last group's writes zeros to the rows outside every group,
// which there are enough such tiles to cover); the weight gradient one block
// per (K1 tile, N tile, chunk of at most 4,096 rows of a group; ceil(M /
// 4096) + G chunks bound any split), each writing its partial sums to a
// slab of its own, which a second kernel adds in chunk order (an empty group
// gets zeros): routers put half the rows on one expert, and a block a group
// would leave that group's blocks running alone. No atomics, so the results
// do not change from run to run.
//
// What bounds it on the H100: at the expert FFN's shapes (77,614 rows, 256
// <-> 2048, 8 groups) a product does about 81 GFLOP against 0.37 GB (82 us
// at 989 TFLOP/s, 109 us at 3.35 TB/s): near the balance point, so the
// epilogues keep the bias, the activation and the dropout out of device
// memory (z and the activation written once, as the backward needs them).
//
// The design (bf16): 128 x 128 output tiles, eight warps of 64 x 32
// (two blocks an SM, so that one block's epilogue overlaps the other's
// products),
// tensor cores through mma.sync m16n8k16 (float32 sums), fragments by
// ldmatrix (.trans for operands stored with M or N innermost: b (G, K, N),
// and both operands of the weight gradient, whose reduction runs over rows).
// Slices 64 bytes deep go through a ring of four stages by cp.async, three
// ahead, zero-filled past the edges; rows are padded by 16 bytes in shared
// memory so that ldmatrix reads eight distinct banks. The tile's float32
// sums are staged in shared memory, then the epilogue walks it eight columns
// and 8 rows a thread, its loads of the dropout bytes (through the rows'
// sources, read into shared memory before the products) and of z all issued
// before any is used, and writes the results as 16-byte stores of
// consecutive columns. float32 operands take the same tiles, loads and
// epilogue with full float32 sums on the FMA units (8 x 8 outputs a thread),
// no TF32.
//
// Both launchers run on the caller's stream, never synchronise, and return
// cudaGetLastError() (0 on success). K, N and K1 must be multiples of 8, the
// pointers 16-byte aligned and the groups at most 256 (the wrapper,
// ops/grouped_gemm.py, checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;            // output rows a block
constexpr int BN = 128;            // output columns a block
constexpr int SLICE = 64;          // bytes of the reduction a stage holds per row
constexpr int STAGES = 4;          // cp.async ring: loads run three slices ahead
constexpr int THREADS = 256;       // eight warps, each 64 x 32 of the tile
constexpr int PAD = 16;            // bytes after each row in shared memory
constexpr int REGION = 10240;      // bytes of one operand's slice in shared memory
constexpr int STAGE_BYTES = 2 * REGION;
constexpr int ACC_LD = BN + 4;     // row pitch of the staged float32 tile
constexpr int WGRAD_ROWS = 4096;   // rows of a group one weight-gradient block sums at most
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_GROUPS = 256;    // groups a launch takes: their bounds are read into shared memory
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(BM * ACC_LD * 4 <= SMEM_BYTES, "the staged tile reuses the ring");
static_assert(BM * (SLICE + PAD) <= REGION, "a K-innermost slice fits its region");

enum Type { F32 = 0, BF16 = 1 };
enum Epi { EPI_NONE = 0, EPI_SWISH_DROPOUT = 1, EPI_DSWISH_DROPOUT = 2 };
// how the operands lie: the product with b (G, K, N), with b (G, N, K), and
// the weight gradient (x and dy both with the reduction over rows)
enum Layout { PLAIN = 0, TRANS_B = 1, WGRAD = 2 };

template <typename T>
struct Tile {
  static constexpr int BK = SLICE / sizeof(T);          // reduction depth of a stage
  static constexpr int EPC = 16 / sizeof(T);            // elements of a 16-byte chunk
  static constexpr int LD_K = (SLICE + PAD) / sizeof(T);     // row pitch, reduction innermost
  static constexpr int LD_MN = (BN * sizeof(T) + PAD) / sizeof(T);  // rows or columns innermost
  static_assert(BK * LD_MN * sizeof(T) <= REGION, "an M- or N-innermost slice fits its region");
};

struct Params {
  const void* a;        // (M, K): the product's left operand; x (M, K1) of the weight gradient
  const void* b;        // (G, K, N) or (G, N, K); dy (M, N) of the weight gradient
  void* c;              // (M, N) in a's type; dw (G, K1, N) float32
  void* z;              // epi 1: z written; epi 2: z read; (M, N)
  const float* bias;    // (G, N) or null
  float* db;            // (G, N) float32 or null: the weight gradient's bias gradient
  const int64_t* offs;  // G + 1 row bounds
  const int64_t* src;   // (M,) each row's row of bits, or null
  const uint8_t* bits;  // (rows, N) dropout bytes, or null
  long long m;          // rows of a
  int n, k, groups;     // k: the product's reduction; K1 for the weight gradient
  int epi, thresh, n_tiles;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // at most N groups of copies still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// eight consecutive elements from / to 16-byte-aligned global memory
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  constexpr int W = 8 * sizeof(T) / 16;
  __align__(16) T e[8];
#pragma unroll
  for (int i = 0; i < W; ++i)
    reinterpret_cast<uint4*>(e)[i] = reinterpret_cast<const uint4*>(p)[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = to_float(e[i]);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  constexpr int W = 8 * sizeof(T) / 16;
  __align__(16) T e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = from_float<T>(v[i]);
#pragma unroll
  for (int i = 0; i < W; ++i)
    reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(e)[i];
}

__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// the G + 1 row bounds into shared memory, all at once (every block first
// finds its group in them)
__device__ __forceinline__ const long long* read_bounds(const Params& p) {
  __shared__ long long bounds[MAX_GROUPS + 1];
  for (int i = threadIdx.x; i <= p.groups; i += blockDim.x) bounds[i] = p.offs[i];
  __syncthreads();
  return bounds;
}

// One stage of both operands into shared memory, 512 16-byte chunks each,
// two a thread. `r0`, `r_end`: the rows of a (the product) or of x and dy
// (the weight gradient) this slice may read; `kk`: where the slice starts
// along the reduction; `m0`, `n0`: the tile's origin.
template <typename T, int L>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* st, const T* bg,
                                           long long r0, long long r_end, int kk, int m0,
                                           int n0, int tid) {
  using TL = Tile<T>;
  const uint32_t sa = smem_u32(st), sb = smem_u32(st + REGION);
#pragma unroll
  for (int i = 0; i < 512 / THREADS; ++i) {
    const int q = tid + THREADS * i;
    if (L != WGRAD) {
      // a: BM rows, the slice's BK columns (4 chunks a row)
      const int r = q >> 2, c = (q & 3) * TL::EPC;
      const long long gr = r0 + r;
      const int gk = kk + c;
      const int left = gr < r_end ? (p.k - gk) * static_cast<int>(sizeof(T)) : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      const T* src = static_cast<const T*>(p.a) + (bytes ? gr * p.k + gk : 0);
      cp_async16(sa + (r * TL::LD_K + c) * sizeof(T), src, bytes);
    } else {
      // x: the slice's BK rows, the tile's BM columns of K1
      constexpr int CPR = BM / TL::EPC;  // chunks a row
      const int r = q / CPR, c = (q % CPR) * TL::EPC;
      const long long gr = r0 + kk + r;
      const int gm = m0 + c;
      const int left = gr < r_end ? (p.k - gm) * static_cast<int>(sizeof(T)) : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      const T* src = static_cast<const T*>(p.a) + (bytes ? gr * p.k + gm : 0);
      cp_async16(sa + (r * TL::LD_MN + c) * sizeof(T), src, bytes);
    }
    if (L == TRANS_B) {
      // b[g] (N, K): the tile's BN rows, the slice's BK columns
      const int r = q >> 2, c = (q & 3) * TL::EPC;
      const int gn = n0 + r, gk = kk + c;
      const int left = gn < p.n ? (p.k - gk) * static_cast<int>(sizeof(T)) : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      const T* src = bg + (bytes ? static_cast<long long>(gn) * p.k + gk : 0);
      cp_async16(sb + (r * TL::LD_K + c) * sizeof(T), src, bytes);
    } else {
      // b[g] (K, N) or dy (M, N): the slice's BK rows, the tile's BN columns
      constexpr int CPR = BN / TL::EPC;
      const int r = q / CPR, c = (q % CPR) * TL::EPC;
      const int gn = n0 + c;
      bool row_ok;
      long long gr;
      if (L == WGRAD) {
        gr = r0 + kk + r;
        row_ok = gr < r_end;
      } else {
        gr = kk + r;
        row_ok = gr < p.k;
      }
      const int left = row_ok ? (p.n - gn) * static_cast<int>(sizeof(T)) : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      const T* src = bg + (bytes ? gr * p.n + gn : 0);
      cp_async16(sb + (r * TL::LD_MN + c) * sizeof(T), src, bytes);
    }
  }
}

// One stage's products into the accumulators. Tensor cores for bf16: warp w holds rows 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31,
// acc[i][j] the m16n8 tile (i, j) in mma's layout. float32: thread t holds
// rows 8 (t / 16) + i and columns 8 (t % 16) + j, as acc[i / 2][j / 2][2 (i %
// 2) + j % 2].
template <typename T, int L>
__device__ __forceinline__ void compute_stage(const uint8_t* st, float (&acc)[4][4][4], int tid) {
  using TL = Tile<T>;
  const T* sa_p = reinterpret_cast<const T*>(st);
  const T* sb_p = reinterpret_cast<const T*>(st + REGION);
  if constexpr (std::is_same<T, float>::value) {
    const int tr = tid >> 4, tc = tid & 15;
#pragma unroll 4
    for (int kk = 0; kk < TL::BK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tr * 8 + i;
        av[i] = L == WGRAD ? sa_p[kk * TL::LD_MN + r] : sa_p[r * TL::LD_K + kk];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc * 8 + j;
        bv[j] = L == TRANS_B ? sb_p[c * TL::LD_K + kk] : sb_p[kk * TL::LD_MN + c];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i / 2][j / 2][2 * (i % 2) + (j % 2)] += av[i] * bv[j];
    }
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const uint32_t sa = smem_u32(sa_p), sb = smem_u32(sb_p);
#pragma unroll
    for (int ks = 0; ks < TL::BK; ks += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm + 16 * i;
        if (L == WGRAD) {  // stored (k, m): the transposing load
          const int j = lane >> 3;
          const int k = ks + (j >> 1) * 8 + (lane & 7), m = mb + (j & 1) * 8;
          ldsm_x4_trans(af[i], sa + (k * TL::LD_MN + m) * 2);
        } else {
          const int m = mb + (lane & 15), k = ks + (lane >> 4) * 8;
          ldsm_x4(af[i], sa + (m * TL::LD_K + k) * 2);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int nb = wn + 16 * jj, j = lane >> 3;
        if (L == TRANS_B) {  // stored (n, k)
          const int n = nb + (j >> 1) * 8 + (lane & 7), k = ks + (j & 1) * 8;
          ldsm_x4(bf[jj], sb + (n * TL::LD_K + k) * 2);
        } else {  // stored (k, n): the transposing load
          const int k = ks + (j & 1) * 8 + (lane & 7), n = nb + (j >> 1) * 8;
          ldsm_x4_trans(bf[jj], sb + (k * TL::LD_MN + n) * 2);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(acc[i][j], af[i], bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
    }
  }
}

// the accumulators -> the staged float32 tile (BM x ACC_LD) in shared memory
template <typename T>
__device__ __forceinline__ void stage_acc(float* tile, const float (&acc)[4][4][4], int tid) {
  if constexpr (std::is_same<T, float>::value) {
    const int tr = tid >> 4, tc = tid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 4)
        *reinterpret_cast<float4*>(tile + (tr * 8 + i) * ACC_LD + tc * 8 + j) =
            make_float4(acc[i / 2][j / 2][2 * (i % 2)], acc[i / 2][j / 2][2 * (i % 2) + 1],
                        acc[i / 2][j / 2 + 1][2 * (i % 2)], acc[i / 2][j / 2 + 1][2 * (i % 2) + 1]);
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = tile + (wm + 16 * i + g) * ACC_LD + wn + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * ACC_LD) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
}

// The ring over the reduction: `steps` slices, each loaded three ahead.
template <typename T, int L>
__device__ __forceinline__ void main_loop(const Params& p, uint8_t* smem, const T* bg,
                                          long long r0, long long r_end, int steps, int m0,
                                          int n0, float (&acc)[4][4][4], float* col_sum,
                                          int tid) {
  using TL = Tile<T>;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage<T, L>(p, smem + s * STAGE_BYTES, bg, r0, r_end, s * TL::BK, m0, n0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice `it` has landed, and every warp is done with slice it - 1
    const int next = it + STAGES - 1;
    if (next < steps)
      load_stage<T, L>(p, smem + (next % STAGES) * STAGE_BYTES, bg, r0, r_end, next * TL::BK,
                       m0, n0, tid);
    cp_async_commit();
    const uint8_t* st = smem + (it % STAGES) * STAGE_BYTES;
    compute_stage<T, L>(st, acc, tid);
    if (col_sum && tid < BN) {  // the weight gradient's bias gradient: dy's column `tid`
      const T* sb = reinterpret_cast<const T*>(st + REGION);
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < TL::BK; ++r) s += to_float(sb[r * TL::LD_MN + tid]);
      *col_sum += s;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the staged tile
}

template <typename T, int L>
__device__ __forceinline__ void product(const Params& p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % p.n_tiles;
  const long long m_tile = blockIdx.x / p.n_tiles;
  // this row tile's group: groups take ceil(rows / BM) tiles each, in order
  const long long* offs = read_bounds(p);
  long long first = 0, row0 = 0, row_end = 0;
  int group = -1;
  for (int g = 0; g < p.groups; ++g) {
    const long long lo = offs[g], hi = offs[g + 1];
    const long long tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
    if (m_tile >= first && m_tile < first + tiles) {
      group = g;
      row0 = lo + (m_tile - first) * BM;
      row_end = hi;
      break;
    }
    first += tiles;
  }
  if (group < 0) {
    // past the last group's tiles: these tiles zero the rows outside every
    // group, [0, offs[0]) and [offs[G], M), BM of them a tile (there are as
    // many spare tiles as that takes)
    const long long lead = offs[0], tail = offs[p.groups];
    const long long u0 = (m_tile - first) * BM;
    const int gc = n_tile * BN + (tid & 15) * 8;
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = tid >> 4; r < BM; r += THREADS / 16) {
      const long long u = u0 + r;
      const long long row = u < lead ? u : tail + (u - lead);
      if (row >= p.m || gc >= p.n) continue;
      store8<T>(static_cast<T*>(p.c) + row * p.n + gc, zero);
      if (p.epi == EPI_SWISH_DROPOUT) store8<T>(static_cast<T*>(p.z) + row * p.n + gc, zero);
    }
    return;
  }
  __shared__ long long src_rows[BM];  // each row's row of the dropout bytes
  if (p.bits && tid < BM) src_rows[tid] = row0 + tid < row_end ? p.src[row0 + tid] : 0;
  const int n0 = n_tile * BN;
  const T* bg = static_cast<const T*>(p.b) + static_cast<long long>(group) * p.k * p.n;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  main_loop<T, L>(p, smem, bg, row0, row_end, (p.k + Tile<T>::BK - 1) / Tile<T>::BK, 0, n0,
                  acc, nullptr, tid);
  float* tile = reinterpret_cast<float*>(smem);
  stage_acc<T>(tile, acc, tid);
  __syncthreads();
  // The epilogue. A thread keeps eight consecutive columns (c) and takes
  // rows tid / 16 + 16 i; it first loads the bytes and z of all 8 rows, so
  // that their latencies overlap, then computes and stores.
  const int c = (tid & 15) * 8, gc = n0 + c;
  if (gc >= p.n) return;
  float bias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bias[e] = 0.f;
  if (p.bias) {
    const float* bp = p.bias + static_cast<long long>(group) * p.n + gc;
    const float4 b0 = *reinterpret_cast<const float4*>(bp);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + 4);
    bias[0] = b0.x; bias[1] = b0.y; bias[2] = b0.z; bias[3] = b0.w;
    bias[4] = b1.x; bias[5] = b1.y; bias[6] = b1.z; bias[7] = b1.w;
  }
  const uint32_t th = static_cast<uint32_t>(p.thresh);
  const bool drop = p.bits != nullptr, dswish = p.epi == EPI_DSWISH_DROPOUT;
  {
    uint2 bytes[8];
    float z[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (tid >> 4) + 16 * i;
      const bool ok = row0 + r < row_end;
      bytes[i] = make_uint2(0xffffffffu, 0xffffffffu);
      if (drop && ok) bytes[i] = *reinterpret_cast<const uint2*>(p.bits + src_rows[r] * p.n + gc);
      if (dswish && ok) load8<T>(static_cast<const T*>(p.z) + (row0 + r) * p.n + gc, z[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (tid >> 4) + 16 * i;
      if (row0 + r >= row_end) continue;
      const long long off = (row0 + r) * p.n + gc;
      float v[8];
      const float4 v0 = *reinterpret_cast<const float4*>(tile + r * ACC_LD + c);
      const float4 v1 = *reinterpret_cast<const float4*>(tile + r * ACC_LD + c + 4);
      v[0] = v0.x; v[1] = v0.y; v[2] = v0.z; v[3] = v0.w;
      v[4] = v1.x; v[5] = v1.y; v[6] = v1.z; v[7] = v1.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] += bias[e];
        const uint32_t byte = ((e < 4 ? bytes[i].x : bytes[i].y) >> (8 * (e & 3))) & 255u;
        const float keep = drop ? (byte >= th ? p.scale : 0.f) : 1.f;
        if (p.epi == EPI_SWISH_DROPOUT) {  // z as stored, then dropout(swish(z))
          const float zr = to_float(from_float<T>(v[e]));
          z[i][e] = v[e];
          v[e] = zr * sigmoid(zr) * keep;
        } else if (dswish) {  // (g @ b^T) * keep * scale * swish'(z)
          const float sg = sigmoid(z[i][e]);
          v[e] = v[e] * keep * (sg * (1.f + z[i][e] * (1.f - sg)));
        }
      }
      if (p.epi == EPI_SWISH_DROPOUT) store8<T>(static_cast<T*>(p.z) + off, z[i]);
      store8<T>(static_cast<T*>(p.c) + off, v);
    }
  }
}

// The weight gradient of one chunk of a group's rows (at most WGRAD_ROWS:
// groups take ceil(rows / WGRAD_ROWS) chunks each, in order, so that no
// block waits on a group that holds most of the rows) into its own (K1 + 1,
// N) float32 slab of the workspace `c`: the partial x^T dy, and in row K1
// the partial column sums of dy where `db` is asked for.
template <typename T>
__device__ __forceinline__ void wgrad(const Params& p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long long chunk = blockIdx.z;
  const long long* offs = read_bounds(p);
  long long first = 0, lo = 0, hi = 0;
  int group = -1;
  for (int g = 0; g < p.groups; ++g) {
    const long long a = offs[g], b = offs[g + 1];
    const long long chunks = b > a ? (b - a + WGRAD_ROWS - 1) / WGRAD_ROWS : 0;
    if (chunk >= first && chunk < first + chunks) {
      group = g;
      lo = a + (chunk - first) * WGRAD_ROWS;
      hi = lo + WGRAD_ROWS < b ? lo + WGRAD_ROWS : b;
      break;
    }
    first += chunks;
  }
  if (group < 0) return;  // past the last group's chunks
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float col_sum = 0.f;
  const bool sums = p.db != nullptr && blockIdx.y == 0;
  main_loop<T, WGRAD>(p, smem, static_cast<const T*>(p.b), lo, hi,
                      static_cast<int>((hi - lo + Tile<T>::BK - 1) / Tile<T>::BK), m0, n0, acc,
                      sums ? &col_sum : nullptr, tid);
  float* slab = static_cast<float*>(p.c) + chunk * (p.k + 1) * p.n;
  if (sums && tid < BN && n0 + tid < p.n) slab[static_cast<long long>(p.k) * p.n + n0 + tid] = col_sum;
  float* tile = reinterpret_cast<float*>(smem);
  stage_acc<T>(tile, acc, tid);
  __syncthreads();
  for (int q = tid; q < BM * BN / 4; q += THREADS) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    if (m0 + r >= p.k || n0 + c >= p.n) continue;
    *reinterpret_cast<float4*>(slab + static_cast<long long>(m0 + r) * p.n + n0 + c) =
        *reinterpret_cast<const float4*>(tile + r * ACC_LD + c);
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 2) grouped_gemm_kernel(const Params p) {
  product<T, L>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) grouped_gemm_wgrad_kernel(const Params p) {
  wgrad<T>(p);
}

// The chunks' slabs (the workspace, `c`) summed in chunk order, so that the
// result does not change from run to run, into dw (`z`, (G, K1, N)) and db
// (G, N): group blockIdx.y, four floats a thread.
__global__ void __launch_bounds__(REDUCE_THREADS) grouped_gemm_wgrad_reduce_kernel(const Params p) {
  const int g = blockIdx.y;
  long long first = 0, chunks = 0;
  for (int i = 0; i <= g; ++i) {
    const long long a = p.offs[i], b = p.offs[i + 1];
    first += chunks;
    chunks = b > a ? (b - a + WGRAD_ROWS - 1) / WGRAD_ROWS : 0;
  }
  const long long w4 = static_cast<long long>(p.k) * p.n / 4;  // float4s of dw[g]
  const long long all4 = w4 + (p.db ? p.n / 4 : 0);
  const long long slab4 = static_cast<long long>(p.k + 1) * p.n / 4;
  const float4* ws = static_cast<const float4*>(p.c);
  for (long long e = blockIdx.x * static_cast<long long>(REDUCE_THREADS) + threadIdx.x; e < all4;
       e += static_cast<long long>(gridDim.x) * REDUCE_THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long c = first; c < first + chunks; ++c) {
      const float4 v = ws[c * slab4 + e];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (e < w4) reinterpret_cast<float4*>(p.z)[g * w4 + e] = s;
    else reinterpret_cast<float4*>(p.db)[g * (p.n / 4) + e - w4] = s;
  }
}

template <typename F>
cudaError_t with_type(int code, F&& f) {
  switch (code) {
    case F32: return f(float{});
    case BF16: return f(__nv_bfloat16{});
  }
  return cudaErrorInvalidValue;
}

constexpr int MAX_DEVICES = 64;

// the weight gradient's chunks: what any split of m rows into `groups`
// groups takes
long long wgrad_chunks(long long m, int groups) { return (m + WGRAD_ROWS - 1) / WGRAD_ROWS + groups; }

// raises the kernel's dynamic shared memory limit once a device (a benign
// race sets the same value)
template <typename K>
cudaError_t allow_smem(K kernel, bool (&done)[MAX_DEVICES], int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess) done[device] = true;
  return e;
}

template <typename T, int L>
cudaError_t launch_product(const Params& p, cudaStream_t st, int device) {
  static bool ready[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(grouped_gemm_kernel<T, L>, ready, device);
  if (e != cudaSuccess) return e;
  const long long blocks = ((p.m + BM - 1) / BM + p.groups) * p.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  grouped_gemm_kernel<T, L><<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, st>>>(p);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_wgrad(const Params& p, cudaStream_t st, int device) {
  static bool ready[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(grouped_gemm_wgrad_kernel<T>, ready, device);
  if (e != cudaSuccess) return e;
  const long long chunks = wgrad_chunks(p.m, p.groups);
  if (chunks > 65535 || (p.k + BM - 1) / BM > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(p.n_tiles, (p.k + BM - 1) / BM, static_cast<unsigned>(chunks));
  grouped_gemm_wgrad_kernel<T><<<grid, THREADS, SMEM_BYTES, st>>>(p);
  const long long all4 = (static_cast<long long>(p.k) * p.n + (p.db ? p.n : 0)) / 4;
  const long long blocks = (all4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const dim3 rgrid(static_cast<unsigned>(blocks < 1024 ? blocks : 1024), p.groups);
  grouped_gemm_wgrad_reduce_kernel<<<rgrid, REDUCE_THREADS, 0, st>>>(p);
  return cudaSuccess;
}

// `device` current for the scope, the caller's restored after
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// The product: c (m, n) from a (m, k) and b (groups, k, n), or (groups, n, k)
// with trans_b. `codes` packs the type (0 float32, 1 bf16) | trans_b
// << 4 | epi << 8. bias, z, src and bits may be null where unused; offs are
// groups + 1 int64 row bounds.
extern "C" int grouped_gemm_launch(const void* a, const void* b, void* c, void* z,
                                   const float* bias, const int64_t* offs, const int64_t* src,
                                   const uint8_t* bits, long long m, int n, int k, int groups,
                                   int codes, int thresh, float scale, int device, void* stream) {
  if (m <= 0 || n <= 0 || groups <= 0) return 0;
  if (groups > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  const int type = codes & 15, trans_b = (codes >> 4) & 15, epi = (codes >> 8) & 15;
  if (n % 8 || k % 8 || epi > EPI_DSWISH_DROPOUT || (epi != EPI_NONE && z == nullptr) ||
      ((bits == nullptr) != (src == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  Params p{a, b, c, z, bias, nullptr, offs, src, bits, m, n, k, groups, epi, thresh,
           (n + BN - 1) / BN, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_type(type, [&](auto t) {
    using T = decltype(t);
    return trans_b ? launch_product<T, TRANS_B>(p, st, device)
                   : launch_product<T, PLAIN>(p, st, device);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The weight gradient: dw (groups, k1, n) float32 from x (m, k1) and dy (m,
// n) of `type`, and where db is not null the bias gradient db (groups, n);
// two kernels, the chunks' partial sums into `ws` (float32,
// grouped_gemm_wgrad_workspace(m, k1, n, groups) elements) and their sum.
extern "C" int grouped_gemm_wgrad_launch(const void* x, const void* dy, float* dw, float* db,
                                         float* ws, const int64_t* offs, long long m, int k1,
                                         int n, int groups, int type, int device, void* stream) {
  if (k1 <= 0 || n <= 0 || groups <= 0) return 0;
  if (n % 8 || k1 % 8 || groups > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  // c: the workspace the first kernel writes; z: dw
  Params p{x, dy, ws, dw, nullptr, db, offs, nullptr, nullptr, m, n, k1, groups,
           EPI_NONE, 0, (n + BN - 1) / BN, 1.f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_type(type, [&](auto t) { return launch_wgrad<decltype(t)>(p, st, device); });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long grouped_gemm_wgrad_workspace(long long m, int k1, int n, int groups) {
  return wgrad_chunks(m, groups) * (k1 + 1LL) * n;
}

extern "C" const char* grouped_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
