// The training dropout of the Conformer fused with the elementwise work
// beside it, forward and backward, for Hopper (sm_90a).
//
//   forward    out = (x) + s * act(y) * keep / keep_prob
//   backward   dy  = g * s * keep / keep_prob * act'(y)
//
//   y     (n,) bf16, fp16 or float32   the dropped input (an FFN's hidden
//                                      layer before its activation, or a
//                                      residual branch)
//   x     (n,) any of the three        the residual; absent where no add
//   bits  (n,) uint8                   the dropout's uniform bytes,
//                                      keep = bits >= thresh
//   out   (n,) y's type, or that of x + y (PyTorch's promotion) with x
//   g     (n,) out's type              upstream cotangent of out
//   dy    (n,) y's type
//
// `act` is 0 (identity), 1 (Swish: y * sigmoid(y)) or 2 (ReLU); the
// residual add takes the identity. `scale` is s / keep_prob in float32, as
// the wrapper (ops/fused_dropout.py) computes it. Everything is evaluated in
// float32 from the stored values and rounded once to the output's type; the
// backward recomputes the sigmoid from y, so the forward keeps nothing but y
// and the bytes. The gradient of x is g itself (cast by the wrapper where
// x's type differs) and is not written here.
//
// Replaces no TPU kernel: XLA fuses this chain on the TPU by itself, while
// eager PyTorch runs it as six to nine elementwise kernels each way, each a
// round trip through device memory. The bytes are drawn by the wrapper with
// torch.randint on the dropout's generator, in the order the plain path draws
// them (the benchmark's reference replays that stream), so no random numbers
// are made here.
//
// What bounds it on the H100: bytes. At the largest FFN shape of the
// Conformer's training (38,807 x 2048 bf16) the forward reads y and the bytes
// and writes out (5 B an element), the backward reads g, y and the bytes and
// writes dy (7 B): 0.119 and 0.166 ms at 3.35 TB/s. The design: a grid-stride
// loop over chunks of 16 elements, each a 16-byte load of the bytes and one
// to four 16-byte loads of each value tensor, so that a warp moves whole
// 512-byte lines and a thread keeps 48-96 bytes in flight; nothing but the
// output is written. A base pointer that is not 16-byte aligned (a view at an
// odd storage offset) sends the whole call through the scalar loop that also
// takes the tail of n % 16 elements.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 16;     // elements a thread takes an iteration
constexpr int THREADS = 256;  // a block's
constexpr int BLOCKS_PER_SM = 8;

enum Act { IDENTITY = 0, SWISH = 1, RELU = 2 };
enum Type { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// the type of x + y under PyTorch's promotion: the wider, float32 where the
// two 16-bit types meet
template <typename A, typename B>
using Promoted = typename std::conditional<std::is_same<A, B>::value, A, float>::type;

// 16 bytes of values, the unit of a load
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// CHUNK values from p (16-byte aligned) into float registers
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[CHUNK]) {
  constexpr int PER = 16 / sizeof(T);
  const Pack<T>* q = reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
  for (int w = 0; w < CHUNK / PER; ++w) {
    const Pack<T> pk = q[w];
#pragma unroll
    for (int j = 0; j < PER; ++j) out[w * PER + j] = to_float(pk.v[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const float (&in)[CHUNK]) {
  constexpr int PER = 16 / sizeof(T);
  Pack<T>* q = reinterpret_cast<Pack<T>*>(p);
#pragma unroll
  for (int w = 0; w < CHUNK / PER; ++w) {
    Pack<T> pk;
#pragma unroll
    for (int j = 0; j < PER; ++j) pk.v[j] = from_float<T>(in[w * PER + j]);
    q[w] = pk;
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == SWISH) return v * sigmoid(v);
  if (ACT == RELU) return !(v <= 0.0f) ? v : 0.0f;  // NaN passes, as in torch.relu
  return v;
}

template <int ACT>
__device__ __forceinline__ float activate_grad(float v) {
  if (ACT == SWISH) {
    const float sg = sigmoid(v);
    return sg * (1.0f + v * (1.0f - sg));
  }
  if (ACT == RELU) return !(v <= 0.0f) ? 1.0f : 0.0f;  // as torch's threshold_backward
  return 1.0f;
}

// one element of the forward; the dropped value is selected away, not
// multiplied by 0, so a dropped NaN or infinity gives 0, as torch.where does
template <int ACT, bool RES>
__device__ __forceinline__ float fwd_one(float y, float x, uint32_t bit, uint32_t thresh,
                                         float scale) {
  const float d = bit >= thresh ? activate<ACT>(y) * scale : 0.0f;
  return RES ? x + d : d;
}

template <int ACT>
__device__ __forceinline__ float bwd_one(float g, float y, uint32_t bit, uint32_t thresh,
                                         float scale) {
  return bit >= thresh ? g * scale * activate_grad<ACT>(y) : 0.0f;
}

__device__ __forceinline__ uint32_t byte_of(const uint4& b, int j) {
  const uint32_t w = j < 4 ? b.x : j < 8 ? b.y : j < 12 ? b.z : b.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

// `chunks` chunks of CHUNK elements by vector loads (0 where a pointer is not
// 16-byte aligned), then the elements from chunks * CHUNK to n one a thread
template <typename TY, typename TX, int ACT, bool RES>
__global__ void __launch_bounds__(THREADS)
    fused_dropout_fwd_kernel(const TY* __restrict__ y, const TX* __restrict__ x,
                             const uint8_t* __restrict__ bits, Promoted<TY, TX>* __restrict__ out,
                             long long n, long long chunks, uint32_t thresh, float scale) {
  using TO = Promoted<TY, TX>;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long c = first; c < chunks; c += stride) {
    const long long i0 = c * CHUNK;
    const uint4 b = *reinterpret_cast<const uint4*>(bits + i0);
    float yv[CHUNK], xv[CHUNK], ov[CHUNK];
    load_chunk(y + i0, yv);
    if (RES) load_chunk(x + i0, xv);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      ov[j] = fwd_one<ACT, RES>(yv[j], RES ? xv[j] : 0.0f, byte_of(b, j), thresh, scale);
    store_chunk(out + i0, ov);
  }
  for (long long i = chunks * CHUNK + first; i < n; i += stride) {
    const float xi = RES ? to_float(x[i]) : 0.0f;
    out[i] = from_float<TO>(fwd_one<ACT, RES>(to_float(y[i]), xi, bits[i], thresh, scale));
  }
}

template <typename TG, typename TD, int ACT>
__global__ void __launch_bounds__(THREADS)
    fused_dropout_bwd_kernel(const TG* __restrict__ g, const TD* __restrict__ y,
                             const uint8_t* __restrict__ bits, TD* __restrict__ dy, long long n,
                             long long chunks, uint32_t thresh, float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long c = first; c < chunks; c += stride) {
    const long long i0 = c * CHUNK;
    const uint4 b = *reinterpret_cast<const uint4*>(bits + i0);
    float gv[CHUNK], yv[CHUNK], dv[CHUNK];
    load_chunk(g + i0, gv);
    if (ACT != IDENTITY) load_chunk(y + i0, yv);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      dv[j] = bwd_one<ACT>(gv[j], ACT != IDENTITY ? yv[j] : 0.0f, byte_of(b, j), thresh, scale);
    store_chunk(dy + i0, dv);
  }
  for (long long i = chunks * CHUNK + first; i < n; i += stride) {
    const float yi = ACT != IDENTITY ? to_float(y[i]) : 0.0f;
    dy[i] = from_float<TD>(bwd_one<ACT>(to_float(g[i]), yi, bits[i], thresh, scale));
  }
}

template <typename F>
cudaError_t with_type(int code, F&& f) {
  switch (code) {
    case F32: return f(float{});
    case BF16: return f(__nv_bfloat16{});
    case F16: return f(__half{});
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t with_act(int act, F&& f) {
  switch (act) {
    case IDENTITY: return f(std::integral_constant<int, IDENTITY>{});
    case SWISH: return f(std::integral_constant<int, SWISH>{});
    case RELU: return f(std::integral_constant<int, RELU>{});
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// the multiprocessors of each device, read once: the launchers run a few
// hundred times a training step (a benign race writes the same value)
constexpr int MAX_DEVICES = 64;
int sm_count[MAX_DEVICES] = {};

// the chunks the vector loop takes, and a grid of at most BLOCKS_PER_SM
// blocks an SM of `device` (the loop strides over the rest)
cudaError_t geometry(int device, long long n, bool vec, long long* chunks, int* blocks) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int sms = sm_count[device];
  if (sms == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    sm_count[device] = sms;
  }
  *chunks = vec ? n / CHUNK : 0;
  const long long items = *chunks > 0 ? *chunks : n;
  const long long want = (items + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  *blocks = static_cast<int>(want < cap ? want : cap);
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

// Both launchers run on `stream` of `device` (the caller's current device is
// restored), never synchronise, and return cudaGetLastError() (0 on
// success). `codes` packs the types (0 float32, 1 bf16, 2 fp16) and the
// activation, four bits each: the forward's y | (x + 1) << 4 | act << 8,
// with x + 1 = 0 for no residual, and the output in the promotion of y's
// and x's types (y's without x); the backward's g | y << 4 | act << 8, dy in
// y's type, g's type y's where act is not the identity and y's or float32
// where it is. Anything else is refused with cudaErrorInvalidValue.
extern "C" int fused_dropout_fwd_launch(const void* y, const void* x, const void* bits, void* out,
                                        long long n, int codes, int thresh, float scale,
                                        int device, void* stream) {
  if (n <= 0) return 0;
  const int y_type = codes & 15, x_type = ((codes >> 4) & 15) - 1, act = (codes >> 8) & 15;
  const bool res = x_type >= 0;
  if (thresh <= 0 || thresh >= 256 || (res && act != IDENTITY))
    return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  long long chunks = 0;
  int blocks = 0;
  const bool vec = aligned(y) && aligned(bits) && aligned(out) && (!res || aligned(x));
  cudaError_t err = geometry(device, n, vec, &chunks, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bits);
  const uint32_t th = static_cast<uint32_t>(thresh);
  err = with_type(y_type, [&](auto ty) {
    using TY = decltype(ty);
    if (!res) {
      return with_act(act, [&](auto a) {
        constexpr int A = decltype(a)::value;
        fused_dropout_fwd_kernel<TY, TY, A, false><<<blocks, THREADS, 0, st>>>(
            static_cast<const TY*>(y), nullptr, b, static_cast<TY*>(out), n, chunks, th, scale);
        return cudaSuccess;
      });
    }
    return with_type(x_type, [&](auto tx) {
      using TX = decltype(tx);
      fused_dropout_fwd_kernel<TY, TX, IDENTITY, true><<<blocks, THREADS, 0, st>>>(
          static_cast<const TY*>(y), static_cast<const TX*>(x), b,
          static_cast<Promoted<TY, TX>*>(out), n, chunks, th, scale);
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_dropout_bwd_launch(const void* g, const void* y, const void* bits, void* dy,
                                        long long n, int codes, int thresh, float scale,
                                        int device, void* stream) {
  if (n <= 0) return 0;
  const int g_type = codes & 15, y_type = (codes >> 4) & 15, act = (codes >> 8) & 15;
  if (thresh <= 0 || thresh >= 256 || (act != IDENTITY && g_type != y_type) ||
      (g_type != y_type && g_type != F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  long long chunks = 0;
  int blocks = 0;
  const bool vec = aligned(g) && aligned(bits) && aligned(dy) && (act == IDENTITY || aligned(y));
  cudaError_t err = geometry(device, n, vec, &chunks, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bits);
  const uint32_t th = static_cast<uint32_t>(thresh);
  err = with_type(y_type, [&](auto td) {
    using TD = decltype(td);
    if (g_type != y_type) {  // float32 g into a 16-bit y: the residual add's
      fused_dropout_bwd_kernel<float, TD, IDENTITY><<<blocks, THREADS, 0, st>>>(
          static_cast<const float*>(g), nullptr, b, static_cast<TD*>(dy), n, chunks, th, scale);
      return cudaSuccess;
    }
    return with_act(act, [&](auto a) {
      constexpr int A = decltype(a)::value;
      fused_dropout_bwd_kernel<TD, TD, A><<<blocks, THREADS, 0, st>>>(
          static_cast<const TD*>(g), static_cast<const TD*>(y), b, static_cast<TD*>(dy), n,
          chunks, th, scale);
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_dropout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
