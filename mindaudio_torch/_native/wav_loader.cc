// Parallel WAV batch decoder — the native data-loader of the framework.
//
// The reference's input pipeline leans on native code inside its framework
// dependency (mindspore.dataset C++ runtime) plus an mp.Pool of Python
// workers (reference examples/conformer/dataset.py:456-492). Here the hot
// host path — decode N wav files, convert to normalized float32, pad into
// one contiguous (N, max_len) batch — is a C++ thread pool behind a C ABI
// (ctypes-loadable, no pybind11 needed).
//
// Supported: RIFF/RIFX PCM 8/16/24/32-bit and IEEE float32/float64, mono or
// multi-channel (first channel taken), arbitrary chunk layout. Returns per-
// file sample counts and sample rates; errors are flagged per file instead
// of aborting the batch.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -pthread wav_loader.cc -o libwav_loader.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Result {
  int32_t n_samples = 0;   // valid samples written (post-clamp)
  int32_t sample_rate = 0; // 0 => error
};

static inline uint32_t rd_u32(const uint8_t* p, bool big) {
  // cast before shifting: p[i] << 24 on a promoted int is UB for bytes >= 0x80
  return big ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                   ((uint32_t)p[2] << 8) | p[3]
             : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
                   ((uint32_t)p[1] << 8) | p[0];
}
static inline uint16_t rd_u16(const uint8_t* p, bool big) {
  return big ? (uint16_t)((p[0] << 8) | p[1]) : (uint16_t)((p[1] << 8) | p[0]);
}

// Decode one file into out[0:max_len); returns {written, sample_rate}.
Result decode_wav(const char* path, float* out, int64_t max_len) {
  Result res;
  FILE* f = std::fopen(path, "rb");
  if (!f) return res;

  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 44) { std::fclose(f); return res; }

  std::vector<uint8_t> buf((size_t)fsize);
  if (std::fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return res;
  }
  std::fclose(f);

  bool big = false;
  if (std::memcmp(buf.data(), "RIFX", 4) == 0) big = true;
  else if (std::memcmp(buf.data(), "RIFF", 4) != 0) return res;
  if (std::memcmp(buf.data() + 8, "WAVE", 4) != 0) return res;

  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= (size_t)fsize) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t size = rd_u32(hdr + 4, big);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && size >= 16 &&
        pos + 8 + 16 <= (size_t)fsize) {
      const uint8_t* p = hdr + 8;
      fmt_code = rd_u16(p, big);
      channels = rd_u16(p + 2, big);
      rate = rd_u32(p + 4, big);
      bits = rd_u16(p + 14, big);
      // WAVE_FORMAT_EXTENSIBLE: the subformat GUID lives past the base 16
      // fmt bytes — bound by the actual file size, not just the chunk's
      // self-declared size (a truncated file must not read past the buffer)
      if (fmt_code == 0xFFFE && size >= 26 && pos + 8 + 26 <= (size_t)fsize)
        fmt_code = rd_u16(p + 24, big);
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      data = hdr + 8;
      data_len = size;
      if (pos + 8 + data_len > (size_t)fsize) data_len = (uint32_t)(fsize - pos - 8);
      break;
    }
    // 64-bit advance: a crafted size near UINT32_MAX would wrap a 32-bit sum
    // to 0 and spin this loop (deadlocking the whole batch decode)
    pos += 8 + (size_t)size + (size & 1); // chunks are word-aligned
  }
  if (!data || channels == 0 || bits == 0) return res;

  uint32_t bytes_per = bits / 8;
  uint32_t frame_bytes = bytes_per * channels;
  if (frame_bytes == 0) return res;
  int64_t n_frames = data_len / frame_bytes;
  int64_t n = n_frames < max_len ? n_frames : max_len;

  // hot path: PCM16 little-endian (the overwhelmingly common case) as a
  // tight branch-free loop the compiler vectorizes
  if (fmt_code == 1 && bits == 16 && !big) {
    if (channels == 1) {
      const int16_t* s = reinterpret_cast<const int16_t*>(data);
      for (int64_t i = 0; i < n; ++i) out[i] = (float)s[i] * (1.0f / 32768.0f);
    } else {
      const int16_t* s = reinterpret_cast<const int16_t*>(data);
      for (int64_t i = 0; i < n; ++i)
        out[i] = (float)s[i * channels] * (1.0f / 32768.0f);
    }
    res.n_samples = (int32_t)n;
    res.sample_rate = (int32_t)rate;
    return res;
  }
  if (fmt_code == 3 && bits == 32 && !big) {
    const uint8_t* s = data;
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(out + i, s + (size_t)i * frame_bytes, 4);
    res.n_samples = (int32_t)n;
    res.sample_rate = (int32_t)rate;
    return res;
  }

  // first channel only (recipes do stereo_to_mono upstream when needed)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = data + (size_t)i * frame_bytes;
    float v = 0.0f;
    if (fmt_code == 1) { // PCM
      if (bits == 16) {
        int16_t s = big ? (int16_t)((p[0] << 8) | p[1])
                        : (int16_t)((p[1] << 8) | p[0]);
        v = (float)s / 32768.0f;
      } else if (bits == 32) {
        int32_t s = (int32_t)rd_u32(p, big);
        v = (float)((double)s / 2147483648.0);
      } else if (bits == 24) {
        int32_t s = big ? (p[0] << 16) | (p[1] << 8) | p[2]
                        : (p[2] << 16) | (p[1] << 8) | p[0];
        if (s & 0x800000) s |= ~0xFFFFFF; // sign-extend
        v = (float)((double)s / 8388608.0);
      } else if (bits == 8) {
        v = ((float)p[0] - 128.0f) / 128.0f;
      } else {
        return res;
      }
    } else if (fmt_code == 3) { // IEEE float
      if (bits == 32) {
        uint32_t u = rd_u32(p, big);
        std::memcpy(&v, &u, 4);
      } else if (bits == 64) {
        uint64_t u = ((uint64_t)rd_u32(p, big) << 32) | rd_u32(p + 4, big);
        if (!big) u = ((uint64_t)rd_u32(p + 4, big) << 32) | rd_u32(p, big);
        double d;
        std::memcpy(&d, &u, 8);
        v = (float)d;
      } else {
        return res;
      }
    } else {
      return res;
    }
    out[i] = v;
  }
  res.n_samples = (int32_t)n;
  res.sample_rate = (int32_t)rate;
  return res;
}

} // namespace

extern "C" {

// Decode `n` files in parallel into the caller's (n, max_len) float32 buffer
// (zero-padded). Writes per-file valid lengths and sample rates (0 = error).
// `n_threads <= 0` uses hardware concurrency.
void wav_read_batch(const char** paths, int64_t n, float* out,
                    int64_t max_len, int32_t* lens, int32_t* rates,
                    int32_t n_threads) {
  unsigned hw = std::thread::hardware_concurrency();
  unsigned workers = n_threads > 0 ? (unsigned)n_threads : (hw ? hw : 4);
  if (workers > (unsigned)n) workers = (unsigned)n;
  if (workers > 16) workers = 16; // thread-spawn cost beats decode past this

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      float* row = out + i * max_len;
      Result r = decode_wav(paths[i], row, max_len);
      // zero only this row's tail (each row touched exactly once)
      std::memset(row + r.n_samples, 0,
                  sizeof(float) * (size_t)(max_len - r.n_samples));
      lens[i] = r.n_samples;
      rates[i] = r.sample_rate;
    }
  };
  std::vector<std::thread> pool;
  for (unsigned t = 1; t < workers; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
}

} // extern "C"
