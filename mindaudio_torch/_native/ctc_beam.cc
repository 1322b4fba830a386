// CTC prefix beam search over per-frame top-k posteriors — native runtime
// component for the decode hot path.
//
// The algorithm of the Python DP (mindaudio_torch/utils/recognize.py
// ctc_prefix_beam_dp, the reference's recognize.py:297-337): hash-keyed
// prefixes, (blank, non-blank) log-prob pairs, top-`beam` pruning per frame;
// batched over utterances with one worker thread per utterance.
//
// It also follows the Python DP's arithmetic and order, so that both give
// the same doubles and keep the same prefixes on every input, exact ties
// included (a bf16 model's posteriors tie often):
// - log_add takes the max, then sums the exps left to right, as the Python
//   `log_add` over a list does;
// - hypotheses are kept in the order of their first touch (the insertion
//   order of the Python dict) and pruned by a stable sort on the score
//   (Python's `sorted`), so a tie keeps the earlier prefix.
//
// C ABI (ctypes): see ctc_prefix_beam_batch below.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <limits>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr double NEG_INF = -std::numeric_limits<double>::infinity();

// log(sum(exp(args))) as the Python DP's log_add computes it
inline double log_add(std::initializer_list<double> args) {
  double m = NEG_INF;
  for (double a : args) m = a > m ? a : m;
  if (m == NEG_INF) return NEG_INF;
  double s = 0.0;
  for (double a : args) s += std::exp(a - m);
  return m + std::log(s);
}

struct VecHash {
  size_t operator()(const std::vector<int32_t>& v) const {
    size_t h = 1469598103934665603ull;  // FNV-1a over the token bytes
    for (int32_t x : v) {
      h ^= static_cast<uint32_t>(x);
      h *= 1099511628211ull;
    }
    return h;
  }
};

struct PS {
  double pb = NEG_INF;   // ends-in-blank log prob
  double pnb = NEG_INF;  // ends-in-non-blank log prob
};

using Hyp = std::pair<std::vector<int32_t>, PS>;

// A frame's hypotheses in the order of their first touch.
class Frame {
 public:
  void clear() {
    hyps_.clear();
    where_.clear();
  }
  PS& operator[](const std::vector<int32_t>& prefix) {
    const auto [it, fresh] = where_.try_emplace(prefix, hyps_.size());
    if (fresh) hyps_.push_back({prefix, PS{}});
    return hyps_[it->second].second;
  }
  std::vector<Hyp>& hyps() { return hyps_; }

 private:
  std::vector<Hyp> hyps_;
  std::unordered_map<std::vector<int32_t>, size_t, VecHash> where_;
};

void beam_one(const float* logp, const int32_t* idx, int32_t T, int32_t K,
              int32_t beam, int32_t blank_id, int32_t max_len,
              int32_t* out_tokens, int32_t* out_lens, float* out_scores,
              int32_t* out_count) {
  std::vector<Hyp> cur;
  cur.push_back({{}, PS{0.0, NEG_INF}});

  Frame next;
  std::vector<std::pair<double, size_t>> order;
  for (int32_t t = 0; t < T; ++t) {
    next.clear();
    for (int32_t k = 0; k < K; ++k) {
      const int32_t s = idx[t * K + k];
      const double ps = logp[t * K + k];
      for (const auto& [prefix, v] : cur) {
        const int32_t last = prefix.empty() ? -1 : prefix.back();
        if (s == blank_id) {
          PS& n = next[prefix];
          n.pb = log_add({n.pb, v.pb + ps, v.pnb + ps});
        } else if (s == last) {
          {  // *ss -> *s (repeat merged into the non-blank path)
            PS& n = next[prefix];
            n.pnb = log_add({n.pnb, v.pnb + ps});
          }
          {  // *s-s -> *ss (blank separated the repeat)
            std::vector<int32_t> np = prefix;
            np.push_back(s);
            PS& n = next[np];
            n.pnb = log_add({n.pnb, v.pb + ps});
          }
        } else {
          std::vector<int32_t> np = prefix;
          np.push_back(s);
          PS& n = next[np];
          n.pnb = log_add({n.pnb, v.pb + ps, v.pnb + ps});
        }
      }
    }
    std::vector<Hyp>& hyps = next.hyps();
    order.clear();
    for (size_t i = 0; i < hyps.size(); ++i)
      order.push_back({log_add({hyps[i].second.pb, hyps[i].second.pnb}), i});
    std::stable_sort(order.begin(), order.end(),
                     [](const auto& a, const auto& b) { return a.first > b.first; });
    const size_t keep = std::min<size_t>(beam, order.size());
    cur.clear();
    for (size_t i = 0; i < keep; ++i) cur.push_back(std::move(hyps[order[i].second]));
  }

  const int32_t n = static_cast<int32_t>(cur.size());
  *out_count = n;
  for (int32_t i = 0; i < n; ++i) {
    const auto& [prefix, v] = cur[i];
    const int32_t len =
        std::min<int32_t>(static_cast<int32_t>(prefix.size()), max_len);
    out_lens[i] = len;
    std::memcpy(out_tokens + i * max_len, prefix.data(),
                sizeof(int32_t) * len);
    out_scores[i] = static_cast<float>(log_add({v.pb, v.pnb}));
  }
}

}  // namespace

extern "C" {

// top_logp: (B, T, K) f32 — top_idx: (B, T, K) i32 — n_valid: (B,) i32.
// Outputs: out_tokens (B, beam, max_len) i32, out_lens (B, beam) i32,
// out_scores (B, beam) f32, out_counts (B,) i32 (hyps emitted, <= beam).
// Returns 0 on success.
int ctc_prefix_beam_batch(const float* top_logp, const int32_t* top_idx,
                          const int32_t* n_valid, int32_t B, int32_t T,
                          int32_t K, int32_t beam, int32_t blank_id,
                          int32_t max_len, int32_t* out_tokens,
                          int32_t* out_lens, float* out_scores,
                          int32_t* out_counts) {
  if (B <= 0 || T < 0 || K <= 0 || beam <= 0 || max_len <= 0) return 1;
  auto work = [&](int32_t b) {
    const int32_t tv = std::max<int32_t>(0, std::min(n_valid[b], T));
    beam_one(top_logp + static_cast<int64_t>(b) * T * K,
             top_idx + static_cast<int64_t>(b) * T * K, tv, K, beam, blank_id,
             max_len, out_tokens + static_cast<int64_t>(b) * beam * max_len,
             out_lens + static_cast<int64_t>(b) * beam,
             out_scores + static_cast<int64_t>(b) * beam, out_counts + b);
  };
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  if (B == 1 || hw == 1) {
    for (int32_t b = 0; b < B; ++b) work(b);
    return 0;
  }
  std::vector<std::thread> threads;
  const unsigned n_threads = std::min<unsigned>(hw, B);
  // strided static partition: utterances are similar cost
  for (unsigned w = 0; w < n_threads; ++w) {
    threads.emplace_back([&, w]() {
      for (int32_t b = w; b < B; b += n_threads) work(b);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
