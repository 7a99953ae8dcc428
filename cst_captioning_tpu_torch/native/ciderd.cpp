// Native CIDEr-D reward scorer — the RL hot loop's host-side kernel (own
// copy of the reference package's native/ciderd.cpp).
//
// The reference's per-iteration reward cost is pure-Python n-gram TF-IDF
// (vendored pyciderevalcap; SURVEY.md §3.2).  This implementation keeps the
// same math (CIDEr-D: 1..4-grams, clipped TF-IDF cosine, gaussian length
// penalty, corpus document frequencies, x10 scale — parity-tested against
// metrics/ciderd.py) but works directly on int32 token-id sequences, so the
// sampled rollout never round-trips through Python strings.
//
// Contract (ctypes, see native/__init__.py):
//   h = ciderd_new(n, sigma)
//   ciderd_add_video(h, tokens_flat, ref_lens, n_refs)   // repeat per video
//   ciderd_finalize(h)                                   // df + ref vectors
//   ciderd_score(h, video_ix, hyps, max_len, n_hyps, out)
//   ciderd_free(h)
// Token id 0 terminates a hypothesis row (the framework's PAD/EOS id);
// reference captions are length-prefixed and may contain any nonzero id.

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxN = 4;

// FNV-1a over (order, ids...) — order is mixed in so the 1-gram (a) and the
// leading token of the 2-gram (a,b) hash differently.
inline uint64_t ngram_hash(const int32_t* ids, int k) {
  uint64_t h = 1469598103934665603ULL ^ static_cast<uint64_t>(k);
  for (int i = 0; i < k; ++i) {
    h ^= static_cast<uint64_t>(static_cast<uint32_t>(ids[i])) + 0x9e3779b9ULL;
    h *= 1099511628211ULL;
  }
  return h;
}

using CountMap = std::unordered_map<uint64_t, int>;
using WeightMap = std::unordered_map<uint64_t, double>;

struct Cooked {
  CountMap counts[kMaxN];  // per order k-1
  int length = 0;          // unigram count
};

void cook(const int32_t* ids, int len, int n, Cooked* out) {
  out->length = len;
  for (int k = 1; k <= n; ++k) {
    CountMap& m = out->counts[k - 1];
    for (int i = 0; i + k <= len; ++i) {
      ++m[ngram_hash(ids + i, k)];
    }
  }
}

struct RefVec {
  WeightMap vec[kMaxN];
  double norm[kMaxN] = {0, 0, 0, 0};
  int length = 0;
};

struct Scorer {
  int n = kMaxN;
  double sigma = 6.0;
  bool finalized = false;
  std::unordered_map<uint64_t, double> df;
  double log_ref_len = 0.0;
  std::vector<std::vector<Cooked>> raw;    // per video, per ref (pre-df)
  std::vector<std::vector<RefVec>> videos; // post-finalize TF-IDF

  double idf(uint64_t h) const {
    auto it = df.find(h);
    double d = it == df.end() ? 0.0 : it->second;
    return log_ref_len - std::log(d < 1.0 ? 1.0 : d);
  }
};

void to_tfidf(const Scorer& s, const Cooked& c, RefVec* out) {
  out->length = c.length;
  for (int k = 0; k < s.n; ++k) {
    double norm2 = 0.0;
    for (const auto& [h, tf] : c.counts[k]) {
      double w = tf * s.idf(h);
      out->vec[k][h] = w;
      norm2 += w * w;
    }
    out->norm[k] = std::sqrt(norm2);
  }
}

}  // namespace

extern "C" {

void* ciderd_new(int n, double sigma) {
  auto* s = new Scorer();
  s->n = n > kMaxN ? kMaxN : (n < 1 ? 1 : n);
  s->sigma = sigma;
  return s;
}

void ciderd_free(void* handle) { delete static_cast<Scorer*>(handle); }

// tokens_flat: concatenation of the video's reference captions;
// ref_lens[i] = length of reference i.
void ciderd_add_video(void* handle, const int32_t* tokens_flat,
                      const int32_t* ref_lens, int n_refs) {
  auto* s = static_cast<Scorer*>(handle);
  std::vector<Cooked> cooked(n_refs);
  const int32_t* p = tokens_flat;
  for (int r = 0; r < n_refs; ++r) {
    cook(p, ref_lens[r], s->n, &cooked[r]);
    p += ref_lens[r];
  }
  s->raw.push_back(std::move(cooked));
}

namespace {

// (Re)build every reference's TF-IDF vector from the current df table.
void build_vectors(Scorer* s) {
  s->videos.clear();
  s->videos.resize(s->raw.size());
  for (size_t v = 0; v < s->raw.size(); ++v) {
    s->videos[v].resize(s->raw[v].size());
    for (size_t r = 0; r < s->raw[v].size(); ++r) {
      to_tfidf(*s, s->raw[v][r], &s->videos[v][r]);
    }
  }
  s->finalized = true;
}

}  // namespace

// Builds corpus document frequencies (df = number of videos whose reference
// set contains the n-gram) and the per-reference TF-IDF vectors.
void ciderd_finalize(void* handle) {
  auto* s = static_cast<Scorer*>(handle);
  s->df.clear();
  for (const auto& video : s->raw) {
    std::unordered_map<uint64_t, char> seen;
    for (const auto& ref : video) {
      for (int k = 0; k < s->n; ++k) {
        for (const auto& [h, tf] : ref.counts[k]) seen.emplace(h, 1);
      }
    }
    for (const auto& [h, one] : seen) s->df[h] += 1.0;
  }
  double nd = static_cast<double>(s->raw.size());
  s->log_ref_len = std::log(nd < 1.0 ? 1.0 : nd);
  build_vectors(s);
}

// Replace the document-frequency table with an EXTERNAL corpus df (the
// reference's --train_cached_tokens pickle): hashes[i] (ngram_hash of the
// id-encoded n-gram) -> counts[i], over ref_len documents.  Rebuilds the
// reference TF-IDF vectors under the new weights.  Call after add_video
// (+finalize); scoring then matches a Python CiderD loaded from the pickle.
int ciderd_set_df(void* handle, const uint64_t* hashes, const double* counts,
                  int n_entries, double ref_len) {
  auto* s = static_cast<Scorer*>(handle);
  if (n_entries < 0 || ref_len < 1.0) return -1;
  s->df.clear();
  for (int i = 0; i < n_entries; ++i) s->df[hashes[i]] = counts[i];
  s->log_ref_len = std::log(ref_len);
  build_vectors(s);
  return 0;
}

int ciderd_num_videos(void* handle) {
  return static_cast<int>(static_cast<Scorer*>(handle)->raw.size());
}

// hyps: (n_hyps, max_len) row-major int32, rows 0-terminated (id 0 = EOS;
// everything at and after the first 0 is ignored).  video_ix[i] selects the
// reference set for hypothesis i.  out[i] = CIDEr-D score x10.
int ciderd_score(void* handle, const int32_t* video_ix, const int32_t* hyps,
                 int max_len, int n_hyps, double* out) {
  auto* s = static_cast<Scorer*>(handle);
  if (!s->finalized) return -1;
  const double inv_2sig2 = 1.0 / (2.0 * s->sigma * s->sigma);

  for (int i = 0; i < n_hyps; ++i) {
    int v = video_ix[i];
    if (v < 0 || v >= static_cast<int>(s->videos.size())) return -2;
    const int32_t* row = hyps + static_cast<int64_t>(i) * max_len;
    int len = 0;
    while (len < max_len && row[len] != 0) ++len;

    Cooked c;
    cook(row, len, s->n, &c);
    WeightMap hv[kMaxN];
    double hnorm[kMaxN];
    for (int k = 0; k < s->n; ++k) {
      double norm2 = 0.0;
      for (const auto& [h, tf] : c.counts[k]) {
        double w = tf * s->idf(h);
        hv[k][h] = w;
        norm2 += w * w;
      }
      hnorm[k] = std::sqrt(norm2);
    }

    const auto& refs = s->videos[v];
    double total = 0.0;
    for (const auto& ref : refs) {
      double delta = static_cast<double>(len - ref.length);
      double penalty = std::exp(-delta * delta * inv_2sig2);
      double per_ref = 0.0;
      for (int k = 0; k < s->n; ++k) {
        if (hnorm[k] == 0.0 || ref.norm[k] == 0.0) continue;
        double acc = 0.0;
        for (const auto& [h, hw] : hv[k]) {
          auto it = ref.vec[k].find(h);
          if (it == ref.vec[k].end()) continue;
          double rw = it->second;
          acc += (hw < rw ? hw : rw) * rw;  // CIDEr-D count clipping
        }
        per_ref += acc / (hnorm[k] * ref.norm[k]);
      }
      total += per_ref / s->n * penalty;
    }
    out[i] = refs.empty() ? 0.0 : total / refs.size() * 10.0;
  }
  return 0;
}

// Leave-one-out consensus: out[j] = CIDEr-D of video's reference j scored
// against its R-1 siblings (df = full corpus) — the offline artifact behind
// WXE weights and the SCB baseline.  out must hold the video's ref count.
int ciderd_score_loo(void* handle, int video, double* out) {
  auto* s = static_cast<Scorer*>(handle);
  if (!s->finalized) return -1;
  if (video < 0 || video >= static_cast<int>(s->videos.size())) return -2;
  const auto& refs = s->videos[video];
  const int R = static_cast<int>(refs.size());
  const double inv_2sig2 = 1.0 / (2.0 * s->sigma * s->sigma);

  for (int j = 0; j < R; ++j) {
    const RefVec& hyp = refs[j];
    double total = 0.0;
    for (int r = 0; r < R; ++r) {
      if (r == j) continue;
      const RefVec& ref = refs[r];
      double delta = static_cast<double>(hyp.length - ref.length);
      double penalty = std::exp(-delta * delta * inv_2sig2);
      double per_ref = 0.0;
      for (int k = 0; k < s->n; ++k) {
        if (hyp.norm[k] == 0.0 || ref.norm[k] == 0.0) continue;
        double acc = 0.0;
        for (const auto& [h, hw] : hyp.vec[k]) {
          auto it = ref.vec[k].find(h);
          if (it == ref.vec[k].end()) continue;
          double rw = it->second;
          acc += (hw < rw ? hw : rw) * rw;
        }
        per_ref += acc / (hyp.norm[k] * ref.norm[k]);
      }
      total += per_ref / s->n * penalty;
    }
    out[j] = R > 1 ? total / (R - 1) * 10.0 : 0.0;
  }
  return 0;
}

int ciderd_num_refs(void* handle, int video) {
  auto* s = static_cast<Scorer*>(handle);
  if (video < 0 || video >= static_cast<int>(s->raw.size())) return -1;
  return static_cast<int>(s->raw[video].size());
}

}  // extern "C"
