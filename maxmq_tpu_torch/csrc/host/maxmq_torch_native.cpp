// Native host runtime for maxmq-tpu: the host-side hot loops that feed the
// TPU matcher, in C++ behind a C ABI (loaded from Python via ctypes).
//
// Copy of the JAX package's native/maxmq_native.cpp, built by
// maxmq_tpu_torch/native.py; the port's numpy twins of these loops are in
// maxmq_tpu_torch/matching/{topics,sig_tables}.py.
//
// Two components:
//   1. Batch topic tokenizer — splits topic strings on '/', interns levels
//      against the matcher vocabulary and emits the fixed-width int32 token
//      matrix the device kernels consume. Replaces the per-topic Python loop
//      in maxmq_tpu/matching/topics.py:tokenize_topics (the semantics MUST
//      stay identical — parity-tested from tests/test_native.py).
//   2. MQTT frame scanner — walks a byte buffer of concatenated MQTT control
//      packets (fixed header: type byte + variable-byte-integer remaining
//      length, MQTT 5.0 spec 2.1.1/1.5.5) and returns frame boundaries, so a
//      listener can slice a large read into packets without touching Python
//      per byte. Mirrors the framing rules of
//      maxmq_tpu/protocol/codec.py:FixedHeader/read_varint.
//
// The reference broker has no native components (SURVEY.md section 2: pure
// Go); these are the TPU build's native equivalents for its zero-alloc hot
// paths (vendor/github.com/mochi-co/mqtt/v2/packets/codec.go:15-19).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <atomic>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<uint8_t>(s[i]);
    h *= 1099511628211ull;
  }
  return h;
}

// Open-addressing vocabulary (level bytes -> token id). The tokenizer
// runs on the single-core publish hot path, so lookups must not
// allocate (the previous unordered_map<string> find built a std::string
// per level) and should cost a couple of cache lines.
struct Vocab {
  struct Entry {
    uint64_t hash;
    uint32_t off, len;
    int32_t id;
  };
  std::string pool;             // concatenated key bytes
  std::vector<Entry> entries;
  std::vector<int32_t> slots;   // index into entries, -1 = empty
  uint64_t mask = 0;
  // Lazy-build synchronization: concurrent matcher threads share one
  // Vocab per compiled table (the churn suite storms exactly this),
  // and the FIRST batch after a rotation finds it dirty — without the
  // lock two threads would rebuild slots/mask under each other's
  // probes. dirty is atomic with release/acquire pairing so a reader
  // that sees dirty == false also sees the completed slots.
  std::atomic<bool> dirty{false};
  std::mutex build_mu;

  void add(const char* s, int64_t len, int32_t id) {
    entries.push_back({fnv1a(s, len), static_cast<uint32_t>(pool.size()),
                       static_cast<uint32_t>(len), id});
    pool.append(s, len);
    dirty.store(true, std::memory_order_release);
  }

  void ensure_built() {
    if (!dirty.load(std::memory_order_acquire)) return;
    std::lock_guard<std::mutex> g(build_mu);
    if (dirty.load(std::memory_order_relaxed)) build();
  }

  void build() {
    size_t cap = 16;
    while (cap < 2 * entries.size() + 1) cap <<= 1;
    mask = cap - 1;
    slots.assign(cap, -1);
    for (size_t e = 0; e < entries.size(); ++e) {
      uint64_t h = entries[e].hash & mask;
      while (slots[h] != -1) {
        const Entry& old = entries[slots[h]];
        if (old.hash == entries[e].hash && old.len == entries[e].len &&
            memcmp(pool.data() + old.off, pool.data() + entries[e].off,
                   old.len) == 0)
          break;  // duplicate key: first insertion wins (dict semantics)
        h = (h + 1) & mask;
      }
      if (slots[h] == -1) slots[h] = static_cast<int32_t>(e);
    }
    dirty.store(false, std::memory_order_release);
  }

  int32_t find(const char* s, size_t len) const {
    if (entries.empty()) return 0;
    const uint64_t hash = fnv1a(s, len);
    uint64_t h = hash & mask;
    while (slots[h] != -1) {
      const Entry& e = entries[slots[h]];
      if (e.hash == hash && e.len == len &&
          memcmp(pool.data() + e.off, s, len) == 0)
        return e.id;
      h = (h + 1) & mask;
    }
    return 0;  // UNK
  }
};

// One exact-shape signature group for the host probe: topics of exactly
// `depth` levels match a row iff the hashed signature over the group's
// literal positions equals the row's (collisions are re-verified in the
// Python decode, mirroring maxmq_tpu/matching/sig.py:HostPlusProbe).
// Probing is one open-addressing lookup (hkeys/hstart); equal-signature
// runs (collided filters, rare) walk the sorted array.
struct ProbeGroup {
  int32_t depth;
  bool wildf;                   // level 0 is '+': excluded for '$'-topics
  uint32_t dc;                  // depth-term addend (depth_coef * depth)
  std::vector<uint32_t> coef;   // [depth] multipliers, 0 at '+' positions
  std::vector<uint32_t> sigs;   // SORTED row signatures
  std::vector<int32_t> rows;    // row ids aligned with sigs
  std::vector<uint32_t> hkeys;  // open-addressing: signature keys
  std::vector<int32_t> hstart;  // -> first index in sigs, -1 = empty
  uint32_t hmask = 0;
  std::vector<uint64_t> bloom;  // 1-hash prefilter, ~8 bits/row: almost
                                // every (topic, group) pair misses, and
                                // the bloom bits stay cache-resident
                                // where the full tables do not
  uint32_t bshift = 0;

  void build_table() {
    size_t cap = 8;
    while (cap < 2 * sigs.size() + 1) cap <<= 1;
    hmask = static_cast<uint32_t>(cap - 1);
    hkeys.assign(cap, 0);
    hstart.assign(cap, -1);
    size_t mbits = 64;
    while (mbits < 8 * sigs.size()) mbits <<= 1;
    int lg = 6;
    while ((size_t{1} << lg) < mbits) ++lg;
    bshift = 32 - lg;
    bloom.assign(mbits / 64, 0);
    for (size_t i = 0; i < sigs.size(); ++i) {
      const uint32_t bb = (sigs[i] * 0xC2B2AE35u) >> bshift;
      bloom[bb >> 6] |= uint64_t{1} << (bb & 63);
      if (i > 0 && sigs[i] == sigs[i - 1]) continue;  // run: keep first
      uint32_t h = (sigs[i] * 0x9E3779B1u) & hmask;
      while (hstart[h] != -1) h = (h + 1) & hmask;
      hkeys[h] = sigs[i];
      hstart[h] = static_cast<int32_t>(i);
    }
  }

  inline int32_t probe(uint32_t sig) const {
    const uint32_t bb = (sig * 0xC2B2AE35u) >> bshift;
    if (!(bloom[bb >> 6] & (uint64_t{1} << (bb & 63)))) return -1;
    uint32_t h = (sig * 0x9E3779B1u) & hmask;
    while (hstart[h] != -1) {
      if (hkeys[h] == sig) return hstart[h];
      h = (h + 1) & hmask;
    }
    return -1;
  }
};

struct ProbeSet {
  std::vector<ProbeGroup> groups;
  std::vector<std::vector<int32_t>> by_depth;  // depth -> group indices
  // '#'-prefix mode (mq_probe_set_ge): a group applies to any topic of
  // depth >= its prefix depth (the trailing-'#' rule incl. the depth-d
  // parent match), not just == — groups iterate depth-ascending with an
  // early break instead of through by_depth
  bool ge_depth = false;
  std::vector<int32_t> ge_sorted;              // group ids by depth asc
};

inline uint32_t tok_at(const void* toks, int32_t mode, int64_t idx) {
  switch (mode) {
    case 1: return static_cast<const uint8_t*>(toks)[idx];
    case 2: return static_cast<const uint16_t*>(toks)[idx];
    default:
      return static_cast<uint32_t>(static_cast<const int32_t*>(toks)[idx]);
  }
}

}  // namespace

extern "C" {

void* mq_vocab_new() { return new Vocab(); }

void mq_vocab_free(void* v) { delete static_cast<Vocab*>(v); }

void mq_vocab_add(void* v, const char* s, int64_t len, int32_t tok) {
  static_cast<Vocab*>(v)->add(s, len, tok);
}

int64_t mq_vocab_size(void* v) {
  return static_cast<int64_t>(static_cast<Vocab*>(v)->entries.size());
}

// Tokenize n_topics topics stored concatenated in `buf` with boundaries
// `offsets` (length n_topics + 1, offsets[i]..offsets[i+1] is topic i).
// Outputs (caller-allocated):
//   toks    int32[n_topics * max_levels]  token ids, -1 padded
//   lengths int32[n_topics]               level count, -1 if > max_levels
//   dollar  uint8[n_topics]               1 if the topic starts with '$'
// Unknown levels get token 0 (UNK). Split keeps empty levels, matching
// topics.py:split_levels ("a//b" -> 3 levels).
void mq_tokenize(void* v, const char* buf, const int64_t* offsets,
                 int64_t n_topics, int64_t max_levels, int32_t* toks,
                 int32_t* lengths, uint8_t* dollar) {
  Vocab* vb = static_cast<Vocab*>(v);
  vb->ensure_built();
  const Vocab& map = *vb;
  for (int64_t i = 0; i < n_topics; ++i) {
    const char* start = buf + offsets[i];
    const int64_t tlen = offsets[i + 1] - offsets[i];
    dollar[i] = (tlen > 0 && start[0] == '$') ? 1 : 0;
    int32_t* row = toks + i * max_levels;
    for (int64_t j = 0; j < max_levels; ++j) row[j] = -1;

    int64_t n_levels = 0;
    int64_t level_start = 0;
    bool overflow = false;
    for (int64_t p = 0; p <= tlen; ++p) {
      if (p == tlen || start[p] == '/') {
        if (n_levels >= max_levels) {
          overflow = true;
          break;
        }
        row[n_levels] = map.find(start + level_start, p - level_start);
        ++n_levels;
        level_start = p + 1;
      }
    }
    if (overflow) {
      lengths[i] = -1;
      for (int64_t j = 0; j < max_levels; ++j) row[j] = -1;
    } else {
      lengths[i] = static_cast<int32_t>(n_levels);
    }
  }
}

// Like mq_tokenize, but topics arrive as ONE UTF-8 buffer separated by NUL
// bytes (U+0000 is forbidden inside MQTT topic names [MQTT-1.5.4-2], so the
// separator is unambiguous). Avoids per-topic Python string marshalling.
void mq_tokenize_joined(void* v, const char* buf, int64_t buf_len,
                        int64_t n_topics, int64_t max_levels, int32_t* toks,
                        int32_t* lengths, uint8_t* dollar) {
  Vocab* vb = static_cast<Vocab*>(v);
  vb->ensure_built();
  const Vocab& map = *vb;
  int64_t topic_start = 0;
  int64_t i = 0;
  for (int64_t end = 0; end <= buf_len && i < n_topics; ++end) {
    if (end != buf_len && buf[end] != '\0') continue;
    const char* start = buf + topic_start;
    const int64_t tlen = end - topic_start;
    dollar[i] = (tlen > 0 && start[0] == '$') ? 1 : 0;
    int32_t* row = toks + i * max_levels;
    for (int64_t j = 0; j < max_levels; ++j) row[j] = -1;
    int64_t n_levels = 0;
    int64_t level_start = 0;
    bool overflow = false;
    for (int64_t p = 0; p <= tlen; ++p) {
      if (p == tlen || start[p] == '/') {
        if (n_levels >= max_levels) {
          overflow = true;
          break;
        }
        row[n_levels] = map.find(start + level_start, p - level_start);
        ++n_levels;
        level_start = p + 1;
      }
    }
    if (overflow) {
      lengths[i] = -1;
      for (int64_t j = 0; j < max_levels; ++j) row[j] = -1;
    } else {
      lengths[i] = static_cast<int32_t>(n_levels);
    }
    topic_start = end + 1;
    ++i;
  }
}

// One-pass compact tokenizer for the signature matcher
// (maxmq_tpu/matching/sig.py:tokenize_compact semantics, which MUST stay
// identical — parity-tested from tests/test_native.py):
//   * topics arrive NUL-joined as in mq_tokenize_joined;
//   * toks_out: narrow window tokens [n, window] — uint8 (pad 255),
//     uint16 (pad 65535) or int32 (pad -1) per tok_mode in {1, 2, 4};
//   * lens_out: int8 — sign carries the '$'-flag, |value| = TRUE depth
//     (up to 63; deeper encodes ±127 = overflow);
//   * esig_out: uint32 — the host-exact-group signature
//     sum(coef[depth][pos] * tok[pos]) + dc[depth] * depth for topics
//     whose depth has a full-exact group (exact_present[depth]); 0
//     otherwise (callers mask by depth, 0 is not a sentinel).
// exact_coef is row-major [max_exact_d + 1, max_exact_d].
void mq_tokenize_sig(void* v, const char* buf, int64_t buf_len,
                     int64_t n_topics, int64_t window, int32_t tok_mode,
                     const uint32_t* exact_coef, const uint32_t* exact_dc,
                     const uint8_t* exact_present, int64_t max_exact_d,
                     void* toks_out, int8_t* lens_out, uint32_t* esig_out) {
  Vocab* vb = static_cast<Vocab*>(v);
  vb->ensure_built();
  const Vocab& map = *vb;
  constexpr int64_t kDepthCap = 63;
  uint8_t* t8 = static_cast<uint8_t*>(toks_out);
  uint16_t* t16 = static_cast<uint16_t*>(toks_out);
  int32_t* t32 = static_cast<int32_t*>(toks_out);
  int64_t topic_start = 0;
  int64_t i = 0;
  int32_t level_toks[kDepthCap];
  for (int64_t end = 0; end <= buf_len && i < n_topics; ++end) {
    if (end != buf_len && buf[end] != '\0') continue;
    const char* start = buf + topic_start;
    const int64_t tlen = end - topic_start;
    const bool dollar = tlen > 0 && start[0] == '$';

    int64_t n_levels = 0;
    int64_t level_start = 0;
    bool overflow = false;
    for (int64_t p = 0; p <= tlen; ++p) {
      if (p == tlen || start[p] == '/') {
        if (n_levels >= kDepthCap) {
          overflow = true;
          break;
        }
        level_toks[n_levels++] =
            map.find(start + level_start, p - level_start);
        level_start = p + 1;
      }
    }

    const int8_t depth8 =
        overflow ? int8_t{127} : static_cast<int8_t>(n_levels);
    lens_out[i] = dollar ? static_cast<int8_t>(-depth8) : depth8;

    for (int64_t j = 0; j < window; ++j) {
      const bool real = !overflow && j < n_levels;
      const int32_t tok = real ? level_toks[j] : -1;
      switch (tok_mode) {
        case 1: t8[i * window + j] = real ? static_cast<uint8_t>(tok) : 255;
                break;
        case 2: t16[i * window + j] =
                    real ? static_cast<uint16_t>(tok) : 65535;
                break;
        default: t32[i * window + j] = tok;
      }
    }

    uint32_t esig = 0;
    if (!overflow && n_levels <= max_exact_d && exact_present[n_levels]) {
      const uint32_t* coef = exact_coef + n_levels * max_exact_d;
      for (int64_t p = 0; p < n_levels; ++p)
        esig += coef[p] * static_cast<uint32_t>(level_toks[p]);
      esig += exact_dc[n_levels] * static_cast<uint32_t>(n_levels);
    }
    esig_out[i] = esig;

    topic_start = end + 1;
    ++i;
  }
}

// ---------------------------------------------------------------------
// Host probe: every exact-shape filter group (full-literal and '+') as a
// hashed-equality binary search. The device keeps only '#'-prefix groups;
// this is the host half of the transfer-optimal split
// (maxmq_tpu/matching/sig.py:host_plus_rows is the numpy twin).

void* mq_probe_new() { return new ProbeSet(); }

void mq_probe_free(void* h) { delete static_cast<ProbeSet*>(h); }

void mq_probe_add_group(void* h, int32_t depth, uint8_t wildf, uint32_t dc,
                        const uint32_t* coef, const uint32_t* sigs,
                        const int32_t* rows, int64_t n) {
  auto* set = static_cast<ProbeSet*>(h);
  ProbeGroup g;
  g.depth = depth;
  g.wildf = wildf != 0;
  g.dc = dc;
  g.coef.assign(coef, coef + depth);
  g.sigs.assign(sigs, sigs + n);
  g.rows.assign(rows, rows + n);
  g.build_table();
  if (static_cast<size_t>(depth) >= set->by_depth.size())
    set->by_depth.resize(depth + 1);
  set->by_depth[depth].push_back(static_cast<int32_t>(set->groups.size()));
  set->groups.push_back(std::move(g));
}

// Flip the set to '#'-prefix (depth >=) semantics. Call AFTER every
// add_group: the depth-ascending iteration order is frozen here.
void mq_probe_set_ge(void* h) {
  auto* set = static_cast<ProbeSet*>(h);
  set->ge_depth = true;
  set->ge_sorted.resize(set->groups.size());
  for (size_t i = 0; i < set->groups.size(); ++i)
    set->ge_sorted[i] = static_cast<int32_t>(i);
  std::sort(set->ge_sorted.begin(), set->ge_sorted.end(),
            [set](int32_t a, int32_t b) {
              return set->groups[a].depth < set->groups[b].depth;
            });
}

// Probe n topics (narrow tokens as in mq_tokenize_sig: tok_mode 1/2/4,
// row-major [n, window]; lens_enc int8 sign='$' |v|=depth, 127=overflow).
// Emits (topic id, row id) hit pairs in topic order. Returns the total
// hit count; pairs beyond `cap` are not written (the caller re-invokes
// with a larger buffer — hits average ~1/topic, so this is rare).
int64_t mq_probe_run(void* h, const void* toks, int32_t tok_mode,
                     const int8_t* lens_enc, int64_t n, int64_t window,
                     int64_t* out_ti, int32_t* out_row, int64_t cap,
                     int32_t n_threads) {
  const auto* set = static_cast<ProbeSet*>(h);
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
    if (n_threads > 8) n_threads = 8;
  }
  if (n < 4096) n_threads = 1;

  std::vector<std::vector<int64_t>> ti(n_threads);
  std::vector<std::vector<int32_t>> rw(n_threads);
  auto worker = [&](int32_t t) {
    const int64_t lo = n * t / n_threads;
    const int64_t hi = n * (t + 1) / n_threads;
    auto& ti_t = ti[t];
    auto& rw_t = rw[t];
    for (int64_t i = lo; i < hi; ++i) {
      const int8_t le = lens_enc[i];
      const bool dollar = le < 0;
      const int32_t depth = le < 0 ? -le : le;
      if (depth >= 127)
        continue;  // overflow topics go to the CPU-trie fallback
      if (!set->ge_depth &&
          static_cast<size_t>(depth) >= set->by_depth.size())
        continue;
      const auto& gids =
          set->ge_depth ? set->ge_sorted : set->by_depth[depth];
      for (const int32_t gi : gids) {
        const ProbeGroup& g = set->groups[gi];
        if (set->ge_depth && g.depth > depth) break;  // depth-ascending
        if ((g.wildf && dollar) || g.depth > window) continue;
        uint32_t sig = g.dc;
        const int64_t base = i * window;
        for (int32_t p = 0; p < g.depth; ++p)
          sig += g.coef[p] * tok_at(toks, tok_mode, base + p);
        int32_t j = g.probe(sig);
        for (; j >= 0 && static_cast<size_t>(j) < g.sigs.size() &&
               g.sigs[j] == sig; ++j) {
          ti_t.push_back(i);
          rw_t.push_back(g.rows[j]);
        }
      }
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }

  int64_t total = 0;
  for (const auto& v : ti) total += static_cast<int64_t>(v.size());
  if (total <= cap) {
    int64_t off = 0;
    for (int32_t t = 0; t < n_threads; ++t) {
      std::copy(ti[t].begin(), ti[t].end(), out_ti + off);
      std::copy(rw[t].begin(), rw[t].end(), out_row + off);
      off += static_cast<int64_t>(ti[t].size());
    }
  }
  return total;
}

// Fused single-pass host half of the signature match: tokenize (narrow
// window form, as mq_tokenize_sig) AND probe every exact-shape group of
// the topic's depth while the level tokens are still in registers. This
// is the publish-path entry on a single-core host — one pass over the
// topic bytes, no intermediate arrays re-read.
// Outputs: toks_out/lens_out as mq_tokenize_sig; (ti_out, row_out) hit
// pairs in topic order (up to cap — returns the total regardless, the
// caller re-invokes with a larger buffer when total > cap).
}  // extern "C" (the range worker below is a C++ template)

namespace {

// One contiguous topic range of the fused tokenize+probe (the worker
// body shared by the single-thread and threaded paths). ``tstarts``
// holds n_topics+1 byte offsets: topic i spans
// [tstarts[i], tstarts[i+1]-1) (the -1 drops the '\0' separator; the
// final sentinel is buf_len+1 so the last, unterminated topic spans to
// buf_len).
template <typename Sink>
void tokenize_probe_range(const Vocab& map, const ProbeSet* set,
                          const char* buf, const int64_t* tstarts,
                          int64_t lo, int64_t hi, int64_t window,
                          int32_t tok_mode, void* toks_out,
                          int8_t* lens_out, Sink&& emit) {
  constexpr int64_t kDepthCap = 63;
  uint8_t* t8 = static_cast<uint8_t*>(toks_out);
  uint16_t* t16 = static_cast<uint16_t*>(toks_out);
  int32_t* t32 = static_cast<int32_t*>(toks_out);
  int32_t level_toks[kDepthCap];
  for (int64_t i = lo; i < hi; ++i) {
    const char* start = buf + tstarts[i];
    const int64_t tlen = tstarts[i + 1] - 1 - tstarts[i];
    const bool dollar = tlen > 0 && start[0] == '$';

    int64_t n_levels = 0;
    int64_t level_start = 0;
    bool overflow = false;
    for (int64_t p = 0; p <= tlen; ++p) {
      if (p == tlen || start[p] == '/') {
        if (n_levels >= kDepthCap) {
          overflow = true;
          break;
        }
        level_toks[n_levels++] =
            map.find(start + level_start, p - level_start);
        level_start = p + 1;
      }
    }

    const int8_t depth8 =
        overflow ? int8_t{127} : static_cast<int8_t>(n_levels);
    lens_out[i] = dollar ? static_cast<int8_t>(-depth8) : depth8;

    for (int64_t j = 0; j < window; ++j) {
      const bool real = !overflow && j < n_levels;
      const int32_t tok = real ? level_toks[j] : -1;
      switch (tok_mode) {
        case 1: t8[i * window + j] = real ? static_cast<uint8_t>(tok) : 255;
                break;
        case 2: t16[i * window + j] =
                    real ? static_cast<uint16_t>(tok) : 65535;
                break;
        default: t32[i * window + j] = tok;
      }
    }

    if (!overflow &&
        static_cast<size_t>(n_levels) < set->by_depth.size()) {
      for (const int32_t gi : set->by_depth[n_levels]) {
        const ProbeGroup& g = set->groups[gi];
        if (g.wildf && dollar) continue;
        uint32_t sig = g.dc;
        for (int32_t p = 0; p < g.depth; ++p)
          sig += g.coef[p] * static_cast<uint32_t>(level_toks[p]);
        int32_t j = g.probe(sig);
        for (; j >= 0 && static_cast<size_t>(j) < g.sigs.size() &&
               g.sigs[j] == sig; ++j) {
          emit(i, g.rows[j]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t mq_tokenize_probe(void* v, void* h, const char* buf, int64_t buf_len,
                          int64_t n_topics, int64_t window, int32_t tok_mode,
                          void* toks_out, int8_t* lens_out, int64_t* ti_out,
                          int32_t* row_out, int64_t cap) {
  Vocab* vb = static_cast<Vocab*>(v);
  vb->ensure_built();
  const Vocab& map = *vb;
  const ProbeSet* set = static_cast<ProbeSet*>(h);
  if (n_topics <= 0) return 0;

  // topic boundaries ('\0'-joined buffer, exactly n_topics-1 separators)
  std::vector<int64_t> tstarts(n_topics + 1);
  tstarts[0] = 0;
  int64_t idx = 0;
  for (int64_t e = 0; e < buf_len && idx < n_topics - 1; ++e)
    if (buf[e] == '\0') tstarts[++idx] = e + 1;
  tstarts[n_topics] = buf_len + 1;

  int32_t n_threads =
      static_cast<int32_t>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (n_topics < 16384) n_threads = 1;

  if (n_threads == 1) {
    // publish hot path: write hits straight into the caller's buffers
    // (partial fill up to cap, total returned regardless) — no
    // per-call vectors beyond the boundary index
    int64_t hits = 0;
    tokenize_probe_range(map, set, buf, tstarts.data(), 0, n_topics,
                         window, tok_mode, toks_out, lens_out,
                         [&](int64_t i, int32_t r) {
                           if (hits < cap) {
                             ti_out[hits] = i;
                             row_out[hits] = r;
                           }
                           ++hits;
                         });
    return hits;
  }

  std::vector<std::vector<int64_t>> ti(n_threads);
  std::vector<std::vector<int32_t>> rw(n_threads);
  auto worker = [&](int32_t t) {
    auto& ti_t = ti[t];
    auto& rw_t = rw[t];
    tokenize_probe_range(map, set, buf, tstarts.data(),
                         n_topics * t / n_threads,
                         n_topics * (t + 1) / n_threads, window, tok_mode,
                         toks_out, lens_out,
                         [&](int64_t i, int32_t r) {
                           ti_t.push_back(i);
                           rw_t.push_back(r);
                         });
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (const auto& vv : ti) total += static_cast<int64_t>(vv.size());
  int64_t off = 0;
  for (int32_t t = 0; t < n_threads && off < cap; ++t) {
    const int64_t take = std::min<int64_t>(
        static_cast<int64_t>(ti[t].size()), cap - off);
    std::copy(ti[t].begin(), ti[t].begin() + take, ti_out + off);
    std::copy(rw[t].begin(), rw[t].begin() + take, row_out + off);
    off += take;
  }
  return total;
}

// Scan `buf` (len bytes) for complete MQTT control-packet frames.
// For each complete frame i < max_frames: starts[i] = offset of the fixed
// header byte, totals[i] = total frame size (header + varint + body).
// Returns the number of complete frames found (scanning stops at the first
// incomplete frame — its offset is *consumed_out), or -1 if a malformed
// variable-byte integer is encountered (more than 4 continuation bytes,
// MQTT-1.5.5) or a zero packet type.
int64_t mq_scan_frames(const uint8_t* buf, int64_t len, int64_t* starts,
                       int64_t* totals, int64_t max_frames,
                       int64_t* consumed_out) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos < len && count < max_frames) {
    if ((buf[pos] >> 4) == 0) {
      *consumed_out = pos;
      return -1;  // packet type 0 is reserved/invalid
    }
    // variable-byte integer remaining length
    int64_t rem = 0;
    int shift = 0;
    int64_t vpos = pos + 1;
    bool complete = false;
    while (vpos < len) {
      uint8_t b = buf[vpos++];
      rem |= static_cast<int64_t>(b & 0x7F) << shift;
      shift += 7;
      if ((b & 0x80) == 0) {
        complete = true;
        break;
      }
      if (shift > 21) {
        *consumed_out = pos;
        return -1;  // > 4 varint bytes is malformed [MQTT-1.5.5]
      }
    }
    if (!complete) break;  // header truncated: wait for more bytes
    const int64_t total = (vpos - pos) + rem;
    if (pos + total > len) break;  // body truncated
    starts[count] = pos;
    totals[count] = total;
    ++count;
    pos += total;
  }
  *consumed_out = pos;
  return count;
}

}  // extern "C"
