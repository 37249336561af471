// daft_tpu_torch native host kernels (a copy of daft_tpu/native/src/kernels.cpp).
//
// Native (C++) equivalents of the reference engine's Rust data-plane crates
// that have no XLA analogue — row hashing (src/daft-core/src/array/ops/hash.rs,
// src/daft-hash), hash fanout partitioning (src/daft-recordbatch/src/ops/
// partition.rs:53-104), minhash (src/daft-minhash/src/lib.rs), and
// HyperLogLog (src/hyperloglog/src/lib.rs). Algorithms are implemented from
// their public specifications (xxHash64, MurmurHash3 x86_32, HLL++ bias-free
// variant), not translated from the reference sources.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All buffers are caller-allocated numpy arrays; sizes are int64_t.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash64 (public spec: https://github.com/Cyan4973/xxHash) — scalar
// implementation, used for both fixed-width and variable-width row hashing.
// ---------------------------------------------------------------------------

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint64_t xxh64_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  acc *= P1;
  return acc;
}

static inline uint64_t xxh64_merge_round(uint64_t acc, uint64_t val) {
  val = xxh64_round(0, val);
  acc ^= val;
  acc = acc * P1 + P4;
  return acc;
}

static uint64_t xxh64(const uint8_t* data, int64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    do {
      v1 = xxh64_round(v1, read64(p)); p += 8;
      v2 = xxh64_round(v2, read64(p)); p += 8;
      v3 = xxh64_round(v3, read64(p)); p += 8;
      v4 = xxh64_round(v4, read64(p)); p += 8;
    } while (p <= end - 32);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh64_merge_round(h, v1);
    h = xxh64_merge_round(h, v2);
    h = xxh64_merge_round(h, v3);
    h = xxh64_merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh64_round(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

uint64_t dn_xxh64(const uint8_t* data, int64_t len, uint64_t seed) {
  return xxh64(data, len, seed);
}

// Hash each fixed-width element (stride bytes). Invalid rows (valid bitmap
// byte == 0) get NULL_HASH so nulls compare equal in group-by/join keys.
static const uint64_t NULL_HASH = 0x9E3779B97F4A7C15ULL;

void dn_hash_fixed(const uint8_t* data, int64_t n, int64_t stride,
                   const uint8_t* valid, uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    if (valid && !valid[i]) {
      out[i] = NULL_HASH ^ seed;
    } else {
      out[i] = xxh64(data + i * stride, stride, seed);
    }
  }
}

// Hash variable-width rows given int64 offsets into a flat byte buffer
// (Arrow large_binary layout).
void dn_hash_var(const int64_t* offsets, const uint8_t* data, int64_t n,
                 const uint8_t* valid, uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    if (valid && !valid[i]) {
      out[i] = NULL_HASH ^ seed;
    } else {
      out[i] = xxh64(data + offsets[i], offsets[i + 1] - offsets[i], seed);
    }
  }
}

// Combine a row-hash column with a per-row seed column (multi-key hashing):
// splitmix64 finalizer over (h ^ seed), matching the Python fallback.
void dn_hash_combine(const uint64_t* h, const uint64_t* seed, int64_t n,
                     uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t x = h[i] ^ seed[i];
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    out[i] = x ^ (x >> 31);
  }
}

// MurmurHash3 x86_32 (public spec) — parity with src/daft-hash's murmur3.
uint32_t dn_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
  uint32_t h = seed;
  int64_t nblocks = len / 4;
  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k = read32(data + i * 4);
    k *= c1; k = (k << 15) | (k >> 17); k *= c2;
    h ^= k; h = (h << 13) | (h >> 19); h = h * 5 + 0xe6546b64;
  }
  uint32_t k = 0;
  const uint8_t* tail = data + nblocks * 4;
  switch (len & 3) {
    case 3: k ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2: k ^= (uint32_t)tail[1] << 8;  [[fallthrough]];
    case 1: k ^= tail[0];
      k *= c1; k = (k << 15) | (k >> 17); k *= c2; h ^= k;
  }
  h ^= (uint32_t)len;
  h ^= h >> 16; h *= 0x85ebca6b; h ^= h >> 13; h *= 0xc2b2ae35; h ^= h >> 16;
  return h;
}

// ---------------------------------------------------------------------------
// Hash fanout partitioning: pid = h % nparts, then counting-sort row indices
// into per-partition contiguous runs (one pass, no per-partition scans).
// counts: [nparts], indices: [n] (gather list; partition p's rows live at
// indices[starts[p] .. starts[p]+counts[p])).
// ---------------------------------------------------------------------------

void dn_fanout_hash(const uint64_t* h, int64_t n, int64_t nparts,
                    int64_t* counts, int64_t* indices, int64_t* pid_out) {
  std::memset(counts, 0, sizeof(int64_t) * nparts);
  for (int64_t i = 0; i < n; i++) {
    int64_t p = (int64_t)(h[i] % (uint64_t)nparts);
    if (pid_out) pid_out[i] = p;
    counts[p]++;
  }
  std::vector<int64_t> cursor(nparts, 0);
  int64_t acc = 0;
  for (int64_t p = 0; p < nparts; p++) { cursor[p] = acc; acc += counts[p]; }
  for (int64_t i = 0; i < n; i++) {
    int64_t p = (int64_t)(h[i] % (uint64_t)nparts);
    indices[cursor[p]++] = i;
  }
}

// Same counting sort for precomputed partition ids (range/random fanout).
void dn_fanout_pid(const int64_t* pid, int64_t n, int64_t nparts,
                   int64_t* counts, int64_t* indices) {
  std::memset(counts, 0, sizeof(int64_t) * nparts);
  for (int64_t i = 0; i < n; i++) counts[pid[i]]++;
  std::vector<int64_t> cursor(nparts, 0);
  int64_t acc = 0;
  for (int64_t p = 0; p < nparts; p++) { cursor[p] = acc; acc += counts[p]; }
  for (int64_t i = 0; i < n; i++) indices[cursor[pid[i]]++] = i;
}

// ---------------------------------------------------------------------------
// MinHash (near-duplicate detection). Word-level shingles of `ngram_size`
// tokens; k permutations h_j = (a_j * x + b_j) mod p over xxh64 token-window
// hashes; output the per-permutation minimum as u32 (reference signature:
// src/daft-minhash/src/lib.rs — same contract, independent implementation).
// ---------------------------------------------------------------------------

static const uint64_t MERSENNE_P = (1ULL << 61) - 1;

static inline uint64_t mulmod61(uint64_t a, uint64_t b) {
  __uint128_t r = (__uint128_t)a * b;
  uint64_t lo = (uint64_t)(r & MERSENNE_P);
  uint64_t hi = (uint64_t)(r >> 61);
  uint64_t s = lo + hi;
  if (s >= MERSENNE_P) s -= MERSENNE_P;
  return s;
}

// xorshift generator for permutation coefficients (deterministic in seed)
static inline uint64_t next_rand(uint64_t* state) {
  uint64_t x = *state;
  x ^= x << 13; x ^= x >> 7; x ^= x << 17;
  *state = x;
  return x;
}

void dn_minhash(const int64_t* offsets, const uint8_t* data, int64_t n,
                const uint8_t* valid, int32_t num_hashes, int32_t ngram_size,
                uint64_t seed, uint32_t* out /* [n * num_hashes] */) {
  std::vector<uint64_t> perm_a(num_hashes), perm_b(num_hashes);
  uint64_t st = seed ? seed : 1;
  for (int32_t j = 0; j < num_hashes; j++) {
    perm_a[j] = next_rand(&st) % (MERSENNE_P - 1) + 1;
    perm_b[j] = next_rand(&st) % MERSENNE_P;
  }
  std::vector<int64_t> word_starts;
  std::vector<int64_t> word_ends;
  for (int64_t i = 0; i < n; i++) {
    uint32_t* row = out + i * num_hashes;
    if (valid && !valid[i]) {
      std::fill(row, row + num_hashes, 0xFFFFFFFFu);
      continue;
    }
    const uint8_t* s = data + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    // split on ASCII whitespace
    word_starts.clear(); word_ends.clear();
    int64_t w = -1;
    for (int64_t k = 0; k < len; k++) {
      bool ws = s[k] == ' ' || s[k] == '\t' || s[k] == '\n' || s[k] == '\r';
      if (!ws && w < 0) w = k;
      if (ws && w >= 0) { word_starts.push_back(w); word_ends.push_back(k); w = -1; }
    }
    if (w >= 0) { word_starts.push_back(w); word_ends.push_back(len); }
    int64_t nwords = (int64_t)word_starts.size();
    std::fill(row, row + num_hashes, 0xFFFFFFFFu);
    if (nwords == 0) continue;
    int64_t nshingles = std::max<int64_t>(1, nwords - ngram_size + 1);
    for (int64_t sh = 0; sh < nshingles; sh++) {
      int64_t last = std::min<int64_t>(sh + ngram_size, nwords) - 1;
      // hash the byte span covering the shingle's words (incl. separators)
      uint64_t hv = xxh64(s + word_starts[sh],
                          word_ends[last] - word_starts[sh], 42);
      hv &= MERSENNE_P;  // into field
      for (int32_t j = 0; j < num_hashes; j++) {
        uint64_t ph = mulmod61(perm_a[j], hv) + perm_b[j];
        if (ph >= MERSENNE_P) ph -= MERSENNE_P;
        uint32_t v = (uint32_t)(ph & 0xFFFFFFFFu);
        if (v < row[j]) row[j] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// HyperLogLog (dense, 2^p registers; standard HLL estimator with small-range
// linear counting correction — same contract as src/hyperloglog).
// ---------------------------------------------------------------------------

void dn_hll_add(uint8_t* registers, int32_t p, const uint64_t* hashes,
                int64_t n) {
  int64_t m = 1LL << p;
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = hashes[i];
    uint64_t idx = h >> (64 - p);
    uint64_t rest = h << p;
    uint8_t rho = rest == 0 ? (uint8_t)(64 - p + 1)
                            : (uint8_t)(__builtin_clzll(rest) + 1);
    if (rho > registers[idx]) registers[idx] = rho;
    (void)m;
  }
}

void dn_hll_merge(uint8_t* dst, const uint8_t* src, int64_t m) {
  for (int64_t i = 0; i < m; i++) dst[i] = std::max(dst[i], src[i]);
}

double dn_hll_estimate(const uint8_t* registers, int32_t p) {
  int64_t m = 1LL << p;
  double alpha;
  switch (m) {
    case 16: alpha = 0.673; break;
    case 32: alpha = 0.697; break;
    case 64: alpha = 0.709; break;
    default: alpha = 0.7213 / (1.0 + 1.079 / (double)m);
  }
  double sum = 0.0;
  int64_t zeros = 0;
  for (int64_t i = 0; i < m; i++) {
    sum += std::ldexp(1.0, -registers[i]);
    if (registers[i] == 0) zeros++;
  }
  double e = alpha * m * m / sum;
  if (e <= 2.5 * m && zeros > 0) {
    e = m * std::log((double)m / zeros);  // linear counting
  }
  return e;
}

// ---------------------------------------------------------------------------
// Hash-join probe table: build u64-hash → row-chain map over the build side,
// then stream probe hashes to emit (probe_idx, build_idx) candidate pairs.
// Callers verify key equality on the emitted pairs (hash collisions), the
// same split as the reference's probeable/probe_table.rs contract.
// ---------------------------------------------------------------------------

struct ProbeTable {
  std::vector<int64_t> heads;   // bucket -> first row (or -1)
  std::vector<int64_t> next;    // row -> next row in chain (or -1)
  std::vector<uint64_t> hashes; // build-side row hashes
  uint64_t mask;
};

void* dn_probe_build(const uint64_t* h, int64_t n) {
  auto* t = new ProbeTable();
  int64_t cap = 16;
  while (cap < n * 2) cap <<= 1;
  t->mask = (uint64_t)(cap - 1);
  t->heads.assign(cap, -1);
  t->next.assign(n, -1);
  t->hashes.assign(h, h + n);
  for (int64_t i = 0; i < n; i++) {
    uint64_t b = h[i] & t->mask;
    t->next[i] = t->heads[b];
    t->heads[b] = i;
  }
  return t;
}

// Emits up to cap pairs; returns number of pairs written. `state` carries the
// resume position ({probe_idx, chain_pos}) so callers can loop on overflow.
int64_t dn_probe_run(void* table, const uint64_t* probe_h, int64_t n_probe,
                     int64_t* out_probe, int64_t* out_build, int64_t cap,
                     int64_t* state /* [2] */) {
  auto* t = (ProbeTable*)table;
  int64_t written = 0;
  int64_t i = state[0];
  int64_t chain = state[1];
  for (; i < n_probe; i++) {
    uint64_t h = probe_h[i];
    int64_t j = chain >= 0 ? chain : t->heads[h & t->mask];
    chain = -1;
    while (j >= 0) {
      if (t->hashes[j] == h) {
        if (written == cap) { state[0] = i; state[1] = j; return written; }
        out_probe[written] = i;
        out_build[written] = j;
        written++;
      }
      j = t->next[j];
    }
  }
  state[0] = n_probe;
  state[1] = -1;
  return written;
}

void dn_probe_free(void* table) { delete (ProbeTable*)table; }

// ---------------------------------------------------------------------------
// BPE vocabulary + greedy lowest-rank merge encoding (the tokenize hot loop;
// reference capability: src/daft-functions-tokenize over tiktoken). The
// vocabulary maps byte sequences → ranks; encoding repeatedly merges the
// adjacent pair with the lowest rank until no merge applies.

struct BpeVocab {
  // flat storage of tokens, looked up through an open-addressing table of
  // (hash, offset, len, rank)
  std::vector<uint8_t> bytes;
  std::vector<int64_t> offs;   // n+1 offsets into bytes
  std::vector<int32_t> ranks;  // rank per token
  std::vector<int64_t> slots;  // hash table: index into offs/ranks, -1 empty
  uint64_t mask = 0;

  int32_t lookup(const uint8_t* p, int64_t len) const {
    uint64_t h = xxh64(p, len, 0);
    uint64_t i = h & mask;
    while (true) {
      int64_t s = slots[i];
      if (s < 0) return -1;
      int64_t tl = offs[s + 1] - offs[s];
      if (tl == len && std::memcmp(&bytes[offs[s]], p, len) == 0)
        return ranks[s];
      i = (i + 1) & mask;
    }
  }
};

void* dn_bpe_build(const int64_t* offsets, const uint8_t* data,
                   const int32_t* ranks, int64_t n) {
  auto* v = new BpeVocab();
  int64_t total = offsets[n];
  v->bytes.assign(data, data + total);
  v->offs.assign(offsets, offsets + n + 1);
  v->ranks.assign(ranks, ranks + n);
  int64_t cap = 16;
  while (cap < n * 2) cap <<= 1;
  v->mask = (uint64_t)cap - 1;
  v->slots.assign(cap, -1);
  for (int64_t s = 0; s < n; s++) {
    const uint8_t* p = &v->bytes[v->offs[s]];
    int64_t len = v->offs[s + 1] - v->offs[s];
    uint64_t i = xxh64(p, len, 0) & v->mask;
    while (v->slots[i] >= 0) i = (i + 1) & v->mask;
    v->slots[i] = s;
  }
  return v;
}

static int64_t bpe_encode_one(const BpeVocab* v, const uint8_t* piece,
                              int64_t len, int32_t* out) {
  if (len == 0) return 0;
  int32_t whole = v->lookup(piece, len);
  if (whole >= 0) { out[0] = whole; return 1; }
  // parts as (start, len) plus the rank of each adjacent pair; a merge
  // only invalidates the two pair-ranks touching the merge point, so each
  // iteration costs one O(n) min-scan + two lookups (the tiktoken
  // recipe), not a full pair-rank recomputation
  std::vector<int64_t> starts(len), lens(len, 1);
  std::vector<int32_t> pair_rank(len > 1 ? len - 1 : 0);
  for (int64_t i = 0; i < len; i++) starts[i] = i;
  int64_t nparts = len;
  for (int64_t i = 0; i + 1 < nparts; i++)
    pair_rank[i] = v->lookup(piece + starts[i], 2);
  while (nparts > 1) {
    int32_t best_rank = -1;
    int64_t best_i = -1;
    for (int64_t i = 0; i + 1 < nparts; i++) {
      int32_t r = pair_rank[i];
      if (r >= 0 && (best_rank < 0 || r < best_rank)) {
        best_rank = r;
        best_i = i;
      }
    }
    if (best_i < 0) break;
    lens[best_i] += lens[best_i + 1];
    for (int64_t i = best_i + 1; i + 1 < nparts; i++) {
      starts[i] = starts[i + 1];
      lens[i] = lens[i + 1];
      if (i + 2 < nparts) pair_rank[i] = pair_rank[i + 1];
    }
    nparts--;
    if (best_i > 0)
      pair_rank[best_i - 1] = v->lookup(
          piece + starts[best_i - 1], lens[best_i - 1] + lens[best_i]);
    if (best_i + 1 < nparts)
      pair_rank[best_i] = v->lookup(
          piece + starts[best_i], lens[best_i] + lens[best_i + 1]);
  }
  for (int64_t i = 0; i < nparts; i++) {
    int32_t r = v->lookup(piece + starts[i], lens[i]);
    if (r < 0) return -1;
    out[i] = r;
  }
  return nparts;
}

// Encode one pretokenized piece. Returns the number of ids written (≤ len),
// or -1 if some byte sequence has no rank (vocab lacks single-byte tokens).
int64_t dn_bpe_encode(void* vocab, const uint8_t* piece, int64_t len,
                      int32_t* out) {
  return bpe_encode_one((BpeVocab*)vocab, piece, len, out);
}

// Encode a batch of pretokenized pieces in one call (amortizes the FFI
// round-trip — the per-piece path loses to call overhead on short pieces).
// out must hold piece_offs[n_pieces] ids; out_counts[i] receives piece i's
// id count. Returns total ids written, or -1 on an uncovered sequence.
int64_t dn_bpe_encode_batch(void* vocab, const int64_t* piece_offs,
                            const uint8_t* data, int64_t n_pieces,
                            int32_t* out, int64_t* out_counts) {
  auto* v = (BpeVocab*)vocab;
  int64_t pos = 0;
  for (int64_t p = 0; p < n_pieces; p++) {
    int64_t wrote = bpe_encode_one(v, data + piece_offs[p],
                                   piece_offs[p + 1] - piece_offs[p],
                                   out + pos);
    if (wrote < 0) return -1;
    out_counts[p] = wrote;
    pos += wrote;
  }
  return pos;
}

void dn_bpe_free(void* vocab) { delete (BpeVocab*)vocab; }

}  // extern "C"
