// Native unigram-LM tokeniser engine for intrepppid_tpu_torch (a copy of
// intrepppid_tpu/native/spm_unigram.cc).
//
// The reference offloads tokenisation to the SentencePiece C++ library
// (`intrepppid/data/ppi_oma.py:313,375`); this framework ships its own
// engine instead. Host-side tokenisation is the data-path hot loop (five
// sampled encodes per training sample per epoch, SURVEY.md §3.1), so the
// production path is C++ (this file, loaded via ctypes) with the
// pure-Python engine in data/spm/unigram.py as fallback and test oracle.
//
// Implements, over a SentencePiece ModelProto (.model file):
//   * minimal protobuf wire parsing of pieces / trainer_spec / normalizer_spec
//   * Viterbi segmentation (deterministic encode)
//   * forward-filtering backward-sampling subword regularisation
//     (enable_sampling=true, alpha, nbest_size=-1 semantics; Kudo 2018)
//   * unknown chars -> unk_id with SentencePiece's min_score - 10.0 penalty
//
// Input strings must already be normalised (the Python facade applies the
// normalizer spec; for amino-acid sequences it is the identity).
//
// Build: see Makefile (g++ -O3 -shared -fPIC). C API only — consumed with
// ctypes, no pybind11 dependency.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <climits>
#include <limits>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <thread>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kUnkPenalty = 10.0f;

struct Piece {
  std::string text;
  float score;
  int type;  // 1=NORMAL 2=UNKNOWN 3=CONTROL 4=USER_DEFINED 5=UNUSED 6=BYTE
};

// ------------------------------------------------------------ proto reader

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

bool ReadVarint(Cursor& c, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (c.p < c.end) {
    uint8_t b = *c.p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

bool SkipField(Cursor& c, uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0:
      return ReadVarint(c, &tmp);
    case 1:
      if (c.end - c.p < 8) return false;
      c.p += 8;
      return true;
    case 2:
      if (!ReadVarint(c, &tmp)) return false;
      if (static_cast<uint64_t>(c.end - c.p) < tmp) return false;
      c.p += tmp;
      return true;
    case 5:
      if (c.end - c.p < 4) return false;
      c.p += 4;
      return true;
    default:
      return false;
  }
}

struct TrieNode {
  // Map-keyed children, used only while building; the encode hot paths use
  // the flattened arrays below (one L1-friendly indexed load per char
  // instead of a hash probe — measured ~5x on the batch encode).
  std::unordered_map<uint8_t, int> children;
  int piece_id = -1;
  float score = 0.0f;
};

// FFBS lattice in CSR form, edges for END position e at [off[e], off[e+1])
// in the forward pass's insertion order (starts ascending). Everything the
// backward-sampling pass reads — the forward filter itself is RNG-free and
// depends only on (text, alpha), so one build serves every epoch's fresh
// sampling draws. The per-node categorical over incoming edges is stored
// as a Walker/Vose alias table built from the edge masses in each end
// position's power-of-two scale exactly as the forward pass cached them
// (the distribution takes ratios within one end position only, so no
// scales are needed); the raw masses themselves are dropped after the
// alias build. All per-edge fields live in ONE 16-byte record so a
// sampled step's two edge touches (alias probe, chosen edge) cost one
// cache line each — the 4-parallel-array layout paid ~5 line fetches
// per piece from a multi-MB working set.
struct Edge {
  int32_t start;
  int32_t pid;
  float aprob;   // alias threshold in [0,1]
  int32_t aidx;  // alias target (absolute edge index), -1 = unsampleable
};
static_assert(sizeof(Edge) == 16, "Edge must pack to one 16-byte record");

struct CachedLattice {
  std::vector<int32_t> off;  // n+2 entries
  std::vector<Edge> edges;
  size_t bytes() const {
    return off.capacity() * 4 + edges.capacity() * sizeof(Edge) +
           sizeof(*this);
  }
};

struct Model {
  std::vector<Piece> pieces;
  std::vector<TrieNode> trie;
  int unk_id = 0;
  int bos_id = 1;
  int eos_id = 2;
  int pad_id = -1;
  int max_piece_len = 1;
  // byte-fallback: UTF-8 byte value -> BYTE piece id ("<0xNN>"), -1 if the
  // model defines no such piece. Substitution happens at OUTPUT time (after
  // the lattice search), exactly like SentencePieceProcessor's byte
  // fallback; the lattice itself keeps the per-char unk edge and penalty.
  int byte_ids[256];
  float unk_score = -kUnkPenalty;
  // flattened trie: next[node*256+byte] -> node or -1; pid/score per node
  std::vector<int32_t> flat_next;
  std::vector<int32_t> flat_pid;
  std::vector<float> flat_score;
  // probability-space FFBS: exp(alpha * score) per trie node, precomputed
  // once per alpha (the lattice forward/backward then needs ZERO
  // transcendentals — pure multiply-adds; see SampleEncode)
  std::vector<double> flat_pw;
  double unk_pw = 0.0;
  // Published with release AFTER flat_pw/unk_pw are populated; the unlocked
  // fast path in EnsurePieceWeights loads it with acquire, so observing
  // pw_alpha == alpha guarantees the weight tables are visible. NaN sentinel
  // compares unequal to every alpha, covering the never-initialized case.
  std::atomic<float> pw_alpha{std::numeric_limits<float>::quiet_NaN()};
  // Monotonic table-swap counter: gating cache insertion on pw_alpha VALUE
  // equality has an ABA hole if alpha oscillates A->B->A while an encode is
  // in flight (a B-table lattice could pass the check and be cached into
  // the restored-A regime). Incremented with each table swap (under pw_rw
  // exclusive); SampleEncode snapshots it BEFORE BuildLattice and only
  // caches a lattice whose generation is still current at insertion.
  std::atomic<uint64_t> pw_generation{0};
  std::mutex pw_mutex;
  // Guards the flat_pw/unk_pw tables against an in-place swap racing an
  // in-flight BuildLattice on another thread (only contended across an
  // alpha CHANGE — the same-alpha fast path never takes the writer side).
  std::shared_mutex pw_rw;
  std::mt19937_64 rng{std::random_device{}()};
  std::mutex rng_mutex;  // single-encode path shares m->rng across threads
  // Deterministic parallel sampling: every sequence gets its own RNG stream
  // derived from (base_seed, running sequence counter), so batch results are
  // identical for any thread count. Atomic: concurrent encode_batch calls
  // from multiple Python threads (ctypes releases the GIL) must claim
  // disjoint counter ranges.
  uint64_t base_seed = 0x853c49e6748fea9bULL;
  std::atomic<uint64_t> seq_counter{0};
  // Per-sequence lattice cache (training datasets re-encode the same
  // sequences every epoch; the forward filter is deterministic per text, so
  // steady-state epochs pay only the backward-sampling pass — measured
  // ~84% of host batch time was the encode, most of it the forward).
  // Entries are only ever inserted (the byte cap stops growth) and cleared
  // on alpha change; readers hold lat_mutex shared for their whole
  // backward pass, so cleared entries can't be yanked out from under them.
  std::unordered_map<std::string, CachedLattice> lat_cache;
  std::shared_mutex lat_mutex;
  size_t lat_bytes = 0;
  size_t lat_cap_bytes = 0;
  std::atomic<int64_t> lat_hits{0};
  std::atomic<int64_t> lat_misses{0};
};

bool ParsePiece(Cursor c, Piece* out) {
  out->score = 0.0f;
  out->type = 1;
  while (c.p < c.end) {
    uint64_t tag;
    if (!ReadVarint(c, &tag)) return false;
    uint32_t fnum = tag >> 3, wt = tag & 7;
    if (fnum == 1 && wt == 2) {
      uint64_t len;
      if (!ReadVarint(c, &len)) return false;
      out->text.assign(reinterpret_cast<const char*>(c.p), len);
      c.p += len;
    } else if (fnum == 2 && wt == 5) {
      memcpy(&out->score, c.p, 4);
      c.p += 4;
    } else if (fnum == 3 && wt == 0) {
      uint64_t v;
      if (!ReadVarint(c, &v)) return false;
      out->type = static_cast<int>(v);
    } else if (!SkipField(c, wt)) {
      return false;
    }
  }
  return true;
}

void ParseTrainerSpec(Cursor c, Model* m) {
  while (c.p < c.end) {
    uint64_t tag;
    if (!ReadVarint(c, &tag)) return;
    uint32_t fnum = tag >> 3, wt = tag & 7;
    if (wt == 0 && fnum >= 40 && fnum <= 43) {
      uint64_t v;
      if (!ReadVarint(c, &v)) return;
      int64_t sv = static_cast<int64_t>(v);
      switch (fnum) {
        case 40: m->unk_id = sv; break;
        case 41: m->bos_id = sv; break;
        case 42: m->eos_id = sv; break;
        case 43: m->pad_id = sv; break;
      }
    } else if (!SkipField(c, wt)) {
      return;
    }
  }
}

void BuildTrie(Model* m) {
  m->trie.clear();
  m->trie.emplace_back();
  float min_score = 0.0f;
  bool saw_unknown_type = false;
  int unknown_type_id = 0;
  for (int b = 0; b < 256; ++b) m->byte_ids[b] = -1;
  for (size_t id = 0; id < m->pieces.size(); ++id) {
    const Piece& p = m->pieces[id];
    if (p.type == 2 && !saw_unknown_type) {
      saw_unknown_type = true;
      unknown_type_id = static_cast<int>(id);
    }
    if (p.type == 6 && p.text.size() == 6 && p.text.compare(0, 3, "<0x") == 0 &&
        p.text[5] == '>') {
      auto hex = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        return -1;
      };
      int hi = hex(p.text[3]), lo = hex(p.text[4]);
      if (hi >= 0 && lo >= 0) m->byte_ids[hi * 16 + lo] = static_cast<int>(id);
    }
    if (p.type == 2 || p.type == 3 || p.type == 5 || p.type == 6) continue;
    int node = 0;
    for (unsigned char ch : p.text) {
      auto it = m->trie[node].children.find(ch);
      if (it == m->trie[node].children.end()) {
        m->trie[node].children.emplace(ch, static_cast<int>(m->trie.size()));
        node = static_cast<int>(m->trie.size());
        m->trie.emplace_back();
      } else {
        node = it->second;
      }
    }
    m->trie[node].piece_id = static_cast<int>(id);
    m->trie[node].score = p.score;
    if (static_cast<int>(p.text.size()) > m->max_piece_len)
      m->max_piece_len = static_cast<int>(p.text.size());
    if (p.score < min_score) min_score = p.score;
  }
  if (m->unk_id < 0 && saw_unknown_type) m->unk_id = unknown_type_id;
  m->unk_score = min_score - kUnkPenalty;

  const size_t n_nodes = m->trie.size();
  m->flat_next.assign(n_nodes * 256, -1);
  m->flat_pid.resize(n_nodes);
  m->flat_score.resize(n_nodes);
  for (size_t i = 0; i < n_nodes; ++i) {
    m->flat_pid[i] = m->trie[i].piece_id;
    m->flat_score[i] = m->trie[i].score;
    for (const auto& kv : m->trie[i].children)
      m->flat_next[i * 256 + kv.first] = kv.second;
  }
}

int Utf8CharLen(uint8_t b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0x6) return 2;
  if ((b >> 4) == 0xE) return 3;
  if ((b >> 3) == 0x1E) return 4;
  return 1;
}

// Per-thread reusable lattice/DP buffers: the batch encode is called once
// per train step, and per-call vector-of-vectors allocation dominated the
// profile. Edges live in flat arrays chained into per-end linked lists.
struct Workspace {
  std::vector<int32_t> e_start, e_pid, e_next;
  std::vector<int32_t> head;          // per end position: first edge or -1
  std::vector<double> e_w;            // cached edge mass, in end's scale
  std::vector<double> w;              // forward mass mantissa per position
  std::vector<int32_t> wexp;          // forward mass scale: true = w*2^-wexp
  std::vector<double> best;
  std::vector<int32_t> back_start, back_piece;
  std::vector<int32_t> tmp;
  // flattened-lattice scratch: c_off/c_edges for the cache-disabled
  // sampling path, c_w for every alias build (masses are scratch-only)
  std::vector<int32_t> c_off;
  std::vector<Edge> c_edges;
  std::vector<double> c_w;
};
// NOTE: the per-thread workspace is passed explicitly, NOT read through a
// C++ `thread_local` inside the hot functions: this library is dlopen'd
// (ctypes), so thread_local access compiles to the general-dynamic TLS
// model and the __tls_get_addr traffic measured 2.2x on the whole batch
// encode (17.4 -> 7.9 ms/batch on the bench corpus once hoisted).
thread_local Workspace tls_ws;

int ViterbiEncode(const Model& m, Workspace& ws, const char* text, int n,
                  int* out, int max_out) {
  // Start-major relaxation straight off the trie: no lattice is
  // materialized at all, and per-thread DP buffers are reused across calls.
  // Relaxation order (starts ascending, matches short->long, strict >)
  // matches the Python engine's exactly, so tie segmentations agree.
  // Path scores accumulate in double: with f32 accumulation, equal-score
  // segmentations ("T"+"TT" vs "TT"+"T") resolve by rounding of the partial
  // sums instead of by enumeration order, diverging from the f64 reference
  // engines (HF tokenizers golden fixtures caught this).
  ws.best.assign(n + 1, -1e30);
  ws.back_start.assign(n + 1, -1);
  ws.back_piece.assign(n + 1, -1);
  ws.best[0] = 0.0;
  const int32_t* nexts = m.flat_next.data();
  auto relax = [&](int end, double cand, int start, int pid) {
    if (cand > ws.best[end]) {
      ws.best[end] = cand;
      ws.back_start[end] = start;
      ws.back_piece[end] = pid;
    }
  };
  for (int i = 0; i < n;) {
    int char_len = Utf8CharLen(static_cast<uint8_t>(text[i]));
    if (i + char_len > n) char_len = 1;
    double b = ws.best[i];
    if (b <= -1e29) {
      // unreachable start (can't happen: unk edges keep every char-boundary
      // reachable), but keep the walk going defensively
      i += char_len;
      continue;
    }
    bool matched_single = false;
    int node = 0;
    int limit = std::min(n, i + m.max_piece_len);
    for (int j = i; j < limit; ++j) {
      node = nexts[node * 256 + static_cast<uint8_t>(text[j])];
      if (node < 0) break;
      int pid = m.flat_pid[node];
      if (pid >= 0) {
        relax(j + 1, b + static_cast<double>(m.flat_score[node]), i, pid);
        if (j + 1 == i + char_len) matched_single = true;
      }
    }
    if (!matched_single) {
      relax(i + char_len, b + static_cast<double>(m.unk_score), i, m.unk_id);
    }
    i += char_len;
  }
  if (ws.back_start[n] < 0 && n > 0) return -1;
  // byte fallback at emission: an unk segment (always one char) whose UTF-8
  // bytes all have BYTE pieces expands to those ids, like sentencepiece
  auto unk_bytes = [&](int start, int end) -> int {
    for (int k = start; k < end; ++k)
      if (m.byte_ids[static_cast<uint8_t>(text[k])] < 0) return 0;
    return end - start;
  };
  int count = 0;
  for (int pos = n; pos > 0; pos = ws.back_start[pos]) {
    int nb = (ws.back_piece[pos] == m.unk_id)
                 ? unk_bytes(ws.back_start[pos], pos)
                 : 0;
    count += nb ? nb : 1;
  }
  if (count > max_out) return -count;
  int idx = count;
  for (int pos = n; pos > 0; pos = ws.back_start[pos]) {
    int start = ws.back_start[pos];
    int nb = (ws.back_piece[pos] == m.unk_id) ? unk_bytes(start, pos) : 0;
    if (nb) {
      for (int k = pos - 1; k >= start; --k)
        out[--idx] = m.byte_ids[static_cast<uint8_t>(text[k])];
    } else {
      out[--idx] = ws.back_piece[pos];
    }
  }
  return count;
}

uint64_t SplitMix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Precompute exp(alpha * score) per trie node (and for the unk edge) so
// the FFBS lattice math below runs entirely in probability space with no
// per-edge transcendentals. A few hundred std::exp calls per alpha change
// (alpha is constant across a training run).
void EnsurePieceWeights(Model* m, float alpha) {
  // Double-checked locking with an atomic flag: ctypes releases the GIL, so
  // concurrent Python threads can race here. acquire/release on pw_alpha
  // orders the flat_pw publication (see Model::pw_alpha comment).
  if (m->pw_alpha.load(std::memory_order_acquire) == alpha) return;
  std::lock_guard<std::mutex> lock(m->pw_mutex);
  if (m->pw_alpha.load(std::memory_order_relaxed) == alpha) return;
  std::vector<double> pw(m->flat_score.size());
  for (size_t i = 0; i < pw.size(); ++i)
    pw[i] = std::exp(static_cast<double>(alpha) * m->flat_score[i]);
  {
    // exclusive vs in-flight BuildLattice readers of the old tables
    std::unique_lock<std::shared_mutex> wl(m->pw_rw);
    m->unk_pw = std::exp(static_cast<double>(alpha) * m->unk_score);
    m->flat_pw.swap(pw);
    // generation bump inside the exclusive section: any BuildLattice that
    // saw the OLD tables took its shared lock (and its generation snapshot)
    // strictly before this, so its snapshot can never equal the new value
    m->pw_generation.fetch_add(1, std::memory_order_release);
  }
  // Publish the new alpha BEFORE clearing the lattice cache: SampleEncode
  // only inserts an entry while pw_generation still equals the snapshot it
  // took before building (under lat_mutex), so with this order a lattice
  // built under the OLD tables either fails that generation check (the
  // bump above happened first) or landed before the clear and is wiped by
  // it — stale entries can never survive into the new regime.
  m->pw_alpha.store(alpha, std::memory_order_release);
  {
    // cached lattice masses bake in exp(alpha*score): invalidate on change
    std::unique_lock<std::shared_mutex> ul(m->lat_mutex);
    m->lat_cache.clear();
    m->lat_bytes = 0;
  }
}

// Forward-filtering half of FFBS in PROBABILITY space: the forward
// mass at byte position p is stored as w[p] * 2^-wexp[p] (mantissa +
// power-of-two scale, rescaled when the mantissa drifts below 2^-256, so
// arbitrarily long inputs never underflow). Each edge's contribution is
// one f64 multiply-add against the precomputed exp(alpha*score) of its
// trie node — no exp/log per edge, which was the dominant host cost of
// the previous log-space formulation (~5x on the epoch tokenization
// profile). Lattice construction (trie walk) is fused into the same
// start-major pass; cached per-edge masses e_w are all expressed in
// their END position's scale, so backward sampling ratios need no scale
// adjustment at all. Returns false when no full segmentation exists.
bool BuildLattice(const Model& m, Workspace& ws, const char* text, int n) {
  ws.head.assign(n + 1, -1);
  ws.e_start.clear();
  ws.e_pid.clear();
  ws.e_next.clear();
  ws.e_w.clear();
  ws.w.assign(n + 1, 0.0);
  ws.wexp.assign(n + 1, INT_MIN);
  ws.w[0] = 1.0;
  ws.wexp[0] = 0;
  const int32_t* nexts = m.flat_next.data();
  const double* pws = m.flat_pw.data();

  auto push_edge = [&](int end, int start, int pid, double mass, int se) {
    if (ws.wexp[end] == INT_MIN) ws.wexp[end] = se;
    else if (se != ws.wexp[end]) mass = std::ldexp(mass, ws.wexp[end] - se);
    ws.w[end] += mass;
    int idx = static_cast<int>(ws.e_start.size());
    ws.e_start.push_back(start);
    ws.e_pid.push_back(pid);
    ws.e_w.push_back(mass);
    ws.e_next.push_back(ws.head[end]);
    ws.head[end] = idx;
  };

  for (int i = 0; i < n;) {
    int char_len = Utf8CharLen(static_cast<uint8_t>(text[i]));
    if (i + char_len > n) char_len = 1;
    double b = ws.w[i];
    int ei = ws.wexp[i];
    // finalize this position's mass: renormalize the mantissa (edges into
    // i already cached keep their pre-rescale scale — backward only takes
    // ratios among edges of one position, which a uniform factor preserves)
    while (b > 0.0 && b < 0x1p-256) {
      b = std::ldexp(b, 256);
      ei += 256;
    }
    ws.w[i] = b;
    ws.wexp[i] = ei;
    if (b > 0.0) {
      bool matched_single = false;
      int node = 0;
      int limit = std::min(n, i + m.max_piece_len);
      for (int j = i; j < limit; ++j) {
        node = nexts[node * 256 + static_cast<uint8_t>(text[j])];
        if (node < 0) break;
        int pid = m.flat_pid[node];
        if (pid >= 0) {
          push_edge(j + 1, i, pid, b * pws[node], ei);
          if (j + 1 == i + char_len) matched_single = true;
        }
      }
      if (!matched_single) {
        push_edge(i + char_len, i, m.unk_id, b * m.unk_pw, ei);
      }
    }
    i += char_len;
  }
  return !(n > 0 && !(ws.w[n] > 0.0));
}

// Flatten the workspace's per-end linked lists to off[] + interleaved
// Edge records, with the masses in a parallel scratch for the alias
// build. The lists yield edges newest-first; filling each segment from
// its back restores the insertion (starts-ascending) order the sampling
// distribution was defined over — so flattened sampling is
// byte-identical to the linked-list walk.
void LatticeToEdges(const Workspace& ws, int n, std::vector<int32_t>& off,
                    std::vector<Edge>& edges, std::vector<double>& w) {
  off.assign(n + 2, 0);
  for (int e = 1; e <= n; ++e) {
    int c = 0;
    for (int k = ws.head[e]; k >= 0; k = ws.e_next[k]) ++c;
    off[e + 1] = c;
  }
  for (int e = 1; e <= n + 1; ++e) off[e] += off[e - 1];
  int ne = off[n + 1];
  edges.resize(ne);
  w.resize(ne);
  for (int e = 1; e <= n; ++e) {
    int idx = off[e + 1];
    for (int k = ws.head[e]; k >= 0; k = ws.e_next[k]) {
      --idx;
      edges[idx].start = ws.e_start[k];
      edges[idx].pid = ws.e_pid[k];
      w[idx] = ws.e_w[k];
    }
  }
}

// Per-end-position Walker/Vose alias tables over the edge masses:
// backward sampling then draws each piece with ONE uniform and TWO loads
// (O(1) per node) instead of a two-pass O(deg) total+CDF scan — the scan
// made a cache-hit sampled encode SLOWER than a full Viterbi (29 vs
// 21 ns/char on the bench corpus). Construction normalizes with the same
// edge masses the scan summed (NOT the forward w[pos], which may have
// been rescaled after the edges were cached), so the categorical
// distribution per node is identical in real arithmetic; float rounding
// differs at ~1e-7, far inside the sampling tests' tolerances. A
// zero-mass node marks alias -1 so the sampler reports the same failure
// the scan path did. Built once per cached lattice (and per call on the
// cache-off path, where it is O(edges) next to the forward filter).
void BuildAlias(const int32_t* off, const double* w, int n,
                std::vector<Edge>& edges) {
  std::vector<int32_t> small, large;  // reused across nodes; deg is tiny
  std::vector<double> p;
  for (int e = 1; e <= n; ++e) {
    int lo = off[e], K = off[e + 1] - lo;
    if (K == 0) continue;
    double total = 0.0;
    for (int k = 0; k < K; ++k) total += w[lo + k];
    if (!(total > 0.0)) {
      for (int k = 0; k < K; ++k) {
        edges[lo + k].aprob = 0.0f;
        edges[lo + k].aidx = -1;  // unsampleable node
      }
      continue;
    }
    p.assign(K, 0.0);
    small.clear();
    large.clear();
    for (int k = 0; k < K; ++k) {
      p[k] = w[lo + k] * K / total;
      (p[k] < 1.0 ? small : large).push_back(k);
    }
    while (!small.empty() && !large.empty()) {
      int s = small.back();
      small.pop_back();
      int l = large.back();
      large.pop_back();
      edges[lo + s].aprob = static_cast<float>(p[s]);
      edges[lo + s].aidx = lo + l;
      p[l] = (p[l] + p[s]) - 1.0;
      (p[l] < 1.0 ? small : large).push_back(l);
    }
    // leftovers are exactly 1 up to rounding: always keep their own column
    for (auto* rest : {&small, &large})
      for (int k : *rest) {
        edges[lo + k].aprob = 1.0f;
        edges[lo + k].aidx = lo + k;
      }
  }
}

// Backward-sampling half of FFBS over a flattened lattice (fresh or
// cached), choosing each node's incoming edge through its alias table.
int SampleFromEdges(const Model& m, const int32_t* off, const Edge* eg,
                    const char* text, int n, std::mt19937_64& rng, int* out,
                    int max_out, std::vector<int32_t>& tmp) {
  tmp.clear();  // sampled piece ids, reversed
  int pos = n;
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);
  while (pos > 0) {
    int lo = off[pos], K = off[pos + 1] - lo;
    if (K <= 0) return -1;
    float scaled = uni(rng) * K;
    int col = static_cast<int>(scaled);
    if (col >= K) col = K - 1;  // uni() can round to 1.0f
    const Edge& probe = eg[lo + col];
    int chosen = (scaled - col) < probe.aprob ? lo + col : probe.aidx;
    if (chosen < 0) return -1;  // zero-mass node (unsampleable)
    int pid = eg[chosen].pid;
    int start = eg[chosen].start;
    // byte fallback at emission (see ViterbiEncode); tmp is reversed, so
    // bytes are pushed last-first
    bool expanded = false;
    if (pid == m.unk_id) {
      bool all_bytes = true;
      for (int k = start; k < pos; ++k)
        if (m.byte_ids[static_cast<uint8_t>(text[k])] < 0) {
          all_bytes = false;
          break;
        }
      if (all_bytes) {
        for (int k = pos - 1; k >= start; --k)
          tmp.push_back(m.byte_ids[static_cast<uint8_t>(text[k])]);
        expanded = true;
      }
    }
    if (!expanded) tmp.push_back(pid);
    pos = start;
  }
  int count = static_cast<int>(tmp.size());
  if (count > max_out) return -count;
  for (int k = 0; k < count; ++k) out[k] = tmp[count - 1 - k];
  return count;
}

// alpha is folded into m.flat_pw by EnsurePieceWeights; the cache-insertion
// gate keys on m.pw_generation rather than the alpha value (value equality
// has an ABA hole under A->B->A oscillation).
int SampleEncode(Model& m, Workspace& ws, const char* text, int n,
                 float alpha, std::mt19937_64& rng, int* out, int max_out) {
  (void)alpha;
  if (m.lat_cap_bytes > 0) {
    std::string key(text, n);
    {
      // the shared lock is held across the whole backward pass so an
      // alpha-change clear (unique lock) can't free the entry mid-read
      std::shared_lock<std::shared_mutex> sl(m.lat_mutex);
      auto it = m.lat_cache.find(key);
      if (it != m.lat_cache.end()) {
        const CachedLattice& lat = it->second;
        m.lat_hits.fetch_add(1, std::memory_order_relaxed);
        return SampleFromEdges(m, lat.off.data(), lat.edges.data(), text,
                               n, rng, out, max_out, ws.tmp);
      }
    }
    m.lat_misses.fetch_add(1, std::memory_order_relaxed);
    // snapshot BEFORE building: the tables BuildLattice reads are of this
    // generation or newer; either way an intervening swap (including an
    // A->B->A alpha oscillation) changes the counter and blocks insertion
    const uint64_t gen = m.pw_generation.load(std::memory_order_acquire);
    {
      std::shared_lock<std::shared_mutex> pwl(m.pw_rw);
      if (!BuildLattice(m, ws, text, n)) return -1;
    }
    CachedLattice lat;
    // the raw masses (ws.c_w scratch) feed only the alias construction —
    // the cached entry keeps just off[] + 16 B/edge
    LatticeToEdges(ws, n, lat.off, lat.edges, ws.c_w);
    BuildAlias(lat.off.data(), ws.c_w.data(), n, lat.edges);
    int r = SampleFromEdges(m, lat.off.data(), lat.edges.data(), text, n,
                            rng, out, max_out, ws.tmp);
    if (r != -1) {  // cache even too-small-max_out lattices (they're valid)
      size_t add = lat.bytes() + key.size() + 96;
      std::unique_lock<std::shared_mutex> ul(m.lat_mutex);
      // insertion gate vs a concurrent table swap: a lattice whose
      // generation snapshot is stale either fails this check or (when the
      // swap's generation bump hasn't been observed yet) lands before the
      // cache clear that follows it and is wiped by that clear
      if (m.pw_generation.load(std::memory_order_acquire) == gen &&
          m.lat_bytes + add <= m.lat_cap_bytes &&
          m.lat_cache.emplace(std::move(key), std::move(lat)).second)
        m.lat_bytes += add;
    }
    return r;
  }
  {
    std::shared_lock<std::shared_mutex> pwl(m.pw_rw);
    if (!BuildLattice(m, ws, text, n)) return -1;
  }
  LatticeToEdges(ws, n, ws.c_off, ws.c_edges, ws.c_w);
  BuildAlias(ws.c_off.data(), ws.c_w.data(), n, ws.c_edges);
  return SampleFromEdges(m, ws.c_off.data(), ws.c_edges.data(), text, n,
                         rng, out, max_out, ws.tmp);
}

}  // namespace

extern "C" {

void* spm_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* m = new Model();
  Cursor c{buf.data(), buf.data() + buf.size()};
  while (c.p < c.end) {
    uint64_t tag;
    if (!ReadVarint(c, &tag)) break;
    uint32_t fnum = tag >> 3, wt = tag & 7;
    if (fnum == 1 && wt == 2) {
      uint64_t len;
      if (!ReadVarint(c, &len)) break;
      Piece piece;
      if (!ParsePiece(Cursor{c.p, c.p + len}, &piece)) break;
      m->pieces.push_back(std::move(piece));
      c.p += len;
    } else if (fnum == 2 && wt == 2) {
      uint64_t len;
      if (!ReadVarint(c, &len)) break;
      ParseTrainerSpec(Cursor{c.p, c.p + len}, m);
      c.p += len;
    } else if (!SkipField(c, wt)) {
      break;
    }
  }
  if (m->pieces.empty()) {
    delete m;
    return nullptr;
  }
  BuildTrie(m);
  // Lattice-cache budget: INTREPPPID_TPU_LATTICE_CACHE_MB (0 disables;
  // default 2048 MB — ~60k cached 1000-char proteins at ~64 B/char).
  const char* env = std::getenv("INTREPPPID_TPU_LATTICE_CACHE_MB");
  long mb = 2048;
  if (env && *env) {
    char* endp = nullptr;
    long v = std::strtol(env, &endp, 10);
    if (endp != env) mb = v;
  }
  m->lat_cap_bytes = mb > 0 ? static_cast<size_t>(mb) * 1024 * 1024 : 0;
  return m;
}

void spm_free(void* h) { delete static_cast<Model*>(h); }

void spm_seed(void* h, uint64_t seed) {
  Model* m = static_cast<Model*>(h);
  std::lock_guard<std::mutex> lock(m->rng_mutex);
  m->rng.seed(seed);
  m->base_seed = seed;
  m->seq_counter.store(0, std::memory_order_relaxed);
}

int spm_vocab_size(void* h) {
  return static_cast<int>(static_cast<Model*>(h)->pieces.size());
}

// Lattice-cache observability (tests / tuning): entry count, resident
// bytes, hit/miss counters since load.
void spm_lattice_cache_stats(void* h, int64_t* entries, int64_t* bytes,
                             int64_t* hits, int64_t* misses) {
  Model* m = static_cast<Model*>(h);
  std::shared_lock<std::shared_mutex> sl(m->lat_mutex);
  if (entries) *entries = static_cast<int64_t>(m->lat_cache.size());
  if (bytes) *bytes = static_cast<int64_t>(m->lat_bytes);
  if (hits) *hits = m->lat_hits.load(std::memory_order_relaxed);
  if (misses) *misses = m->lat_misses.load(std::memory_order_relaxed);
}

int spm_unk_id(void* h) { return static_cast<Model*>(h)->unk_id; }
int spm_bos_id(void* h) { return static_cast<Model*>(h)->bos_id; }
int spm_eos_id(void* h) { return static_cast<Model*>(h)->eos_id; }
int spm_pad_id(void* h) { return static_cast<Model*>(h)->pad_id; }

// Encode a pre-normalised UTF-8 string. Returns token count, or negative
// required size if max_out is too small, -1 on failure.
int spm_encode(void* h, const char* text, int text_len, int sampling,
               float alpha, int* out, int max_out) {
  Model* m = static_cast<Model*>(h);
  if (text_len == 0) return 0;
  Workspace& ws = tls_ws;  // one TLS resolution per call
  if (sampling) {
    EnsurePieceWeights(m, alpha);
    // the single-encode path draws from the shared m->rng: serialize it
    // (concurrent Python threads reach here with the GIL released)
    std::lock_guard<std::mutex> lock(m->rng_mutex);
    return SampleEncode(*m, ws, text, text_len, alpha, m->rng, out, max_out);
  }
  return ViterbiEncode(*m, ws, text, text_len, out, max_out);
}

// Batch encode with right-padding to trunc_len (the reference's
// static_encode pad semantics, `intrepppid/data/ppi_oma.py:388-390`).
// texts: concatenated bytes; offsets: n+1 prefix offsets. out: (n, trunc_len)
// int32, zero-initialised by callee. Each row i gets min(count, trunc_len)
// ids (sequences longer than trunc_len are truncated at the char level by
// the caller, matching the reference's seq[:trunc_len]).
int spm_encode_batch(void* h, const char* texts, const int64_t* offsets,
                     int n, int sampling, float alpha, int32_t* out,
                     int trunc_len, int n_threads) {
  Model* m = static_cast<Model*>(h);
  if (sampling) EnsurePieceWeights(m, alpha);  // before the threads fork
  // atomic range claim: concurrent batch calls get disjoint stream bases
  const uint64_t stream_base = m->seq_counter.fetch_add(
      static_cast<uint64_t>(n), std::memory_order_relaxed);
  std::atomic<int> failed{0};

  auto work = [&](int lo, int hi) {
    Workspace ws;  // per-shard, stack-rooted: no TLS in the hot loops
    std::vector<int> tmp;
    for (int i = lo; i < hi; ++i) {
      const char* s = texts + offsets[i];
      int len = static_cast<int>(offsets[i + 1] - offsets[i]);
      tmp.assign(len + 1, 0);
      int cnt = 0;
      if (len > 0) {
        if (sampling) {
          std::mt19937_64 rng(
              SplitMix64(m->base_seed ^ SplitMix64(stream_base + i)));
          cnt = SampleEncode(*m, ws, s, len, alpha, rng, tmp.data(), len + 1);
        } else {
          cnt = ViterbiEncode(*m, ws, s, len, tmp.data(), len + 1);
        }
        if (cnt < 0) {
          failed.store(i + 1, std::memory_order_relaxed);
          return;
        }
      }
      int32_t* row = out + static_cast<int64_t>(i) * trunc_len;
      int keep = cnt < trunc_len ? cnt : trunc_len;
      for (int k = 0; k < keep; ++k) row[k] = tmp[k];
      for (int k = keep; k < trunc_len; ++k) row[k] = 0;
    }
  };

  if (n_threads <= 1 || n < 2) {
    work(0, n);
  } else {
    int k = n_threads < n ? n_threads : n;
    std::vector<std::thread> pool;
    pool.reserve(k);
    int per = (n + k - 1) / k;
    for (int t = 0; t < k; ++t) {
      int lo = t * per;
      int hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  return failed.load() ? -failed.load() : 0;
}

}  // extern "C"
