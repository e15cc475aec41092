// Native tokenizer core: byte-level BPE encode at C++ speed.
//
// The same core as the JAX package's csrc/tokenizer.cpp, kept here so
// that the PyTorch port builds it from its own sources
// (tinygpt_tpu_torch/ops/host_build.py). It covers the tokenizer's two
// CPU-bound hot loops, split matching and BPE merges. Design:
//   * pre-tokenization is a hand-written matcher for the fixed split
//     patterns the supported model families actually use (GPT-2 and the
//     Llama-3/Qwen variants) over generated Unicode category tables — no
//     regex engine dependency at all;
//   * BPE runs over token *ids*, not strings: the byte-level alphabet maps
//     each input byte to a base token id, merges are a hash of
//     (left_id, right_id) -> (rank, merged_id), so the merge loop touches
//     no string data;
//   * batch encode fans out over a std::thread pool; the Python binding
//     calls through ctypes, which drops the GIL for the whole batch.
//
// The Python pipeline (tinygpt_tpu_torch/tokenizer/) remains the
// reference implementation and the fallback for tokenizers this fast path
// does not cover (custom normalizers, arbitrary split regexes).
//
// C ABI at the bottom; binding in tinygpt_tpu_torch/tokenizer/native.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <queue>
#include <cstdio>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "unicode_tables.inc"

namespace {

// ---------------------------------------------------------------------------
// Unicode classification
// ---------------------------------------------------------------------------

bool in_ranges(uint32_t cp, const uint32_t (*ranges)[2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp > ranges[mid][1]) {
      lo = mid + 1;
    } else if (cp < ranges[mid][0]) {
      hi = mid;
    } else {
      return true;
    }
  }
  return false;
}

inline bool is_letter(uint32_t cp) {
  if (cp < 0x80) {
    return (cp >= 'A' && cp <= 'Z') || (cp >= 'a' && cp <= 'z');
  }
  return in_ranges(cp, kLetterRanges, kLetterRanges_len);
}

inline bool is_number(uint32_t cp) {
  if (cp < 0x80) return cp >= '0' && cp <= '9';
  return in_ranges(cp, kNumberRanges, kNumberRanges_len);
}

inline bool is_ws(uint32_t cp) {
  if (cp < 0x80) return cp == ' ' || (cp >= 0x09 && cp <= 0x0D);
  return in_ranges(cp, kWhitespaceRanges, kWhitespaceRanges_len);
}

inline bool is_newline(uint32_t cp) { return cp == '\r' || cp == '\n'; }

// Decode one UTF-8 codepoint at p (end-bounded). Invalid bytes decode as
// themselves (one byte), matching a permissive byte-level pipeline where
// arbitrary bytes must survive.
inline uint32_t decode_utf8(const uint8_t* p, const uint8_t* end,
                            int* len_out) {
  uint8_t b0 = p[0];
  if (b0 < 0x80) {
    *len_out = 1;
    return b0;
  }
  int need = 0;
  uint32_t cp = 0;
  if ((b0 & 0xE0) == 0xC0) {
    need = 1;
    cp = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    need = 2;
    cp = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    need = 3;
    cp = b0 & 0x07;
  } else {
    *len_out = 1;
    return b0;  // stray continuation / invalid lead
  }
  for (int i = 1; i <= need; i++) {
    if (p + i >= end || (p[i] & 0xC0) != 0x80) {
      *len_out = 1;
      return b0;
    }
    cp = (cp << 6) | (p[i] & 0x3F);
  }
  *len_out = need + 1;
  return cp;
}

// ---------------------------------------------------------------------------
// Pre-tokenization: hand-written matchers for the fixed split patterns
// ---------------------------------------------------------------------------
//
// Kind 1 (GPT-2):  '(?:[sdmt]|ll|ve|re) | ?\p{L}+ | ?\p{N}+
//                  | ?[^\s\p{L}\p{N}]+ | \s+(?!\S) | \s+
// Kind 2 (Llama-3): (?i:'s|'t|'re|'ve|'m|'ll|'d) | [^\r\n\p{L}\p{N}]?\p{L}+
//                  | \p{N}{1,3} | ?[^\s\p{L}\p{N}]+[\r\n]*
//                  | \s*[\r\n]+ | \s+(?!\S) | \s+
// Kind 3 (Qwen-2): Llama-3 with \p{N} (single digit runs).
//
// All are leftmost-first alternations over a scan position; each matcher
// returns the byte length of the piece starting at `p`.

struct Cp {
  uint32_t cp;
  int len;
};

inline Cp peek(const uint8_t* p, const uint8_t* end) {
  Cp c;
  if (p >= end) {
    c.cp = 0xFFFFFFFFu;
    c.len = 0;
    return c;
  }
  c.cp = decode_utf8(p, end, &c.len);
  return c;
}

// Contraction: returns matched byte length or 0. `ci` = case-insensitive.
inline size_t match_contraction(const uint8_t* p, const uint8_t* end,
                                bool ci) {
  if (p >= end || p[0] != '\'') return 0;
  if (p + 1 >= end) return 0;
  auto low = [ci](uint8_t c) -> uint8_t {
    return (ci && c >= 'A' && c <= 'Z') ? c + 32 : c;
  };
  uint8_t c1 = low(p[1]);
  // two-letter: ll, ve, re
  if (p + 2 < end) {
    uint8_t c2 = low(p[2]);
    if ((c1 == 'l' && c2 == 'l') || (c1 == 'v' && c2 == 'e') ||
        (c1 == 'r' && c2 == 'e')) {
      return 3;
    }
  }
  if (c1 == 's' || c1 == 'd' || c1 == 'm' || c1 == 't') return 2;
  return 0;
}

size_t match_piece_gpt2(const uint8_t* p, const uint8_t* end) {
  size_t n = match_contraction(p, end, /*ci=*/false);
  if (n) return n;
  const uint8_t* q = p;
  Cp c = peek(q, end);
  // optional single space prefix for L+/N+/punct+
  bool sp = (c.cp == ' ');
  const uint8_t* after_sp = sp ? q + 1 : q;
  Cp c1 = peek(after_sp, end);
  if (is_letter(c1.cp)) {
    const uint8_t* r = after_sp;
    while (r < end) {
      Cp cc = peek(r, end);
      if (!is_letter(cc.cp)) break;
      r += cc.len;
    }
    return r - p;
  }
  if (is_number(c1.cp)) {
    const uint8_t* r = after_sp;
    while (r < end) {
      Cp cc = peek(r, end);
      if (!is_number(cc.cp)) break;
      r += cc.len;
    }
    return r - p;
  }
  if (c1.cp != 0xFFFFFFFFu && !is_ws(c1.cp) && !is_letter(c1.cp) &&
      !is_number(c1.cp)) {
    const uint8_t* r = after_sp + c1.len;
    while (r < end) {
      Cp cc = peek(r, end);
      if (is_ws(cc.cp) || is_letter(cc.cp) || is_number(cc.cp)) break;
      r += cc.len;
    }
    return r - p;
  }
  // whitespace: \s+(?!\S) then \s+
  if (is_ws(c.cp)) {
    const uint8_t* r = q;
    const uint8_t* last_ws_start = q;
    while (r < end) {
      Cp cc = peek(r, end);
      if (!is_ws(cc.cp)) break;
      last_ws_start = r;
      r += cc.len;
    }
    if (r >= end) return r - p;     // \s+(?!\S) matches whole run
    if (last_ws_start > q) return last_ws_start - p;  // leave last ws
    return r - p;                   // single ws before non-space: \s+
  }
  // fallback: single codepoint (unreachable for well-formed classes)
  return c.len ? c.len : 1;
}

size_t match_piece_llama3(const uint8_t* p, const uint8_t* end,
                          int max_digits) {
  size_t n = match_contraction(p, end, /*ci=*/true);
  if (n) return n;
  Cp c = peek(p, end);
  // [^\r\n\p{L}\p{N}]?\p{L}+
  {
    bool pfx = (c.cp != 0xFFFFFFFFu) && !is_newline(c.cp) &&
               !is_letter(c.cp) && !is_number(c.cp);
    const uint8_t* after = p + (pfx ? c.len : 0);
    Cp c1 = peek(after, end);
    if (is_letter(c1.cp)) {
      const uint8_t* r = after;
      while (r < end) {
        Cp cc = peek(r, end);
        if (!is_letter(cc.cp)) break;
        r += cc.len;
      }
      return r - p;
    }
  }
  // \p{N}{1,max_digits}
  if (is_number(c.cp)) {
    const uint8_t* r = p;
    int cnt = 0;
    while (r < end && cnt < max_digits) {
      Cp cc = peek(r, end);
      if (!is_number(cc.cp)) break;
      r += cc.len;
      cnt++;
    }
    return r - p;
  }
  // ' ?[^\s\p{L}\p{N}]+[\r\n]*'
  {
    bool sp = (c.cp == ' ');
    const uint8_t* after_sp = p + (sp ? 1 : 0);
    Cp c1 = peek(after_sp, end);
    if (c1.cp != 0xFFFFFFFFu && !is_ws(c1.cp) && !is_letter(c1.cp) &&
        !is_number(c1.cp)) {
      const uint8_t* r = after_sp + c1.len;
      while (r < end) {
        Cp cc = peek(r, end);
        if (is_ws(cc.cp) || is_letter(cc.cp) || is_number(cc.cp)) break;
        r += cc.len;
      }
      // trailing [\r\n]*
      while (r < end && (*r == '\r' || *r == '\n')) r++;
      return r - p;
    }
  }
  // '\s*[\r\n]+' — longest whitespace prefix ending at the last newline
  if (is_ws(c.cp)) {
    const uint8_t* r = p;
    const uint8_t* last_nl_end = nullptr;
    const uint8_t* last_ws_start = p;
    while (r < end) {
      Cp cc = peek(r, end);
      if (!is_ws(cc.cp)) break;
      if (is_newline(cc.cp)) last_nl_end = r + cc.len;
      last_ws_start = r;
      r += cc.len;
    }
    if (last_nl_end != nullptr) return last_nl_end - p;
    // '\s+(?!\S)' then '\s+'
    if (r >= end) return r - p;
    if (last_ws_start > p) return last_ws_start - p;
    return r - p;
  }
  return c.len ? c.len : 1;
}

// ---------------------------------------------------------------------------
// BPE over token ids
// ---------------------------------------------------------------------------

struct PairHash {
  size_t operator()(uint64_t v) const {
    // splitmix64
    v += 0x9E3779B97F4A7C15ull;
    v = (v ^ (v >> 30)) * 0xBF58476D1CE4E5B9ull;
    v = (v ^ (v >> 27)) * 0x94D049BB133111EBull;
    return static_cast<size_t>(v ^ (v >> 31));
  }
};

struct MergeVal {
  uint32_t rank;
  uint32_t new_id;
};

std::atomic<uint64_t> g_tok_gen{1};

struct Tok {
  uint64_t gen = g_tok_gen.fetch_add(1);  // unique per instance (cache tag)
  // vocab: token id -> raw bytes (for ignore_merges direct lookup we keep
  // the reverse map bytes -> id)
  std::unordered_map<std::string, uint32_t> vocab;
  std::unordered_map<uint64_t, MergeVal, PairHash> merges;
  int32_t byte_id[256];
  int pretok_kind;       // 0 none, 1 gpt2, 2 llama3, 3 qwen2, 4 metaspace
  bool add_prefix_space;
  bool ignore_merges;
  // kind 4 (metaspace / sentencepiece-style char BPE) extras:
  bool byte_fallback = false;   // unknown char -> <0xXX> ids
  int32_t byte_fb_id[256];      // id of "<0xXX>", -1 when absent
  int32_t unk_id = -1;
  bool fuse_unk = false;
  bool ms_split = false;        // split pieces on the replacement char
  // vocab-proven safe word split: when every vocab token carries the
  // replacement only as a PREFIX run (true for sentencepiece-style
  // vocabs: "▁the", "▁▁▁"), no merge can cross a [non-▁][▁] boundary —
  // so even with split=false the text can be cut into ▁-run+word pieces
  // and BPE'd per piece THROUGH THE PIECE CACHE, instead of one
  // heap-regime merge loop over the whole text.
  bool ms_word_split = false;
  std::string replacement;      // usually "\xE2\x96\x81" (U+2581)
  // single-CHARACTER vocab entries by codepoint (char-alphabet initial
  // symbol lookup without per-char string allocation); -2 = not present
  std::unordered_map<uint32_t, int32_t> char_id;

  size_t match_piece(const uint8_t* p, const uint8_t* end) const {
    switch (pretok_kind) {
      case 1:
        return match_piece_gpt2(p, end);
      case 2:
        return match_piece_llama3(p, end, 3);
      case 3:
        return match_piece_llama3(p, end, 1);
      default:
        return end - p;
    }
  }
};

constexpr uint32_t kNoRank = 0xFFFFFFFFu;
// Sentinel symbol id for characters absent from the vocab (kind 4):
// never a real id (vocab capped at 4M) and never a merge side, so the
// merge loop leaves these symbols alone until final emission.
constexpr uint32_t kUnkSym = 0xFFFFFFFEu;

// Run the BPE merge loop over ids[0..n) linked by nxt/prv (in place).
void run_merges(const Tok& T, std::vector<uint32_t>& ids,
                std::vector<int32_t>& nxt, std::vector<int32_t>& prv,
                int n) {
  auto rank_of = [&](int i, int j, MergeVal* mv) -> uint32_t {
    uint64_t key = (static_cast<uint64_t>(ids[i]) << 32) | ids[j];
    auto it = T.merges.find(key);
    if (it == T.merges.end()) return kNoRank;
    *mv = it->second;
    return it->second.rank;
  };

  // Two regimes: repeated min-rank scan for short pieces, heap with
  // stale-entry revalidation for long ones (huge whitespace runs etc.).
  if (n <= 64) {
    int alive = n;
    while (alive > 1) {
      uint32_t best_rank = kNoRank;
      int best_i = -1;
      MergeVal best_mv{0, 0};
      for (int i = 0; i != -1 && nxt[i] != -1; i = nxt[i]) {
        MergeVal mv;
        uint32_t r = rank_of(i, nxt[i], &mv);
        if (r < best_rank) {
          best_rank = r;
          best_i = i;
          best_mv = mv;
        }
      }
      if (best_i < 0) break;
      int j = nxt[best_i];
      ids[best_i] = best_mv.new_id;
      nxt[best_i] = nxt[j];
      if (nxt[j] != -1) prv[nxt[j]] = best_i;
      alive--;
    }
  } else {
    struct Entry {
      uint32_t rank;
      int i;
      uint32_t left, right;  // expected ids for stale detection
      uint32_t new_id;
      bool operator>(const Entry& o) const {
        return rank != o.rank ? rank > o.rank : i > o.i;
      }
    };
    std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
    std::vector<bool> dead(n, false);
    for (int i = 0; i + 1 < n; i++) {
      MergeVal mv;
      uint32_t r = rank_of(i, i + 1, &mv);
      if (r != kNoRank) heap.push({r, i, ids[i], ids[i + 1], mv.new_id});
    }
    while (!heap.empty()) {
      Entry e = heap.top();
      heap.pop();
      int i = e.i;
      if (dead[i] || ids[i] != e.left) continue;
      int j = nxt[i];
      if (j == -1 || dead[j] || ids[j] != e.right) continue;
      ids[i] = e.new_id;
      dead[j] = true;
      nxt[i] = nxt[j];
      if (nxt[j] != -1) prv[nxt[j]] = i;
      int pr = prv[i];
      if (pr != -1) {
        MergeVal mv;
        uint32_t r = rank_of(pr, i, &mv);
        if (r != kNoRank) heap.push({r, pr, ids[pr], ids[i], mv.new_id});
      }
      int q = nxt[i];
      if (q != -1) {
        MergeVal mv;
        uint32_t r = rank_of(i, q, &mv);
        if (r != kNoRank) heap.push({r, i, ids[i], ids[q], mv.new_id});
      }
    }
  }
}

// Encode one pre-tokenized piece (raw bytes, byte-level alphabet) into ids.
void bpe_piece(const Tok& T, const uint8_t* p, size_t len,
               std::vector<uint32_t>& out) {
  if (len == 0) return;
  if (T.ignore_merges) {
    auto it = T.vocab.find(std::string(reinterpret_cast<const char*>(p), len));
    if (it != T.vocab.end()) {
      out.push_back(it->second);
      return;
    }
  }
  if (len == 1) {
    out.push_back(static_cast<uint32_t>(T.byte_id[p[0]]));
    return;
  }
  thread_local std::vector<uint32_t> ids;
  thread_local std::vector<int32_t> nxt, prv;
  ids.clear();
  nxt.clear();
  prv.clear();
  ids.reserve(len);
  for (size_t i = 0; i < len; i++) {
    ids.push_back(static_cast<uint32_t>(T.byte_id[p[i]]));
  }
  int n = static_cast<int>(len);
  nxt.resize(n);
  prv.resize(n);
  for (int i = 0; i < n; i++) {
    nxt[i] = i + 1 < n ? i + 1 : -1;
    prv[i] = i - 1;
  }
  run_merges(T, ids, nxt, prv, n);
  for (int i = 0; i != -1; i = nxt[i]) out.push_back(ids[i]);
}

// Encode one piece with a CHARACTER alphabet (kind 4, sentencepiece-style
// BPE): each UTF-8 character is an initial symbol looked up in the vocab;
// characters outside the vocab become kUnkSym, resolved after merging to
// <0xXX> byte-fallback ids (BPE.byte_fallback) or the unk id (fused when
// fuse_unk), as HF tokenizers' BPE does.
void bpe_piece_chars(const Tok& T, const uint8_t* p, size_t len,
                     std::vector<uint32_t>& out) {
  if (len == 0) return;
  if (T.ignore_merges) {
    auto it = T.vocab.find(std::string(reinterpret_cast<const char*>(p), len));
    if (it != T.vocab.end()) {
      out.push_back(it->second);
      return;
    }
  }
  thread_local std::vector<uint32_t> ids;
  thread_local std::vector<int32_t> nxt, prv;
  thread_local std::vector<uint32_t> cpos, clen;  // byte range per symbol
  ids.clear();
  nxt.clear();
  prv.clear();
  cpos.clear();
  clen.clear();
  const uint8_t* end = p + len;
  const uint8_t* q = p;
  while (q < end) {
    int cl;
    uint32_t cp = decode_utf8(q, end, &cl);
    int32_t id;
    if (cl == 1) {
      id = T.byte_id[q[0]];
    } else {
      auto it = T.char_id.find(cp);
      id = it == T.char_id.end() ? -1 : it->second;
    }
    ids.push_back(id < 0 ? kUnkSym : static_cast<uint32_t>(id));
    cpos.push_back(static_cast<uint32_t>(q - p));
    clen.push_back(static_cast<uint32_t>(cl));
    q += cl;
  }
  int n = static_cast<int>(ids.size());
  nxt.resize(n);
  prv.resize(n);
  for (int i = 0; i < n; i++) {
    nxt[i] = i + 1 < n ? i + 1 : -1;
    prv[i] = i - 1;
  }
  run_merges(T, ids, nxt, prv, n);
  bool prev_unk = false;
  for (int i = 0; i != -1; i = nxt[i]) {
    if (ids[i] != kUnkSym) {
      out.push_back(ids[i]);
      prev_unk = false;
      continue;
    }
    // unknown char: byte fallback, else unk (kUnkSym never merges, so
    // its cpos/clen byte range is still the original character's)
    if (T.byte_fallback) {
      bool ok = true;
      for (uint32_t b = 0; b < clen[i] && ok; b++) {
        ok = T.byte_fb_id[p[cpos[i] + b]] >= 0;
      }
      if (ok) {
        for (uint32_t b = 0; b < clen[i]; b++) {
          out.push_back(
              static_cast<uint32_t>(T.byte_fb_id[p[cpos[i] + b]]));
        }
        prev_unk = false;
        continue;
      }
    }
    if (T.unk_id >= 0) {
      if (!(T.fuse_unk && prev_unk)) {
        out.push_back(static_cast<uint32_t>(T.unk_id));
      }
      prev_unk = true;
    }
  }
}

// Per-thread piece cache: piece bytes -> ids. Cleared when oversized
// (same policy as the Python implementation, without per-hit
// bookkeeping).
struct PieceCache {
  std::unordered_map<std::string, std::vector<uint32_t>> map;
  uint64_t owner = 0;  // Tok::gen this cache's entries belong to
  static constexpr size_t kCap = 1 << 17;
  static constexpr size_t kMaxPiece = 64;
};

// kind 4: the segment arrives ALREADY metaspace-transformed (the Python
// binding applies ' '->replacement and the prepend scheme — both single
// C-speed passes there); this side splits on the replacement when the
// pre-tokenizer asks (each occurrence starts a new piece, MergedWithNext)
// and runs char-alphabet BPE per piece.
void encode_segment_metaspace(const Tok& T, const uint8_t* p, size_t len,
                              std::vector<uint32_t>& out,
                              PieceCache& cache) {
  if (len == 0) return;
  bool word_mode = !T.ms_split && T.ms_word_split;
  if ((!T.ms_split && !word_mode) || T.replacement.empty()) {
    bpe_piece_chars(T, p, len, out);
    return;
  }
  const std::string& r = T.replacement;
  const uint8_t* end = p + len;
  const uint8_t* start = p;
  const uint8_t* q = p;
  auto flush = [&](const uint8_t* stop) {
    if (stop <= start) return;
    size_t plen = stop - start;
    if (plen <= PieceCache::kMaxPiece) {
      thread_local std::string key;
      key.assign(reinterpret_cast<const char*>(start), plen);
      auto it = cache.map.find(key);
      if (it != cache.map.end()) {
        out.insert(out.end(), it->second.begin(), it->second.end());
        return;
      }
      size_t before = out.size();
      bpe_piece_chars(T, start, plen, out);
      if (cache.map.size() >= PieceCache::kCap) cache.map.clear();
      cache.map.emplace(key, std::vector<uint32_t>(out.begin() + before,
                                                   out.end()));
    } else {
      bpe_piece_chars(T, start, plen, out);
    }
  };
  bool prev_repl = false;
  while (q < end) {
    bool is_repl = static_cast<size_t>(end - q) >= r.size() &&
                   std::memcmp(q, r.data(), r.size()) == 0;
    if (is_repl) {
      // ms_split: every replacement starts a new piece (MergedWithNext);
      // word mode: only the first replacement of a run does
      if (q > start && (T.ms_split || !prev_repl)) {
        flush(q);
        start = q;
      }
      q += r.size();
      prev_repl = true;
    } else {
      int cl;
      decode_utf8(q, end, &cl);
      q += cl;
      prev_repl = false;
    }
  }
  flush(end);
}

void encode_segment(const Tok& T, const uint8_t* p, size_t len,
                    std::vector<uint32_t>& out, PieceCache& cache) {
  if (len == 0) return;
  if (cache.owner != T.gen) {  // cache may be thread_local across handles
    cache.map.clear();
    cache.owner = T.gen;
  }
  if (T.pretok_kind == 4) {
    encode_segment_metaspace(T, p, len, out, cache);
    return;
  }
  thread_local std::string prefixed;
  if (T.add_prefix_space && p[0] != ' ') {
    prefixed.clear();
    prefixed.reserve(len + 1);
    prefixed.push_back(' ');
    prefixed.append(reinterpret_cast<const char*>(p), len);
    p = reinterpret_cast<const uint8_t*>(prefixed.data());
    len = prefixed.size();
  }
  const uint8_t* end = p + len;
  const uint8_t* q = p;
  thread_local std::string key;
  while (q < end) {
    size_t plen = T.match_piece(q, end);
    if (plen == 0) plen = 1;
    if (plen <= PieceCache::kMaxPiece) {
      key.assign(reinterpret_cast<const char*>(q), plen);
      auto it = cache.map.find(key);
      if (it != cache.map.end()) {
        out.insert(out.end(), it->second.begin(), it->second.end());
        q += plen;
        continue;
      }
      size_t before = out.size();
      bpe_piece(T, q, plen, out);
      if (cache.map.size() >= PieceCache::kCap) cache.map.clear();
      cache.map.emplace(key, std::vector<uint32_t>(out.begin() + before,
                                                   out.end()));
    } else {
      bpe_piece(T, q, plen, out);
    }
    q += plen;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// vocab blob layout: n_tokens entries of (u32 byte_len, bytes...), token id
// = entry index. merges: n_merges triples (left_id, right_id, merged_id) in
// rank order.
void* tg_tok_create(const uint8_t* vocab_blob, uint64_t vocab_blob_len,
                    uint32_t n_tokens, const uint32_t* merges,
                    uint32_t n_merges, int pretok_kind, int add_prefix_space,
                    int ignore_merges, int byte_fallback, int32_t unk_id,
                    int fuse_unk, int ms_split,
                    const uint8_t* replacement, uint32_t replacement_len) {
  auto* T = new Tok();
  T->pretok_kind = pretok_kind;
  T->add_prefix_space = add_prefix_space != 0;
  T->ignore_merges = ignore_merges != 0;
  T->byte_fallback = byte_fallback != 0;
  T->unk_id = unk_id;
  T->fuse_unk = fuse_unk != 0;
  T->ms_split = ms_split != 0;
  if (replacement != nullptr && replacement_len > 0) {
    T->replacement.assign(reinterpret_cast<const char*>(replacement),
                          replacement_len);
  }
  for (int i = 0; i < 256; i++) T->byte_id[i] = -1;
  for (int i = 0; i < 256; i++) T->byte_fb_id[i] = -1;
  T->vocab.reserve(n_tokens * 2);
  const uint8_t* p = vocab_blob;
  const uint8_t* end = vocab_blob + vocab_blob_len;
  for (uint32_t id = 0; id < n_tokens; id++) {
    if (p + 4 > end) {
      delete T;
      return nullptr;
    }
    uint32_t len;
    std::memcpy(&len, p, 4);
    p += 4;
    if (p + len > end) {
      delete T;
      return nullptr;
    }
    std::string tok(reinterpret_cast<const char*>(p), len);
    p += len;
    if (len == 1) T->byte_id[static_cast<uint8_t>(tok[0])] = id;
    T->vocab.emplace(std::move(tok), id);
  }
  if (pretok_kind != 4) {
    for (int i = 0; i < 256; i++) {
      if (T->byte_id[i] < 0) {
        // byte-level fast path requires a complete byte alphabet
        delete T;
        return nullptr;
      }
    }
  } else {
    if (T->byte_fallback) {
      // resolve the "<0xXX>" byte-fallback alphabet from the vocab
      char buf[8];
      for (int i = 0; i < 256; i++) {
        std::snprintf(buf, sizeof(buf), "<0x%02X>", i);
        auto it = T->vocab.find(buf);
        if (it != T->vocab.end()) {
          T->byte_fb_id[i] = static_cast<int32_t>(it->second);
        }
      }
    }
    // single-codepoint vocab entries -> char_id (initial-symbol lookup)
    for (const auto& [tok, id] : T->vocab) {
      if (tok.size() < 2) continue;
      const uint8_t* tp = reinterpret_cast<const uint8_t*>(tok.data());
      int cl;
      uint32_t cp = decode_utf8(tp, tp + tok.size(), &cl);
      if (static_cast<size_t>(cl) == tok.size()) {
        T->char_id.emplace(cp, static_cast<int32_t>(id));
      }
    }
    // prove the safe word split (see ms_word_split): replacement must be
    // a vocab char and every token's replacement occurrences must form a
    // prefix run. ignore_merges is excluded — its whole-piece direct
    // lookup is piece-shape dependent.
    if (!T->ms_split && !T->ignore_merges && !T->replacement.empty() &&
        T->vocab.count(T->replacement)) {
      bool ok = true;
      const std::string& r = T->replacement;
      for (const auto& [tok, id] : T->vocab) {
        size_t pos = 0;
        while (pos + r.size() <= tok.size() &&
               tok.compare(pos, r.size(), r) == 0) {
          pos += r.size();
        }
        if (tok.find(r, pos) != std::string::npos) {
          ok = false;
          break;
        }
      }
      T->ms_word_split = ok;
    }
  }
  T->merges.reserve(n_merges * 2);
  for (uint32_t r = 0; r < n_merges; r++) {
    uint64_t key = (static_cast<uint64_t>(merges[r * 3]) << 32) |
                   merges[r * 3 + 1];
    T->merges.emplace(key, MergeVal{r, merges[r * 3 + 2]});
  }
  return T;
}

void tg_tok_destroy(void* h) { delete static_cast<Tok*>(h); }

// Encode n_segments plain-text segments (concatenated in `text`,
// segment i = text[offsets[i], offsets[i+1])). Writes ids into out_ids
// (capacity out_cap) and per-segment end offsets into out_offsets
// (n_segments entries: out_offsets[i] = #ids written after segment i).
// Returns total ids, or -1 if out_cap is too small.
int64_t tg_tok_encode_batch(void* h, const uint8_t* text,
                            const uint64_t* offsets, uint32_t n_segments,
                            uint32_t* out_ids, uint64_t out_cap,
                            uint64_t* out_offsets, int num_threads) {
  const Tok& T = *static_cast<Tok*>(h);
  if (n_segments == 0) return 0;
  if (num_threads <= 1 || n_segments == 1) {
    thread_local PieceCache cache;
    std::vector<uint32_t> buf;
    uint64_t written = 0;
    for (uint32_t i = 0; i < n_segments; i++) {
      buf.clear();
      encode_segment(T, text + offsets[i], offsets[i + 1] - offsets[i], buf,
                     cache);
      if (written + buf.size() > out_cap) return -1;
      std::memcpy(out_ids + written, buf.data(), buf.size() * 4);
      written += buf.size();
      out_offsets[i] = written;
    }
    return static_cast<int64_t>(written);
  }

  int nt = std::min<int>(num_threads, n_segments);
  std::vector<std::vector<std::vector<uint32_t>>> results(nt);
  std::atomic<uint32_t> next{0};
  std::vector<std::vector<std::pair<uint32_t, size_t>>> idx(nt);
  auto worker = [&](int t) {
    PieceCache cache;
    for (;;) {
      uint32_t i = next.fetch_add(1);
      if (i >= n_segments) break;
      std::vector<uint32_t> buf;
      encode_segment(T, text + offsets[i], offsets[i + 1] - offsets[i], buf,
                     cache);
      idx[t].emplace_back(i, results[t].size());
      results[t].push_back(std::move(buf));
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; t++) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();

  // stitch in segment order
  std::vector<const std::vector<uint32_t>*> per_seg(n_segments, nullptr);
  for (int t = 0; t < nt; t++) {
    for (auto& [seg, slot] : idx[t]) per_seg[seg] = &results[t][slot];
  }
  uint64_t written = 0;
  for (uint32_t i = 0; i < n_segments; i++) {
    const auto& buf = *per_seg[i];
    if (written + buf.size() > out_cap) return -1;
    std::memcpy(out_ids + written, buf.data(), buf.size() * 4);
    written += buf.size();
    out_offsets[i] = written;
  }
  return static_cast<int64_t>(written);
}

int tg_tok_abi_version() { return 2; }

}  // extern "C"
