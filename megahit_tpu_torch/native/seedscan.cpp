// Native host cores for the read-pool scan stages and big flat sorts.
//
// seed_scan: rolling-window scan of the 2-bit packed base pool against
// a sorted (W x u32, big-endian, left-aligned) k-mer table, with a
// bitmap prefilter in front of the binary search. One sequential pass
// per read replaces the per-position "extract dense k-mers -> device
// canonicalize -> u64 convert -> searchsorted" pipeline of the mapper
// (reference HashMapper::TryMap seed loop, src/localasm/hash_mapper.cpp:
// 136-268) and the iterate flank probe (reference ContigFlankIndex::
// FindNextKmersFromRead hash lookups, src/iterate/contig_flank_index.h:
// 113-170). Multithreaded over read ranges; hit order == ascending
// position order (threads own contiguous read ranges).
//
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// base at global position p: word p/16, big-endian 2-bit lanes
static inline uint32_t base_at(const uint32_t* pool, int64_t p) {
  return (pool[p >> 4] >> (30 - 2 * (p & 15))) & 3u;
}

struct Key {
  // left-aligned big-endian 2-bit window in W u32 words (tail zero)
  uint32_t w[16];
};

static inline int cmp_rows(const uint32_t* a, const uint32_t* b, int W) {
  for (int i = 0; i < W; ++i) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

// lower_bound over (n, W) u32 rows
static inline int64_t lower_bound_rows(const uint32_t* table, int64_t n,
                                       int W, const uint32_t* q) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (cmp_rows(table + mid * W, q, W) < 0)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

static inline uint64_t head64(const uint32_t* q, int W) {
  uint64_t h = (uint64_t)q[0] << 32;
  if (W > 1) h |= q[1];
  return h;
}

struct Bitmap {
  std::vector<uint64_t> bits;
  int log2n = 0;
  void build(const uint32_t* table, int64_t n, int W) {
    int64_t want = n * 48;
    log2n = 16;
    while (((int64_t)1 << log2n) < want && log2n < 30) ++log2n;
    bits.assign(((int64_t)1 << log2n) >> 6, 0);
    for (int64_t i = 0; i < n; ++i) {
      uint64_t h = head64(table + i * W, W) * 0x9E3779B97F4A7C15ull;
      uint64_t b = h >> (64 - log2n);
      bits[b >> 6] |= 1ull << (b & 63);
    }
  }
  inline bool test(uint64_t head) const {
    uint64_t h = head * 0x9E3779B97F4A7C15ull;
    uint64_t b = h >> (64 - log2n);
    return (bits[b >> 6] >> (b & 63)) & 1;
  }
};

struct ThreadOut {
  std::vector<int64_t> pos;
  std::vector<int32_t> rid;
  std::vector<int32_t> ia;
  std::vector<int32_t> ib;
  std::vector<uint8_t> flag;
};

enum Mode { MODE_CANON = 0, MODE_FWD = 1, MODE_BOTH = 2 };

// u64 fast path (k <= 32): the whole window rides in one register as
// (word0 << 32) | word1 -- identical numeric order to the (W, u32)
// big-endian row order, so table indices line up with the row table.
static void scan_range_u64(const uint32_t* pool, const int64_t* starts,
                           int64_t r0, int64_t r1, int k, int mode,
                           int64_t min_read_len, const uint64_t* table,
                           int64_t n_table, const Bitmap& bm,
                           ThreadOut* out) {
  const int sh_in = 64 - 2 * k;  // left-aligned: lowest used bit index
  const uint64_t mask = sh_in >= 64 ? 0 : (~0ull << sh_in);
  auto probe = [&](uint64_t q) -> int64_t {
    if (!bm.test(q)) return -1;
    const uint64_t* it = std::lower_bound(table, table + n_table, q);
    return (it != table + n_table && *it == q) ? it - table : -1;
  };
  for (int64_t r = r0; r < r1; ++r) {
    int64_t s = starts[r], e = starts[r + 1];
    int64_t len = e - s;
    if (len < k || len < min_read_len) continue;
    uint64_t fwd = 0, rc = 0;
    for (int64_t j = 0; j < k; ++j) {
      uint64_t b = base_at(pool, s + j);
      fwd |= b << (62 - 2 * j);
      rc |= (3ull - b) << (62 - 2 * (k - 1 - j));
    }
    for (int64_t p = s;; ++p) {
      if (mode == MODE_CANON) {
        uint64_t q = fwd <= rc ? fwd : rc;
        int64_t i = probe(q);
        if (i >= 0) {
          out->pos.push_back(p);
          out->rid.push_back((int32_t)r);
          out->ia.push_back((int32_t)i);
          out->flag.push_back(fwd <= rc ? 0 : 1);
        }
      } else if (mode == MODE_FWD) {
        int64_t i = probe(fwd);
        if (i >= 0) {
          out->pos.push_back(p);
          out->rid.push_back((int32_t)r);
          out->ia.push_back((int32_t)i);
        }
      } else {
        int32_t fa = (int32_t)probe(fwd);
        int32_t fb = (int32_t)probe(rc);
        if (fa >= 0 || fb >= 0) {
          out->pos.push_back(p);
          out->rid.push_back((int32_t)r);
          out->ia.push_back(fa);
          out->ib.push_back(fb);
        }
      }
      if (p + k >= e) break;
      uint64_t nb = base_at(pool, p + k);
      fwd = ((fwd << 2) | (nb << sh_in)) & mask;
      rc = ((rc >> 2) & mask) | ((3ull - nb) << 62);
    }
  }
}

static void scan_range(const uint32_t* pool, const int64_t* starts,
                       int64_t r0, int64_t r1, int k, int W, int mode,
                       int64_t min_read_len, const uint32_t* table,
                       int64_t n_table, const Bitmap& bm, ThreadOut* out) {
  // rolling fwd / rc windows in left-aligned big-endian W-word form
  uint32_t fwd[16], rc[16], canon_buf[16];
  const int last_wi = (k - 1) >> 4;           // word of base k-1
  const int last_sh = 30 - 2 * ((k - 1) & 15);
  // mask for clearing bits at positions >= 2k after the rc >> 2 shift
  uint32_t tail_mask[16];
  for (int i = 0; i < W; ++i) tail_mask[i] = 0xFFFFFFFFu;
  {
    int used = k - 16 * last_wi;  // bases in the last used word
    tail_mask[last_wi] = used >= 16 ? 0xFFFFFFFFu
                                    : ~((1u << (32 - 2 * used)) - 1u);
    for (int i = last_wi + 1; i < W; ++i) tail_mask[i] = 0;
  }
  for (int64_t r = r0; r < r1; ++r) {
    int64_t s = starts[r], e = starts[r + 1];
    int64_t len = e - s;
    if (len < k || len < min_read_len) continue;
    // prime the first window
    std::memset(fwd, 0, sizeof(uint32_t) * W);
    std::memset(rc, 0, sizeof(uint32_t) * W);
    for (int64_t j = 0; j < k; ++j) {
      uint32_t b = base_at(pool, s + j);
      fwd[j >> 4] |= b << (30 - 2 * (j & 15));
      int64_t rj = k - 1 - j;
      rc[rj >> 4] |= (3u - b) << (30 - 2 * (rj & 15));
    }
    for (int64_t p = s;; ++p) {
      // probe the window starting at p
      const uint32_t* q;
      uint8_t is_rc = 0;
      if (mode == MODE_CANON) {
        int c = cmp_rows(fwd, rc, W);
        if (c <= 0) {
          q = fwd;
        } else {
          q = rc;
          is_rc = 1;
        }
        std::memcpy(canon_buf, q, sizeof(uint32_t) * W);
        if (bm.test(head64(canon_buf, W))) {
          int64_t i = lower_bound_rows(table, n_table, W, canon_buf);
          if (i < n_table && cmp_rows(table + i * W, canon_buf, W) == 0) {
            out->pos.push_back(p);
            out->rid.push_back((int32_t)r);
            out->ia.push_back((int32_t)i);
            out->flag.push_back(is_rc);
          }
        }
      } else if (mode == MODE_FWD) {
        if (bm.test(head64(fwd, W))) {
          int64_t i = lower_bound_rows(table, n_table, W, fwd);
          if (i < n_table && cmp_rows(table + i * W, fwd, W) == 0) {
            out->pos.push_back(p);
            out->rid.push_back((int32_t)r);
            out->ia.push_back((int32_t)i);
          }
        }
      } else {  // MODE_BOTH
        int32_t fa = -1, fb = -1;
        if (bm.test(head64(fwd, W))) {
          int64_t i = lower_bound_rows(table, n_table, W, fwd);
          if (i < n_table && cmp_rows(table + i * W, fwd, W) == 0)
            fa = (int32_t)i;
        }
        if (bm.test(head64(rc, W))) {
          int64_t i = lower_bound_rows(table, n_table, W, rc);
          if (i < n_table && cmp_rows(table + i * W, rc, W) == 0)
            fb = (int32_t)i;
        }
        if (fa >= 0 || fb >= 0) {
          out->pos.push_back(p);
          out->rid.push_back((int32_t)r);
          out->ia.push_back(fa);
          out->ib.push_back(fb);
        }
      }
      if (p + k >= e) break;
      // roll: append base at p + k
      uint32_t nb = base_at(pool, p + k);
      for (int i = 0; i < W - 1; ++i)
        fwd[i] = (fwd[i] << 2) | (fwd[i + 1] >> 30);
      fwd[W - 1] <<= 2;
      fwd[last_wi] |= nb << last_sh;
      for (int i = W - 1; i > 0; --i)
        rc[i] = (rc[i] >> 2) | (rc[i - 1] << 30);
      rc[0] = (rc[0] >> 2) | ((3u - nb) << 30);
      for (int i = 0; i < W; ++i) rc[i] &= tail_mask[i];
    }
  }
}

}  // namespace

extern "C" {

struct ScanResult {
  int64_t n;
  int64_t* pos;
  int32_t* rid;
  int32_t* ia;
  int32_t* ib;
  uint8_t* flag;
};

// Scan every length-k window fully inside one read of the packed pool
// against the sorted table. mode: 0 = canonical (emit pos, table idx,
// is_rc), 1 = forward only (pos, idx), 2 = both strands (pos, idx_fwd,
// idx_rc; -1 where absent). Reads shorter than min_read_len skipped.
ScanResult* seed_scan(const uint32_t* pool, const int64_t* starts,
                      int64_t n_reads, int k, int W, int mode,
                      int64_t min_read_len, const uint32_t* table,
                      int64_t n_table, int n_threads) {
  auto* res = (ScanResult*)std::calloc(1, sizeof(ScanResult));
  if (n_table == 0 || n_reads == 0 || k <= 0 || W <= 0 || W > 16)
    return res;
  Bitmap bm;
  bm.build(table, n_table, W);
  int T = n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads);
  int64_t total_bases = starts[n_reads];
  std::vector<ThreadOut> outs(T);
  std::vector<std::thread> threads;
  // split reads so each thread owns a contiguous, ~equal-base range
  std::vector<int64_t> cut(T + 1, n_reads);
  cut[0] = 0;
  for (int t = 1; t < T; ++t) {
    int64_t want = total_bases * t / T;
    cut[t] = std::lower_bound(starts, starts + n_reads + 1, want) - starts;
    if (cut[t] > n_reads) cut[t] = n_reads;
  }
  std::vector<uint64_t> table64;
  if (k <= 32) {
    table64.resize(n_table);
    for (int64_t i = 0; i < n_table; ++i)
      table64[i] = head64(table + i * W, W);
  }
  for (int t = 0; t < T; ++t) {
    int64_t r0 = cut[t], r1 = cut[t + 1];
    if (r0 >= r1) continue;
    if (k <= 32)
      threads.emplace_back(scan_range_u64, pool, starts, r0, r1, k,
                           mode, min_read_len, table64.data(), n_table,
                           std::cref(bm), &outs[t]);
    else
      threads.emplace_back(scan_range, pool, starts, r0, r1, k, W, mode,
                           min_read_len, table, n_table, std::cref(bm),
                           &outs[t]);
  }
  for (auto& th : threads) th.join();
  int64_t n = 0;
  for (auto& o : outs) n += (int64_t)o.pos.size();
  res->n = n;
  res->pos = (int64_t*)std::malloc(sizeof(int64_t) * (n ? n : 1));
  res->rid = (int32_t*)std::malloc(sizeof(int32_t) * (n ? n : 1));
  res->ia = (int32_t*)std::malloc(sizeof(int32_t) * (n ? n : 1));
  res->flag = (uint8_t*)std::malloc(n ? n : 1);
  bool both = mode == MODE_BOTH;
  res->ib = both ? (int32_t*)std::malloc(sizeof(int32_t) * (n ? n : 1))
                 : nullptr;
  int64_t off = 0;
  for (auto& o : outs) {
    int64_t m = (int64_t)o.pos.size();
    if (!m) continue;
    std::memcpy(res->pos + off, o.pos.data(), sizeof(int64_t) * m);
    std::memcpy(res->rid + off, o.rid.data(), sizeof(int32_t) * m);
    std::memcpy(res->ia + off, o.ia.data(), sizeof(int32_t) * m);
    if (both) std::memcpy(res->ib + off, o.ib.data(), sizeof(int32_t) * m);
    if (!o.flag.empty())
      std::memcpy(res->flag + off, o.flag.data(), m);
    else
      std::memset(res->flag + off, 0, m);
    off += m;
  }
  return res;
}

void seed_scan_free(ScanResult* r) {
  if (!r) return;
  std::free(r->pos);
  std::free(r->rid);
  std::free(r->ia);
  std::free(r->ib);
  std::free(r->flag);
  std::free(r);
}

}  // extern "C"

namespace {

static inline uint32_t rev2_u32(uint32_t x) {
  // reverse the 16 2-bit groups within a u32
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  return __builtin_bswap32(x);
}

// reverse the first kk bases of a left-aligned row whose bits beyond
// kk are zero; result left-aligned with zero tail
static inline void reverse_bases(const uint32_t* in, int W, int kk,
                                 uint32_t* out) {
  uint32_t tmp[16];
  for (int i = 0; i < W; ++i) tmp[i] = rev2_u32(in[W - 1 - i]);
  int shift_bases = 16 * W - kk;
  int word_sh = shift_bases >> 4;
  int bit_sh = 2 * (shift_bases & 15);
  for (int i = 0; i < W; ++i) {
    int src = i + word_sh;
    uint64_t v = 0;
    if (src < W) v = ((uint64_t)tmp[src]) << 32;
    if (src + 1 < W) v |= tmp[src + 1];
    out[i] = (uint32_t)((v << bit_sh) >> 32);
  }
}

static inline void mask_row_tail(uint32_t* row, int W, int kk) {
  // zero all bits at base positions >= kk
  int wi = kk >> 4, used = kk & 15;
  if (wi < W) {
    row[wi] &= used ? (0xFFFFFFFFu << (32 - 2 * used)) : 0u;
    for (int i = wi + 1; i < W; ++i) row[i] = 0;
  }
}

enum TransformOp { OP_REVCOMP = 0, OP_REF_ORDER = 1, OP_DROP_FIRST = 2 };

static void transform_range(const uint32_t* keys, int64_t lo, int64_t hi,
                            int k, int W, int op, uint32_t* out) {
  uint32_t buf[16];
  for (int64_t r = lo; r < hi; ++r) {
    const uint32_t* in = keys + r * W;
    uint32_t* o = out + r * W;
    if (op == OP_REVCOMP) {
      for (int i = 0; i < W; ++i) buf[i] = ~in[i];
      mask_row_tail(buf, W, k);
      reverse_bases(buf, W, k, o);
    } else if (op == OP_DROP_FIRST) {
      // keys[1:k] ++ zero base: left shift one base, tail masked to k
      for (int i = 0; i < W - 1; ++i)
        o[i] = (in[i] << 2) | (in[i + 1] >> 30);
      o[W - 1] = in[W - 1] << 2;
      mask_row_tail(o, W, k);
    } else {  // ref_order: reverse(chars[0..k-2]) ++ chars[k-1]
      for (int i = 0; i < W; ++i) buf[i] = in[i];
      mask_row_tail(buf, W, k - 1);
      reverse_bases(buf, W, k - 1, o);
      int p = k - 1;
      uint32_t last = (in[p >> 4] >> (30 - 2 * (p & 15))) & 3u;
      o[p >> 4] |= last << (30 - 2 * (p & 15));
    }
  }
}

static void row_search_range(const uint32_t* table, int64_t n,
                             const uint32_t* q, int64_t lo, int64_t hi,
                             int W, int64_t* idx, uint8_t* found) {
  for (int64_t r = lo; r < hi; ++r) {
    const uint32_t* qq = q + r * W;
    int64_t i = lower_bound_rows(table, n, W, qq);
    idx[r] = i;
    found[r] = (i < n && cmp_rows(table + i * W, qq, W) == 0) ? 1 : 0;
  }
}

static void row_search_range_u64(const uint64_t* table, int64_t n,
                                 const uint32_t* q, int64_t lo,
                                 int64_t hi, int W, int64_t* idx,
                                 uint8_t* found) {
  for (int64_t r = lo; r < hi; ++r) {
    uint64_t qq = head64(q + r * W, W);
    const uint64_t* it = std::lower_bound(table, table + n, qq);
    idx[r] = it - table;
    found[r] = (it != table + n && *it == qq) ? 1 : 0;
  }
}

template <typename F>
static void par_ranges(int64_t n, int n_threads, F fn) {
  int T = n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads);
  if (T == 1 || n < (int64_t)1 << 16) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t)
    threads.emplace_back([&, t] { fn(n * t / T, n * (t + 1) / T); });
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// (n, W) left-aligned 2-bit rows -> per-row transform. op 0 = reverse
// complement (kmerops.revcomp_kmers); op 1 = reference edge-id order
// transform reverse(chars[0..k-2]) ++ chars[k-1]
// (kmerops.ref_order_keys).
void transform_rows(const uint32_t* keys, int64_t n, int k, int W,
                    int op, uint32_t* out, int n_threads) {
  if (W > 16) {  // transform_range uses uint32_t[16] row buffers.
    // Unsupported: zero the output so a direct C caller cannot
    // mistake untransformed keys for a result (the Python wrapper
    // returns None for W > 16 before ever calling in here).
    for (int64_t i = 0; i < n * W; ++i) out[i] = 0;
    return;
  }
  par_ranges(n, n_threads, [&](int64_t lo, int64_t hi) {
    transform_range(keys, lo, hi, k, W, op, out);
  });
}

// Lexicographic argsort of (n, W) u32 rows (UNSTABLE between equal
// rows, like every sort in this engine). Every width rides a 24-byte
// {a, b, idx} struct (first 4 words cached in the item) through an MSD
// top-byte bucket scatter + parallel per-bucket std::sort; W > 4
// resolves 128-bit-prefix ties by comparing the row tails in place -
// ties are rare (shared 64-base prefixes), so the extra gather only
// touches collision groups.
void argsort_rows(const uint32_t* keys, int64_t n, int W, int64_t* perm,
                  int n_threads) {
  int T = n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads);
  struct Item {
    uint64_t a, b;
    int64_t idx;
  };
  std::vector<Item> items(n);
  par_ranges(n, T, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint32_t* r = keys + i * W;
      uint64_t a = (uint64_t)r[0] << 32 | (W > 1 ? r[1] : 0);
      uint64_t b = W > 2 ? ((uint64_t)r[2] << 32 | (W > 3 ? r[3] : 0))
                         : 0;
      items[i] = {a, b, i};
    }
  });
  auto less = [keys, W](const Item& x, const Item& y) {
    if (x.a != y.a) return x.a < y.a;
    if (x.b != y.b) return x.b < y.b;
    if (W <= 4) return false;
    return cmp_rows(keys + x.idx * W + 4, keys + y.idx * W + 4,
                    W - 4) < 0;
  };
  if (n < (int64_t)1 << 20 || T == 1) {
    std::sort(items.begin(), items.end(), less);
  } else {
    const int B = 256;
    std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(B, 0));
    std::vector<std::thread> threads;
    auto seg = [&](int t) { return std::pair{n * t / T, n * (t + 1) / T}; };
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, t] {
        auto [lo, hi] = seg(t);
        for (int64_t i = lo; i < hi; ++i) ++hist[t][items[i].a >> 56];
      });
    for (auto& th : threads) th.join();
    threads.clear();
    std::vector<int64_t> bstart(B + 1, 0);
    for (int b = 0; b < B; ++b) {
      int64_t s = 0;
      for (int t = 0; t < T; ++t) s += hist[t][b];
      bstart[b + 1] = bstart[b] + s;
    }
    std::vector<std::vector<int64_t>> cur(T, std::vector<int64_t>(B));
    for (int b = 0; b < B; ++b) {
      int64_t off = bstart[b];
      for (int t = 0; t < T; ++t) {
        cur[t][b] = off;
        off += hist[t][b];
      }
    }
    std::vector<Item> tmp(n);
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, t] {
        auto [lo, hi] = seg(t);
        auto& c = cur[t];
        for (int64_t i = lo; i < hi; ++i)
          tmp[c[items[i].a >> 56]++] = items[i];
      });
    for (auto& th : threads) th.join();
    threads.clear();
    std::atomic<int> next{0};
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&] {
        for (;;) {
          int b = next.fetch_add(1);
          if (b >= B) break;
          std::sort(tmp.begin() + bstart[b], tmp.begin() + bstart[b + 1],
                    less);
        }
      });
    for (auto& th : threads) th.join();
    items.swap(tmp);
  }
  par_ranges(n, T, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) perm[i] = items[i].idx;
  });
}

// Batched lower_bound of (nq, W) query rows in the sorted (n, W)
// table; idx = insertion points, found = exact-match flags.
// Simple-path links over the run-based SdBG navigation core: nxt[e] =
// the unique valid out-edge of e's target node when that node has
// out-degree 1 and in-degree 1; prv is the exact inverse (graph/sdbg.py
// simple_path_links_host; reference SDBG::NextSimplePathEdge,
// sdbg.h:418-427). Threaded: the work is ~5 random gathers per edge.
// prv writes are race-free (nxt is injective on valid edges).
void simple_links(const int32_t* run_start, const int32_t* nxt_link,
                  const int32_t* rc, const uint8_t* valid,
                  const int32_t* rvc, int64_t e, int64_t real,
                  int32_t* nxt, int32_t* prv, int n_threads) {
  par_ranges(e, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      nxt[i] = -1;
      prv[i] = -1;
      if (!valid[i]) continue;
      int32_t nl = nxt_link[i];
      if (nl < 0 || rvc[nl] != 1) continue;
      if (rvc[run_start[rc[i]]] != 1) continue;
      int32_t m = nl;  // singleton runs: the start IS the member
      int64_t end = nl + 4 < real ? nl + 4 : real;
      for (int64_t j = nl; j < end && run_start[j] == nl; ++j)
        if (valid[j]) { m = (int32_t)j; break; }
      nxt[i] = m;
    }
  });
  par_ranges(e, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      if (nxt[i] >= 0) prv[nxt[i]] = i;
  });
}

void row_search(const uint32_t* table, int64_t n, const uint32_t* q,
                int64_t nq, int W, int64_t* idx, uint8_t* found,
                int n_threads) {
  if (W <= 2) {
    std::vector<uint64_t> t64(n);
    for (int64_t i = 0; i < n; ++i) t64[i] = head64(table + i * W, W);
    par_ranges(nq, n_threads, [&](int64_t lo, int64_t hi) {
      row_search_range_u64(t64.data(), n, q, lo, hi, W, idx, found);
    });
    return;
  }
  par_ranges(nq, n_threads, [&](int64_t lo, int64_t hi) {
    row_search_range(table, n, q, lo, hi, W, idx, found);
  });
}

}  // extern "C"
