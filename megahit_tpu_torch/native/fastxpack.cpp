// Native host-side sequence I/O core.
//
// The reference implements its host I/O hot path in C++ (kseq-based
// FastxReader + 2-bit SequencePackage packing, reference
// src/sequence/io/fastx_reader.cpp, src/sequence/sequence_package.h).
// This is the equivalent native core for this package: parse a
// decompressed FASTA/FASTQ buffer into 2-bit base codes in one pass,
// with the reference's N-trimming rule (keep only the FIRST maximal
// run of ACGT characters, fastx_reader.cpp:56-71).
//
// Build: g++ -O3 -march=native -shared -fPIC fastxpack.cpp -o libfastxpack.so
// Loaded from Python via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

// ASCII -> 2-bit code; 4 = N/unknown (matches packing.py _CODE_LUT
// except unknowns are distinguished here for trimming)
struct Lut {
  uint8_t v[256];
  Lut() {
    memset(v, 4, sizeof(v));
    v[(int)'A'] = v[(int)'a'] = 0;
    v[(int)'C'] = v[(int)'c'] = 1;
    v[(int)'G'] = v[(int)'g'] = 2;
    v[(int)'T'] = v[(int)'t'] = 3;
  }
};
const Lut kLut;

// append one sequence's codes with first-maximal-ACGT-run trimming;
// returns trimmed length
inline int64_t emit_seq(const uint8_t *seq, int64_t len, uint8_t *out,
                        int trim_n) {
  if (!trim_n) {
    for (int64_t i = 0; i < len; ++i) {
      uint8_t c = kLut.v[seq[i]];
      out[i] = c == 4 ? 2 : c;  // N -> G like reference dna_map_
    }
    return len;
  }
  int64_t b = 0;
  while (b < len && kLut.v[seq[b]] == 4) ++b;
  int64_t e = b;
  while (e < len && kLut.v[seq[e]] != 4) ++e;
  for (int64_t i = b; i < e; ++i) out[i - b] = kLut.v[seq[i]];
  return e - b;
}

}  // namespace

extern "C" {

// Parse a FASTA or FASTQ text buffer.
//   buf/n:      decompressed file contents
//   out_codes:  caller buffer of capacity >= n (2-bit codes, one byte each)
//   out_lens:   caller buffer of capacity max_seqs (per-seq code length)
//   trim_n:     1 = keep first maximal ACGT run only
// Returns the number of sequences parsed, or -1 on malformed input,
// -2 if max_seqs exceeded.
int64_t fastx_parse(const uint8_t *buf, int64_t n, uint8_t *out_codes,
                    int64_t *out_lens, int64_t max_seqs, int trim_n) {
  int64_t i = 0, n_seqs = 0, out_pos = 0;
  // skip leading blank lines
  while (i < n && (buf[i] == '\n' || buf[i] == '\r')) ++i;
  if (i >= n) return 0;
  const int is_fastq = buf[i] == '@';
  if (!is_fastq && buf[i] != '>') return -1;

  // memchr-based line stepping: glibc memchr is SIMD, so scanning for
  // '\n' runs at memory bandwidth instead of byte-at-a-time branches
  auto next_nl = [&](int64_t from) -> int64_t {
    if (from >= n) return n;  // clamp: negative n-from would wrap size_t
    const void *p = memchr(buf + from, '\n', n - from);
    return p ? (const uint8_t *)p - buf : n;
  };

  while (i < n) {
    if (buf[i] == '\n' || buf[i] == '\r') { ++i; continue; }
    if (buf[i] != (is_fastq ? '@' : '>')) return -1;
    i = next_nl(i) + 1;  // skip header line
    if (n_seqs >= max_seqs) return -2;
    if (i >= n) {  // truncated record: header at EOF, no sequence line
      out_lens[n_seqs++] = 0;
      break;
    }

    // sequence: fasta = lines until next '>'; fastq = one line
    int64_t seq_start_out = out_pos;
    uint8_t *raw = out_codes + out_pos;  // collect raw chars in place
    int64_t raw_len = 0;
    if (is_fastq) {
      int64_t e = next_nl(i);
      raw_len = e - i;
      memcpy(raw, buf + i, raw_len);
      if (raw_len && raw[raw_len - 1] == '\r') --raw_len;
      i = next_nl(e + 1) + 1;  // skip '+' line
      // quality spans the same number of non-newline chars as seq
      int64_t q = 0;
      while (i < n && q < raw_len) {
        int64_t e2 = next_nl(i);
        q += e2 - i;
        i = e2 + 1;
      }
    } else {
      while (i < n && buf[i] != '>') {
        int64_t e = next_nl(i);
        int64_t len = e - i;
        if (len && buf[e - 1] == '\r') --len;
        memcpy(raw + raw_len, buf + i, len);
        raw_len += len;
        i = e + 1;
      }
    }
    // translate+trim in place (emit_seq reads raw before writing codes:
    // both directions only shrink, so in-place is safe left-to-right)
    int64_t coded = emit_seq(raw, raw_len, raw, trim_n);
    out_lens[n_seqs++] = coded;
    out_pos = seq_start_out + coded;
  }
  return n_seqs;
}

// Streaming variant: parse only COMPLETE records, reporting how many
// input bytes were consumed so the caller can carry the tail into the
// next chunk (chunked ingestion overlapping decompression; reference
// feeds decompressors through FIFOs, src/megahit:700-745).
//   eof: 1 = buffer is the end of the stream (parse everything,
//        truncated-record semantics as fastx_parse); 0 = the final
//        possibly-incomplete record is rolled back.
// Returns n_seqs (>= 0), -1 malformed, -2 max_seqs exceeded.
// *consumed is set to the byte offset after the last complete record
// (== n when eof or everything parsed).
int64_t fastx_parse_partial(const uint8_t *buf, int64_t n, int eof,
                            uint8_t *out_codes, int64_t *out_lens,
                            int64_t max_seqs, int trim_n,
                            int64_t *consumed) {
  int64_t i = 0, n_seqs = 0, out_pos = 0;
  *consumed = 0;
  while (i < n && (buf[i] == '\n' || buf[i] == '\r')) ++i;
  if (i >= n) {
    *consumed = n;
    return 0;
  }
  const int is_fastq = buf[i] == '@';
  if (!is_fastq && buf[i] != '>') return -1;

  auto next_nl = [&](int64_t from) -> int64_t {
    if (from >= n) return n;
    const void *p = memchr(buf + from, '\n', n - from);
    return p ? (const uint8_t *)p - buf : n;
  };

  while (i < n) {
    if (buf[i] == '\n' || buf[i] == '\r') { ++i; continue; }
    if (buf[i] != (is_fastq ? '@' : '>')) return -1;
    int64_t rec_start = i;
    i = next_nl(i) + 1;  // skip header line
    if (n_seqs >= max_seqs) return -2;
    if (i >= n) {
      if (!eof) { *consumed = rec_start; return n_seqs; }
      out_lens[n_seqs++] = 0;
      *consumed = n;
      return n_seqs;
    }
    int64_t seq_start_out = out_pos;
    uint8_t *raw = out_codes + out_pos;
    int64_t raw_len = 0;
    int complete = 1;
    if (is_fastq) {
      int64_t e = next_nl(i);
      raw_len = e - i;
      memcpy(raw, buf + i, raw_len);
      if (raw_len && raw[raw_len - 1] == '\r') --raw_len;
      i = next_nl(e + 1) + 1;  // skip '+' line
      int64_t q = 0;
      while (i < n && q < raw_len) {
        int64_t e2 = next_nl(i);
        q += e2 - i;
        i = e2 + 1;
      }
      // quality must be fully present; a record whose parse ran off
      // the buffer before that may be cut mid-line (q == raw_len > 0
      // is decisive even at the buffer end: quality length equals
      // sequence length, so it cannot continue)
      if (!eof && (q < raw_len || (raw_len == 0 && i >= n)))
        complete = 0;
    } else {
      while (i < n && buf[i] != '>') {
        int64_t e = next_nl(i);
        int64_t len = e - i;
        if (len && buf[e - 1] == '\r') --len;
        memcpy(raw + raw_len, buf + i, len);
        raw_len += len;
        i = e + 1;
      }
      // a FASTA record is only known complete once the next '>' (or
      // the true end of the stream) is seen
      if (!eof && i >= n) complete = 0;
    }
    if (!complete) {
      *consumed = rec_start;
      return n_seqs;
    }
    int64_t coded = emit_seq(raw, raw_len, raw, trim_n);
    out_lens[n_seqs++] = coded;
    out_pos = seq_start_out + coded;
    *consumed = i < n ? i : n;
  }
  *consumed = n;
  return n_seqs;
}

// Pack base codes (one byte each, values 0..3) into big-endian 2-bit
// words: base i occupies bits [30-2*(i%16), 32-2*(i%16)) of word i/16.
// out must have capacity ceil(n/16) words, zero-initialised by callee.
void pack_codes(const uint8_t *codes, int64_t n, uint32_t *out) {
  int64_t nw = (n + 15) / 16;
  for (int64_t w = 0; w < nw; ++w) out[w] = 0;
  for (int64_t i = 0; i < n; ++i) {
    out[i >> 4] |= (uint32_t)(codes[i] & 3) << (30 - 2 * (i & 15));
  }
}

}  // extern "C"
