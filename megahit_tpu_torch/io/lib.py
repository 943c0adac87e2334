"""Sequence library building (reference `buildlib`,
src/sequence/io/sequence_lib.cpp:8-125).

A SequenceLib is the device-ready pool of all input reads: one flat 2-bit
packable code array + start offsets + per-library ranges. The on-disk
format is a single .npz (a deliberate redesign of the reference's
.bin/.lib_info pair, reference appendix: sequence_package.h:224-240) -
it carries the same information: per-lib (begin, end, max_len,
is_paired) and the packed reads.
"""

from __future__ import annotations

import numpy as np


class PackedPool:
    """2-bit packed base pool (16 bases per big-endian u32 word - the
    key layout everywhere). Backing store is either an in-RAM word
    array or a window into a raw file on disk: consumers only ever
    materialize bounded windows, so host RSS stays independent of pool
    size (the reference's bounded double-buffered reader batches,
    async_sequence_reader.h:46-47, generalized to every pool scan)."""

    def __init__(self, n_bases: int, words: np.ndarray | None = None,
                 path: str | None = None, byte_offset: int = 0):
        self.n_bases = int(n_bases)
        self.n_words = (self.n_bases + 15) // 16
        self._words = words
        self._path = path
        self._off = int(byte_offset)
        self._mmap = None

    @classmethod
    def from_codes(cls, flat_codes: np.ndarray) -> "PackedPool":
        from ..graph.counter import pack_flat

        flat_codes = np.asarray(flat_codes, dtype=np.uint8)
        return cls(len(flat_codes), words=pack_flat(flat_codes))

    @property
    def in_ram(self) -> bool:
        return self._words is not None

    def window(self, lo_w: int, n_words: int) -> np.ndarray:
        """u32 word window [lo_w, lo_w + n_words) clipped to the pool."""
        hi = min(lo_w + n_words, self.n_words)
        n = max(hi - lo_w, 0)
        if self._words is not None:
            return self._words[lo_w:lo_w + n]
        return np.fromfile(self._path, dtype=np.uint32, count=n,
                           offset=self._off + 4 * lo_w)

    def window_padded(self, lo_w: int, n_words: int) -> np.ndarray:
        """window zero-padded to exactly n_words (zero tail matches the
        zero-padding every consumer used to append to the packed pool)."""
        w = self.window(lo_w, n_words)
        if len(w) < n_words:
            out = np.zeros(n_words, np.uint32)
            out[:len(w)] = w
            return out
        return w

    def bases_at(self, pos: np.ndarray) -> np.ndarray:
        """Base codes at sparse positions (disk mode via memmap: pages
        touched are bounded by the touched positions)."""
        pos = np.asarray(pos, dtype=np.int64)
        if self._words is not None:
            wsrc = self._words
        else:
            if self._mmap is None:
                self._mmap = np.memmap(
                    self._path, dtype=np.uint32, mode="r",
                    offset=self._off, shape=(self.n_words,),
                )
            wsrc = self._mmap
        w = wsrc[np.minimum(pos >> 4, max(self.n_words - 1, 0))]
        sh = (30 - 2 * (pos & 15)).astype(np.uint32)
        return ((w >> sh) & 3).astype(np.uint8)

    def codes(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """Unpacked base codes of [lo, hi) (bounded by the range)."""
        if hi is None:
            hi = self.n_bases
        hi = min(hi, self.n_bases)
        if hi <= lo:
            return np.zeros(0, np.uint8)
        lo_w, hi_w = lo // 16, (hi + 15) // 16
        w = self.window(lo_w, hi_w - lo_w)
        shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(
            np.uint32)
        codes = ((w[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)
        return codes[lo - lo_w * 16: hi - lo_w * 16]


def _npz_member_data_offset(path: str, member: str):
    """Byte offset of an uncompressed npz member's raw data (np.savez
    uses ZIP_STORED, so the array bytes sit verbatim in the file)."""
    import struct
    import zipfile

    from numpy.lib import format as npy_format

    with zipfile.ZipFile(path) as z:
        info = z.getinfo(member + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        hdr = f.read(30)
        if hdr[:4] != b"PK\x03\x04":
            return None
        name_len = struct.unpack("<H", hdr[26:28])[0]
        extra_len = struct.unpack("<H", hdr[28:30])[0]
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = npy_format.read_magic(f)
        npy_format._check_version(version)
        shape, fortran, dtype = npy_format._read_array_header(f, version)
        if fortran or dtype != np.dtype(np.uint32):
            return None
        return f.tell()


class SequenceLib:
    """All reads, concatenated. Paired reads are interleaved (fwd, rev).

    The primary representation is the 2-bit PackedPool (0.25 B/base);
    `flat_codes` (1 B/base) is derived lazily only for legacy callers."""

    def __init__(self, flat_codes=None, starts=None, lib_ranges=None,
                 pool: PackedPool | None = None):
        self._flat = flat_codes
        self._pool = pool
        self.starts = starts if starts is not None \
            else np.zeros(1, np.int64)
        self.lib_ranges = list(lib_ranges) if lib_ranges else []

    @property
    def flat_codes(self) -> np.ndarray:
        if self._flat is None:
            self._flat = self._pool.codes(0, self.num_bases)
        return self._flat

    @property
    def pool(self) -> PackedPool:
        if self._pool is None:
            self._pool = PackedPool.from_codes(self._flat)
        return self._pool

    @property
    def num_seqs(self) -> int:
        return len(self.starts) - 1

    @property
    def num_bases(self) -> int:
        return int(self.starts[-1])

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.num_seqs else 0

    def seq(self, i: int) -> np.ndarray:
        lo, hi = int(self.starts[i]), int(self.starts[i + 1])
        if self._flat is not None:
            return self._flat[lo:hi]
        return self._pool.codes(lo, hi)

    def save(self, path: str) -> None:
        """2-bit packed on disk (the reference's .bin is 2-bit packed
        too, sequence_package.h:224-240); uncompressed npz - zlib on
        100M+ bases costs a minute for little gain over 2-bit."""
        pool = self.pool
        packed = pool.window_padded(0, pool.n_words)
        np.savez(
            path,
            packed=packed,
            n_bases=np.int64(self.num_bases),
            starts=self.starts,
            lib_ranges=np.array(
                [(b, e, int(p)) for b, e, p in self.lib_ranges], dtype=np.int64
            ).reshape(-1, 3),
        )

    @classmethod
    def load(cls, path: str, mode: str = "ram") -> "SequenceLib":
        """mode="ram": packed words resident (0.25 B/base).
        mode="window": the pool stays ON DISK; every scan reads
        bounded windows straight out of the (uncompressed) npz."""
        z = np.load(path)
        ranges = [
            (int(b), int(e), bool(p)) for b, e, p in z["lib_ranges"]
        ]
        if "flat_codes" in z:  # legacy uncompressed-codes format
            return cls(z["flat_codes"], z["starts"], ranges)
        n = int(z["n_bases"])
        starts = z["starts"]
        if mode == "window":
            off = _npz_member_data_offset(path, "packed")
            if off is not None:
                pool = PackedPool(n, path=path, byte_offset=off)
                return cls(None, starts, ranges, pool=pool)
        pool = PackedPool(n, words=z["packed"].astype(np.uint32))
        return cls(None, starts, ranges, pool=pool)


def _interleave_flat(f1, s1, f2, s2):
    """Interleave two sequence pools pairwise (r1_0, r2_0, r1_1, ...)
    with vectorized index arithmetic - no per-read Python loop."""
    if len(s1) != len(s2):
        # reference driver errors on mismatched -1/-2 read counts
        # (truncated/corrupt pair files must surface, not be masked)
        raise ValueError(
            "paired files have different read counts: "
            f"{len(s1) - 1} vs {len(s2) - 1}"
        )
    n = min(len(s1), len(s2)) - 1
    l1 = np.diff(s1[: n + 1])
    l2 = np.diff(s2[: n + 1])
    lens = np.empty(2 * n, dtype=np.int64)
    lens[0::2] = l1
    lens[1::2] = l2
    starts = np.zeros(2 * n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    flat = np.empty(starts[-1], dtype=np.uint8)

    if n and (l1 == l1[0]).all() and (l2 == l2[0]).all():
        # uniform read lengths (the overwhelmingly common case):
        # interleave is a reshape view copy, no index arrays at all
        a, b = int(l1[0]), int(l2[0])
        out2 = flat.reshape(n, a + b)
        out2[:, :a] = f1[: n * a].reshape(n, a)
        out2[:, a:] = f2[: n * b].reshape(n, b)
        return flat, starts

    def place(src, src_starts, src_lens, tgt_starts,
              chunk: int = 1 << 21):
        # chunked scatter: the int64 dest index array is bounded by
        # the chunk's bases, not the whole pool (an all-at-once dest
        # cost ~8 B/base transiently - 40+ GB at 5 Gbp)
        pos = 0
        for lo in range(0, len(src_lens), chunk):
            hi = min(len(src_lens), lo + chunk)
            total = int(src_lens[lo:hi].sum())
            if total == 0:
                continue
            dest = (np.repeat(tgt_starts[lo:hi] - src_starts[lo:hi],
                              src_lens[lo:hi])
                    + np.arange(total, dtype=np.int64))
            flat[dest] = src[pos:pos + total]
            pos += total

    place(f1, s1[: n + 1], l1, starts[0:-1:2])
    place(f2, s2[: n + 1], l2, starts[1::2])
    return flat, starts


def build_lib(
    pe1: list[str],
    pe2: list[str],
    pe12: list[str],
    se: list[str],
) -> SequenceLib:
    """Read all libraries into one SequenceLib.

    Order matches the reference driver's lib file generation
    (src/megahit:667-697): pe12 first, then pe1/pe2 pairs, then se.
    All paths stay in flat pool form (native parser + vectorized
    interleave; no per-read Python objects).
    """
    from .async_reader import AsyncFastxReader

    pools: list[tuple[np.ndarray, np.ndarray]] = []
    ranges: list[tuple[int, int, bool]] = []
    n_seqs = 0

    def push(flat, starts, paired):
        nonlocal n_seqs
        cnt = len(starts) - 1
        pools.append((flat, starts))
        ranges.append((n_seqs, n_seqs + cnt, paired))
        n_seqs += cnt

    # one ordered stream with one file of read-ahead (the reference's
    # AsyncSequenceReader double buffering, async_sequence_reader.h)
    order = list(pe12)
    for p1, p2 in zip(pe1, pe2):
        order += [p1, p2]
    order += list(se)
    it = iter(AsyncFastxReader(order))

    for _ in pe12:
        _, flat, starts = next(it)
        push(flat, starts, True)
    for _ in zip(pe1, pe2):
        _, f1, s1 = next(it)
        _, f2, s2 = next(it)
        push(*_interleave_flat(f1, s1, f2, s2), True)
    for _ in se:
        _, flat, starts = next(it)
        push(flat, starts, False)

    if not pools:
        return SequenceLib(np.zeros(0, np.uint8), np.zeros(1, np.int64), [])
    total_bases = sum(len(p[0]) for p in pools)
    flat = np.empty(total_bases, dtype=np.uint8)
    starts = np.zeros(n_seqs + 1, dtype=np.int64)
    off_seq = 0
    off_base = 0
    for i in range(len(pools)):
        f, s = pools[i]
        cnt = len(s) - 1
        flat[off_base:off_base + len(f)] = f
        pools[i] = None  # free each source as it lands (peak ~1x pool)
        starts[off_seq + 1 : off_seq + cnt + 1] = s[1:] + off_base
        off_seq += cnt
        off_base += len(f)
    return SequenceLib(flat, starts, ranges)
