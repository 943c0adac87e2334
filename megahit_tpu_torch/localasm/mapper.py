"""Sparse seed read-to-contig mapper.

Reference: HashMapper (src/localasm/hash_mapper.{h,cpp}) - every
`sparsity`-th canonical 31-mer of each contig seeds a hash index; a
read maps by sliding all its seed k-mers, turning hits into clipped
diagonal alignment candidates, scoring each by exact base matches, and
keeping a unique best with >= similarity * length matches.

Here the index is a sorted multi-word key array built on the device;
the reads are scanned by the native rolling-window seed scan
(native/seedscan.cpp); candidates are deduplicated on the host; and the
candidates' exact-match scores are one device pass over packed words
(xor, 2-bit popcount, masked tail).

Counterpart of megahit_tpu/localasm/mapper.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import kmerops, packing
from ..graph.counter import pack_flat
from ..utils.device import resolve_device
from ..utils.log import get_logger

SEED_K = 31


@dataclass
class SeedIndex:
    keys: np.ndarray  # (S, W) sorted canonical seed k-mers (unique)
    contig_id: np.ndarray  # (S,)
    offset: np.ndarray  # (S,) seed start offset in contig (fwd coords)
    strand: np.ndarray  # (S,) 1 if canonical form is the contig's rc
    contigs: list[np.ndarray]  # contig base codes
    contig_lens: np.ndarray

    @property
    def size(self) -> int:
        return len(self.keys)


def build_seed_index(
    contigs: list[np.ndarray], sparsity: int = 8, seed_k: int = SEED_K,
    device="cuda",
) -> SeedIndex:
    """Index every sparsity-th canonical seed k-mer (extracted and
    canonicalized on `device`); k-mers seen at more than one (contig,
    offset) are repeats and dropped (reference marks them with the top
    bit and ignores hits, hash_mapper.cpp:84-99)."""
    device = resolve_device(device)
    w = kmerops.words_per_kmer(seed_k)
    lens = np.array([len(c) for c in contigs], dtype=np.int64)
    pos_parts, cid_parts, off_parts = [], [], []
    base = 0
    for cid, codes in enumerate(contigs):
        L = len(codes)
        if L >= seed_k:
            offs = np.arange(0, L - seed_k + 1, sparsity, dtype=np.int64)
            off_parts.append(offs)
            pos_parts.append(base + offs)
            cid_parts.append(np.full(len(offs), cid, np.int32))
        base += L
    if not pos_parts:
        return SeedIndex(np.zeros((0, w), np.uint32), np.zeros(0, np.int32),
                         np.zeros(0, np.int64), np.zeros(0, np.int8),
                         contigs, lens)
    flat, _ = packing.pack_many(contigs)
    n = sum(map(len, pos_parts))
    packed = np.concatenate([pack_flat(flat), np.zeros(w + 1, np.uint32)])
    pos = torch.from_numpy(np.concatenate(pos_parts)).to(device)
    keys = kmerops.extract_kmers(kmerops.to_torch(packed, device), pos,
                                 seed_k)
    canon, is_rc = kmerops.canonical_kmers(keys, seed_k)
    canon, is_rc = kmerops.to_numpy(canon), is_rc.cpu().numpy()

    cids = np.concatenate(cid_parts)
    offs = np.concatenate(off_parts)
    order = np.lexsort(tuple(canon[:, i] for i in range(w - 1, -1, -1)))
    canon, is_rc, cids, offs = (
        canon[order], is_rc[order], cids[order], offs[order]
    )
    head = np.ones(n, dtype=bool)
    head[1:] = (canon[1:] != canon[:-1]).any(axis=1)
    # group sizes; keep only singleton seed k-mers
    gid = np.cumsum(head) - 1
    sizes = np.bincount(gid)
    keep = head & (sizes[gid] == 1)
    return SeedIndex(
        canon[keep], cids[keep], offs[keep],
        is_rc[keep].astype(np.int8), contigs, lens,
    )


@dataclass
class MapResult:
    """Per-read best alignment (invalid rows have contig_id == -1)."""

    contig_id: np.ndarray
    contig_from: np.ndarray
    contig_to: np.ndarray
    query_from: np.ndarray
    query_to: np.ndarray
    strand: np.ndarray
    mismatch: np.ndarray

    @property
    def valid(self) -> np.ndarray:
        return self.contig_id >= 0


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 value in [0, 2^32) (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _score_spans(qpacked, cpacked, qpos, cpos, span, kmax: int):
    """Exact-match count over aligned spans, on 2-bit packed words (int64
    tensors on one device).

    Replaces the reference's byte-wise Match loop (hash_mapper.cpp:
    103-133) with a word-level xor + 2-bit popcount: per candidate,
    ~kmax/16 word ops instead of kmax byte compares. span masks the tail
    (left-aligned big-endian 2-bit layout, 16 bases a word)."""
    qw = kmerops.extract_kmers(qpacked, qpos, kmax)  # (N, W)
    cw = kmerops.extract_kmers(cpacked, cpos, kmax)
    x = qw ^ cw
    diff = (x | (x >> 1)) & 0x55555555
    w = qw.shape[1]
    j16 = torch.arange(w, dtype=torch.int64, device=qw.device) * 16
    b = torch.clamp(span[:, None] - j16[None, :], 0, 16)  # bases in word
    mask = torch.where(b == 0, 0, (kmerops.M32 << (32 - 2 * b))
                       & kmerops.M32)
    return span - _popcount32(diff & mask).sum(dim=1)


def map_reads(
    flat_codes,
    starts: np.ndarray,
    index: SeedIndex,
    similarity: float = 0.8,
    min_mapped_len: int = 75,
    seed_k: int = SEED_K,
    device="cuda",
) -> MapResult:
    """Map every read; returns its unique best alignment or invalid.

    Matches TryMap (hash_mapper.cpp:136-268): candidates from seed
    hits, clipped to the contig, length-filtered, scored by exact
    matches (on `device`) with threshold similarity * aligned_len, ties
    invalidate. Raises if the native scan library cannot be built.
    """
    device = resolve_device(device)
    log = get_logger()
    n_reads = len(starts) - 1
    out = MapResult(*(np.full(n_reads, -1, dtype=np.int64)
                      for _ in range(7)))
    n_bases = int(starts[-1])
    if index.size == 0 or n_reads == 0 or n_bases < seed_k:
        return out
    from ..graph.counter import as_pool
    from ..native import SCAN_CANON, argsort_rows, seed_scan

    w = kmerops.words_per_kmer(seed_k)
    pool = as_pool(flat_codes)
    packed_np = np.concatenate(
        [pool.window_padded(0, pool.n_words),
         np.zeros(w + 1, np.uint32)])

    # native rolling-window scan: canonical probe + binary search per
    # position, threaded over read ranges; reads shorter than
    # max(seed_k, 50) are unreliable and skipped (reference TryMap,
    # hash_mapper.cpp:140)
    sel, rid, h, _, qrc_h = seed_scan(
        packed_np, starts, seed_k, index.keys, SCAN_CANON,
        min_read_len=max(seed_k, 50))
    lengths = np.diff(starts)
    if len(sel) == 0:
        return out
    # candidate identity is (read, contig, strand, diagonal): the
    # clipped alignment fields are all functions of those four plus the
    # read/contig lengths. Deduplicate on that 4-tuple before any
    # coordinate math; hits arrive position-sorted (grouped by read).
    rid = rid.astype(np.int32, copy=False)
    rlen32 = lengths.astype(np.int32)
    i = (sel - starts[rid]).astype(np.int32) + np.int32(seed_k - 1)
    mstrand = (index.strand[h].astype(np.uint8)
               ^ qrc_h.astype(np.uint8)).astype(np.int8)
    coff = index.offset[h].astype(np.int32)
    cid = index.contig_id[h]
    rl = rlen32[rid]
    diag = np.where(mstrand == 0, coff - i + np.int32(seed_k - 1),
                    coff - rl + np.int32(1) + i)
    # pass 1: drop consecutive repeats of the same candidate
    nn = len(rid)
    first = np.ones(nn, dtype=bool)
    first[1:] = ((rid[1:] != rid[:-1]) | (cid[1:] != cid[:-1])
                 | (mstrand[1:] != mstrand[:-1]) | (diag[1:] != diag[:-1]))
    rid, cid, mstrand, diag = (
        x[first] for x in (rid, cid, mstrand, diag)
    )
    # pass 2: full dedup via 2 packed u64 sort keys; equal keys are
    # dropped as duplicates, so an unstable order is fine
    ka = (rid.astype(np.uint64) << np.uint64(1)) \
        | (mstrand & 1).astype(np.uint64)
    kb = (cid.astype(np.uint64) << np.uint64(32)) \
        | (diag.astype(np.int64) + (1 << 31)).astype(np.uint64)
    if ka.max(initial=0) < (1 << 32):
        # native parallel MSD row sort: lead with a multiplicative hash
        # of the key to give the MSD pass a uniform top byte; words 1-3
        # carry the full key, so equal rows <=> equal candidates
        ka32 = (ka & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        kbh = (kb >> np.uint64(32)).astype(np.uint32)
        kbl = (kb & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        rows4 = np.empty((len(ka), 4), np.uint32)
        rows4[:, 0] = (ka32 * np.uint32(2654435761)) ^ (
            kbl * np.uint32(0x9E3779B9))
        rows4[:, 1] = ka32
        rows4[:, 2] = kbh
        rows4[:, 3] = kbl
        order = argsort_rows(rows4)
    else:
        order = np.lexsort((kb, ka))
    kas, kbs = ka[order], kb[order]
    keep = np.ones(len(order), dtype=bool)
    keep[1:] = (kas[1:] != kas[:-1]) | (kbs[1:] != kbs[:-1])
    sel_rows = order[keep]
    rid, cid, mstrand, diag = (
        x[sel_rows] for x in (rid, cid, mstrand, diag)
    )

    # clipped alignment fields (reference TryMap candidate clipping,
    # hash_mapper.cpp:174-214), over the deduplicated set only
    rl = rlen32[rid]
    clen = index.contig_lens[cid].astype(np.int32)
    cfrom = np.maximum(diag, 0)
    cto = np.minimum(clen - np.int32(1), diag + rl - np.int32(1))
    alen = cto - cfrom + np.int32(1)
    ok = (alen >= rl) | (alen >= min_mapped_len)
    rid, cid, mstrand, diag, cfrom, cto, rl = (
        x[ok] for x in (rid, cid, mstrand, diag, cfrom, cto, rl)
    )
    qfrom = np.where(mstrand == 0, cfrom - diag,
                     rl - np.int32(1) - (cto - diag))
    qto = np.where(mstrand == 0, cto - diag,
                   rl - np.int32(1) - (cfrom - diag))
    n_cand = len(rid)
    if n_cand == 0:
        return out

    # score on the device. Minus-strand spans read forward from an
    # rc-packed contig pool (contig[cfrom..cto] reverse-complemented
    # starts at rc-coordinate clen-1-cto).
    span_len = qto - qfrom + 1
    kmax = int(lengths.max())
    wk = kmerops.words_per_kmer(kmax)
    contig_flat, contig_starts = packing.pack_many(index.contigs)
    rc_flat, rc_starts = packing.pack_many(
        [packing.revcomp_codes(c) for c in index.contigs]
    )
    cpacked = np.concatenate(
        [pack_flat(contig_flat), pack_flat(rc_flat),
         np.zeros(wk + 1, np.uint32)]
    )
    rc_word_base = (len(contig_flat) + 15) // 16 * 16  # rc pool offset
    clen_c = index.contig_lens[cid]
    cpos_g = np.where(
        mstrand == 0,
        contig_starts[cid] + cfrom,
        rc_word_base + rc_starts[cid] + (clen_c - 1 - cto),
    )
    qpos_g = starts[rid] + qfrom
    qpacked = np.concatenate([packed_np, np.zeros(wk + 1, np.uint32)])

    def dev(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)

    matches = _score_spans(
        kmerops.to_torch(qpacked, device), kmerops.to_torch(cpacked, device),
        dev(qpos_g), dev(cpos_g), dev(span_len), kmax,
    ).cpu().numpy()
    threshold = np.round(similarity * span_len).astype(np.int64)
    matches = np.where(matches >= threshold, matches, 0)

    # unique best per read: sort by (read, -matches); ties invalidate
    order = np.lexsort((-matches, rid))
    rid_s = rid[order]
    m_s = matches[order]
    first = np.ones(n_cand, dtype=bool)
    first[1:] = rid_s[1:] != rid_s[:-1]
    best_rows = np.flatnonzero(first)
    nxt = best_rows + 1
    tie = (nxt < n_cand) & (rid_s[np.minimum(nxt, n_cand - 1)] ==
                            rid_s[best_rows]) & \
          (m_s[np.minimum(nxt, n_cand - 1)] == m_s[best_rows])
    good = best_rows[(m_s[best_rows] > 0) & ~tie]
    sel_rows = order[good]

    r = rid[sel_rows]
    out.contig_id[r] = cid[sel_rows]
    out.contig_from[r] = cfrom[sel_rows]
    out.contig_to[r] = cto[sel_rows]
    out.query_from[r] = qfrom[sel_rows]
    out.query_to[r] = qto[sel_rows]
    out.strand[r] = mstrand[sel_rows]
    out.mismatch[r] = (qto - qfrom + 1)[sel_rows] - matches[sel_rows]
    log.info(
        "mapper: %d/%d reads aligned (%d seeds indexed)",
        len(sel_rows), n_reads, index.size,
    )
    return out
