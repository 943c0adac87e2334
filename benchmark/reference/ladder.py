"""Plain NumPy reference of the rungs of a k ladder past k_min.

MEGAHIT assembles at k_min, then climbs its k list rung by rung
(upstream ``src/megahit``: local assembly, iterate, build_graph and
assemble for each next k). Each rung past k_min is fed by the rung
before it, and given the previous rung's contig files this reference
works out what the rung must be:

- ``iterate_edges``: the rung's edge file. MEGAHIT's iterate (upstream
  ``src/iterate/contig_flank_index.h``) takes the first (k+1)-mer of
  each strand of the previous rung's contigs and bubbles ("flanks",
  loop and standalone contigs left out), each with up to step - 1 of
  the bases that follow it ("extension"). Of flanks that are equal it
  keeps the longest extension, and of those the one whose bases, read
  as a number with base j at bits 2j, are largest; palindromic flanks
  are left out. It scans each read from left to right: a position
  whose (k+1)-mer is a flank is marked, with the positions after it
  whose bases go on to match its extension; a position whose
  (k+1)-mer's reverse complement is a flank is marked, with the
  positions before it that match the extension on the other strand.
  The positions covered by a forward extension are not looked up
  again. Every run of step + 1 marked positions gives the read's
  (k + step + 1)-mer over it, canonical, at multiplicity 0.
- ``rung_graph``: the rung's graph (upstream seq_to_sdbg.cpp
  Initialize): every (k+1)-window of the previous rung's contigs,
  bubbles, additional and local contigs of at least k + 1 bases, loop
  contigs run on around their cycle by the k_from .. k bases that a
  window across the join needs, each window at its contig's multi
  rounded (floor(multi + 0.5)), and the edge file's keys at their
  counts, on both strands, each edge at its largest multiplicity,
  capped at 65535.

Keys are rows of uint64 words, 32 bases a word, the first base in the
most significant bits of the first word and the last word padded with
zeros (A, C, G, T = 0, 1, 2, 3), so the order of rows, word by word, is
the bases' order, and any length fits. Rows are compared whole: a
64-bit hash of each row only finds where to look.

This file imports NumPy and reference/first_graph.py only.
"""

from __future__ import annotations

import numpy as np

from reference.first_graph import kmers

WORD = 32  # bases a uint64 word holds
MAX_MUL = 65535  # the largest multiplicity a graph keeps
STANDALONE, LOOP = 1, 2  # contig flags
_U = np.uint64


def n_words(k1: int) -> int:
    return -(-k1 // WORD)


def pack(codes: np.ndarray) -> np.ndarray:
    """(n, k1) codes -> (n, W) rows."""
    codes = np.atleast_2d(codes)
    n, k1 = codes.shape
    rows = np.zeros((n, n_words(k1)), _U)
    for i in range(k1):
        rows[:, i // WORD] |= codes[:, i].astype(_U) << _U(
            2 * (WORD - 1 - i % WORD))
    return rows


def unpack(rows: np.ndarray, k1: int) -> np.ndarray:
    """(n, W) rows -> (n, k1) codes."""
    i = np.arange(k1)
    return ((rows[:, i // WORD] >> (2 * (WORD - 1 - i % WORD)).astype(_U))
            & _U(3)).astype(np.uint8)


def revcomp_rows(rows: np.ndarray, k1: int) -> np.ndarray:
    return pack(3 - unpack(rows, k1)[:, ::-1])


def less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Whether each row of a comes before the same row of b."""
    if a.shape[1] == 0:
        return np.zeros(len(a), bool)
    diff = a != b
    j = diff.argmax(axis=1)
    i = np.arange(len(a))
    return diff[i, j] & (a[i, j] < b[i, j])


def canonical(fwd: np.ndarray, rc: np.ndarray) -> np.ndarray:
    return np.where(less(rc, fwd)[:, None], rc, fwd)


def window_rows(c: np.ndarray, k1: int, pos: np.ndarray):
    """Forward and reverse-complement rows of the k1-windows of a
    sequence of codes c starting at `pos`.
    Built from the m-mers of first_graph.kmers: word j of a window at
    p is the 32-mer at p + 32 j, and of its reverse complement the
    reverse complement of the 32-mer that ends 32 j bases before the
    window's end."""
    flat = np.asarray(c, np.uint8)
    pos = np.asarray(pos, np.int64)
    w = n_words(k1)
    fwd = np.zeros((len(pos), w), _U)
    rc = np.zeros((len(pos), w), _U)
    if len(pos) == 0:
        return fwd, rc
    r = k1 - WORD * (w - 1)  # bases of the last word
    if w > 1:
        f32, r32 = kmers(flat[None, :], WORD)
        for j in range(w - 1):
            fwd[:, j] = f32[0, pos + WORD * j]
            rc[:, j] = r32[0, pos + k1 - WORD * (j + 1)]
    f_r, r_r = kmers(flat[None, :], r)
    shift = _U(2 * (WORD - r))
    fwd[:, w - 1] = f_r[0, pos + WORD * (w - 1)] << shift
    rc[:, w - 1] = r_r[0, pos] << shift
    return fwd, rc


def _hash(rows: np.ndarray) -> np.ndarray:
    h = np.zeros(len(rows), _U)
    for j in range(rows.shape[1]):
        h = (h ^ rows[:, j]) * _U(0x9E3779B97F4A7C15)
        h ^= h >> _U(29)
    return h


def group(rows: np.ndarray):
    """(order, head): an order of the rows in which equal rows are
    next to each other, and whether each row in that order is the
    first of its group. Rows are ordered by their hash; where two
    different rows share one, the rows of those hashes are put in
    whole-row order."""
    h = _hash(rows)
    order = np.argsort(h, kind="stable")
    hs, rs = h[order], rows[order]
    same_h = hs[1:] == hs[:-1]
    same = same_h & (rs[1:] == rs[:-1]).all(axis=1)
    if (same_h & ~same).any():
        shared = np.isin(hs, hs[1:][same_h & ~same])
        sub = np.flatnonzero(shared)
        inner = np.lexsort(tuple(rs[sub].T[::-1]) + (hs[sub],))
        order[sub] = order[sub][inner]
        hs, rs = h[order], rows[order]
        same = (hs[1:] == hs[:-1]) & (rs[1:] == rs[:-1]).all(axis=1)
    return order, np.concatenate([[True], ~same])


def unique_max(rows: np.ndarray, vals: np.ndarray):
    """The distinct rows and the largest value of each."""
    if len(rows) == 0:
        return rows, np.zeros(0, np.int64)
    order, head = group(rows)
    starts = np.flatnonzero(head)
    return rows[order][starts], np.maximum.reduceat(
        np.asarray(vals, np.int64)[order], starts)


class RowSet:
    """Distinct rows, looked up by whole-row comparison."""

    def __init__(self, rows: np.ndarray):
        h = _hash(rows)
        order = np.argsort(h, kind="stable")
        self.rows, self.h, self.order = rows[order], h[order], order

    def find(self, q: np.ndarray) -> np.ndarray:
        """Index (into the rows as given) of each query row, -1 where
        it is not one of them."""
        out = np.full(len(q), -1, np.int64)
        n = len(self.rows)
        if n == 0 or len(q) == 0:
            return out
        hq = _hash(q)
        o = np.argsort(hq)  # sorted queries search faster
        lo, hi = np.empty_like(o), np.empty_like(o)
        lo[o] = np.searchsorted(self.h, hq[o], "left")
        hi[o] = np.searchsorted(self.h, hq[o], "right")
        for d in range(int((hi - lo).max())):
            i = np.minimum(lo + d, n - 1)
            hit = (lo + d < hi) & (self.rows[i] == q).all(axis=1) & (out < 0)
            out[hit] = self.order[i[hit]]
        return out


def edges_differ(keys_a, counts_a, keys_b, counts_b) -> int:
    """Edges in one set and not the other, shared edges whose counts
    differ, and edges listed twice in one set."""
    ua, ca = unique_max(keys_a, counts_a)
    ub, cb = unique_max(keys_b, counts_b)
    dup = (len(keys_a) - len(ua)) + (len(keys_b) - len(ub))
    i = RowSet(ub).find(ua)
    both = i >= 0
    same = ca[both] == cb[i[both]]
    only = (len(ua) - int(both.sum())) + (len(ub) - int(both.sum()))
    return int(dup + only + np.count_nonzero(~same))


def seq_windows(seqs: list[np.ndarray], k1: int):
    """Canonical rows of every k1-window of each sequence, and the
    sequence each window is of."""
    seqs = [np.asarray(s, np.uint8) for s in seqs]
    lens = np.array([len(s) for s in seqs], np.int64)
    n_win = np.maximum(lens - k1 + 1, 0)
    if n_win.sum() == 0:
        return np.zeros((0, n_words(k1)), _U), np.zeros(0, np.int64)
    flat = np.concatenate(seqs)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    which = np.repeat(np.arange(len(seqs)), n_win)
    pos = starts[which] + np.arange(len(which)) - np.repeat(
        np.cumsum(n_win) - n_win, n_win)
    return canonical(*window_rows(flat, k1, pos)), which


# ---------------------------------------------------------------- iterate

def flanks(contigs, k: int, step: int):
    """The flank table of the contigs ((codes, flag) each): flank
    codes (F, k + 1), extension codes (F, step - 1; 255 past its end)
    and extension lengths (F,)."""
    k1 = k + 1
    table = {}
    for codes, flag in contigs:
        codes = np.asarray(codes, np.uint8)
        if flag & (LOOP | STANDALONE) or len(codes) < k1:
            continue
        for strand in (codes, 3 - codes[::-1]):
            flank = strand[:k1]
            if not np.array_equal(flank, 3 - flank[::-1]):
                ext = strand[k1:k1 + step - 1]
                rank = (len(ext), sum(int(b) << (2 * j)
                                      for j, b in enumerate(ext)))
                key = flank.tobytes()
                if key not in table or rank > table[key][0]:
                    table[key] = (rank, flank, ext)
            if len(codes) == k1:
                break
    f = len(table)
    fl = np.zeros((f, k1), np.uint8)
    ext = np.full((f, max(step - 1, 0)), 255, np.uint8)
    n_ext = np.zeros(f, np.int64)
    for i, (_, flank, e) in enumerate(table.values()):
        fl[i], ext[i, :len(e)], n_ext[i] = flank, e, len(e)
    return fl, ext, n_ext


PREFIX = 16  # bases of a read window that pick it as a candidate


class Reads:
    """Reads ((n, L) codes, one length) with the keys of their first
    PREFIX bases at every offset, on both strands (first_graph.kmers),
    which every rung's iterate shares."""

    def __init__(self, codes: np.ndarray):
        self.codes = np.atleast_2d(codes)
        self.fwd, self.rev = kmers(self.codes, PREFIX)

    def windows(self, rid: np.ndarray, off: np.ndarray, k1: int):
        """Forward and reverse-complement rows of the k1-windows of
        read rid at offset off."""
        c = self.codes[rid[:, None], off[:, None] + np.arange(k1)]
        return pack(c), pack(3 - c[:, ::-1])


def _lookup_prefix(prefixes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Whether each key of x is one of the prefixes: first by a bitmap
    of their hashes, then exactly."""
    u = np.unique(prefixes)
    if len(u) == 0:
        return np.zeros(x.shape, bool)
    bits = np.zeros(1 << 24, bool)
    bits[_hash(u[:, None]) >> _U(40)] = True
    hit = bits[_hash(x.reshape(-1, 1)) >> _U(40)].reshape(x.shape)
    y = x[hit]
    hit[hit] = u[np.minimum(np.searchsorted(u, y), len(u) - 1)] == y
    return hit


def iterate_edges(reads: Reads, contigs, k: int, step: int):
    """The next rung's edges, seeded from the reads by the contigs and
    bubbles of rung k ((codes, flag) each), for the rung k + step:
    canonical rows of (k + step + 1)-mers, each once, and their counts
    (all 0)."""
    k1, k2 = k + 1, k + step + 1
    if k1 < PREFIX:
        raise ValueError(f"k = {k}: MEGAHIT's k is 15 or more")
    empty = np.zeros((0, n_words(k2)), _U), np.zeros(0, np.int64)
    n, L = reads.codes.shape
    fl, ext, n_ext = flanks(contigs, k, step)
    if len(fl) == 0 or L < k2:
        return empty
    n_pos = L - k1 + 1  # (k+1)-mer offsets of a read
    # candidates by their first PREFIX bases, then each confirmed whole
    pre = kmers(fl, PREFIX)[0][:, 0]
    fwd_c = _lookup_prefix(pre, reads.fwd[:, :n_pos])
    rc_c = _lookup_prefix(pre, reads.rev[:, k1 - PREFIX:k1 - PREFIX + n_pos])
    rid, off = np.nonzero(fwd_c | rc_c)
    table = RowSet(pack(fl))
    fwd, rc = reads.windows(rid, off, k1)
    xf = np.where(fwd_c[rid, off], table.find(fwd), -1)
    xr = np.where(rc_c[rid, off], table.find(rc), -1)
    hit = (xf >= 0) | (xr >= 0)
    rid, off, xf, xr = rid[hit], off[hit], xf[hit], xr[hit]

    def matched(x, at, comp):
        """Extension bases that the read matches, base j read at
        at(j) (complemented where comp)."""
        m = np.zeros(len(x), np.int64)
        live = x >= 0
        for j in range(step - 1):
            p = at(j)
            inside = (p >= 0) & (p < L)
            b = reads.codes[rid, np.clip(p, 0, L - 1)]
            b = 3 - b if comp else b
            live &= inside & (j < n_ext[x]) & (b == ext[x, j])
            m += live
        return m

    m_f = matched(xf, lambda j: off + k1 + j, False)
    m_r = matched(xr, lambda j: off - 1 - j, True)

    # the left-to-right scan: a position inside a looked-up forward
    # hit's matched extension is not looked up
    done = np.zeros(len(rid), bool)
    last_read, skip = -1, -1
    for i, (r, p, f, m) in enumerate(zip(rid.tolist(), off.tolist(),
                                         (xf >= 0).tolist(), m_f.tolist())):
        if r != last_read:
            last_read, skip = r, -1
        if p <= skip:
            continue
        done[i] = True
        if f:
            skip = p + m

    marked = np.zeros((n, n_pos), bool)
    marked[rid[done], off[done]] = True
    for j in range(step - 1):
        sel = done & (m_f > j)
        marked[rid[sel], off[sel] + 1 + j] = True
        sel = done & (m_r > j)
        marked[rid[sel], off[sel] - 1 - j] = True
    # windows a whose positions a .. a + step are all marked
    cs = np.concatenate([np.zeros((n, 1), np.int64),
                         np.cumsum(marked, axis=1)], axis=1)
    n_win = L - k2 + 1
    full = cs[:, step + 1:step + 1 + n_win] - cs[:, :n_win] == step + 1
    wr, wa = np.nonzero(full)
    if len(wr) == 0:
        return empty
    keys, _ = unique_max(canonical(*reads.windows(wr, wa, k2)),
                         np.zeros(len(wr), np.int64))
    return keys, np.zeros(len(keys), np.int64)


# ---------------------------------------------------------------- a rung

def rung_graph(files: dict, edges, k_from: int, k: int):
    """The graph of rung k over the files of rung k_from ({name:
    [(codes, flag, multi)]}, names "contigs", "bubble_seq", "addi",
    "local") and the rung's edges ((rows, counts)): its canonical edges
    (k + 1)-mers, each once, and their multiplicities."""
    k1 = k + 1
    seqs, mults = [], []
    for name in ("contigs", "bubble_seq", "addi", "local"):
        for codes, flag, multi in files.get(name, ()):
            if len(codes) < k1:
                continue
            if name == "contigs" and flag & LOOP:
                codes = np.concatenate([codes, codes[k_from:k]])
            seqs.append(codes)
            mults.append(int(np.floor(multi + 0.5)))
    rows, which = seq_windows(seqs, k1)
    vals = np.asarray(mults, np.int64)[which]
    e_rows, e_counts = edges
    if len(e_rows):
        rows = np.concatenate(
            [rows, canonical(e_rows, revcomp_rows(e_rows, k1))])
        vals = np.concatenate([vals, np.asarray(e_counts, np.int64)])
    keys, mult = unique_max(rows, vals)
    return keys, np.minimum(mult, MAX_MUL)


def contig_edges(contigs: list[np.ndarray], graph: RowSet, k1: int):
    """The (k+1)-mers of the contigs: the contig each is of, and its
    index among the graph's edges (-1 where it is not one)."""
    rows, which = seq_windows(contigs, k1)
    return which, graph.find(rows)


def contig_depths(which: np.ndarray, idx: np.ndarray, mult: np.ndarray,
                  n: int) -> list[str | None]:
    """The mean of the graph's multiplicities over each of n contigs'
    (k+1)-mers (`contig_edges`), printed to 4 decimals; None for a
    contig with none or with one that is not an edge."""
    count = np.bincount(which, minlength=n)
    missing = np.bincount(which, weights=idx < 0, minlength=n)
    total = np.bincount(which, weights=np.asarray(mult, np.int64)[
        np.maximum(idx, 0)] * (idx >= 0), minlength=n)
    return [None if count[c] == 0 or missing[c] else
            f"{float(total[c]) / int(count[c]):.4f}" for c in range(n)]
