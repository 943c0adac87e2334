"""Plain NumPy reference of an assembly's first graph, and the share of
each genome that its contigs hold.

MEGAHIT's first graph at k_min is the set of canonical (k_min + 1)-mers
("edges") of the reads, each with its count of occurrences on either
strand, kept where the count is at least ``min_count``, plus the mercy
edges (multiplicity 1) where mercy is on (upstream
``src/sdbg/seq_to_sdbg.cpp`` GenMercyEdges): in every read of at least
k + 2 bases, node i is the k-mer at offset i; it has an in-edge if a
solid edge on either strand ends with it and an out-edge if one starts
with it. A node with an in-edge only at offset a, followed (with only
nodes with neither in between) by a node with an out-edge only at
offset b, makes the read's edges at offsets a .. b - 1 mercy edges.

Keys are integers with the first base in the most significant bits
(A, C, G, T = 0, 1, 2, 3), so integer order is the bases' lexicographic
order and the canonical key is the smaller of a key and its reverse
complement. Edges of up to 32 bases fit a uint64. Every read of a
sample has the same length.

This file imports NumPy only.
"""

from __future__ import annotations

import numpy as np

LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    LUT[_c] = _i


def codes(ascii_rows: np.ndarray) -> np.ndarray:
    """(n, L) ASCII bases -> (n, L) codes 0..3 (ACGT only)."""
    c = LUT[ascii_rows]
    if (c == 255).any():
        raise ValueError("reads hold a base other than A, C, G, T")
    return c


def _check_k(k: int) -> None:
    if not 1 <= k <= 32:
        raise ValueError(f"the reference holds k-mers of 1 to 32 bases, "
                         f"not {k}")


def kmers(c: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement keys of every k-mer of each row of
    codes (n, L): two (n, L - k + 1) uint64 arrays. Built by doubling:
    the m-mers at offsets i and i + m make the 2m-mer at i."""
    _check_k(k)
    c = np.atleast_2d(c)
    n = c.shape[1] - k + 1
    if n <= 0:
        z = np.zeros((c.shape[0], 0), np.uint64)
        return z, z.copy()
    fwd = np.zeros((c.shape[0], n), np.uint64)
    rev = np.zeros((c.shape[0], n), np.uint64)
    f_m = c.astype(np.uint64)  # m-mers, m = 1, 2, 4, ...
    r_m = np.uint64(3) - f_m
    m, done = 1, 0  # bases of fwd/rev built so far
    while True:
        if k & m:
            # append the m-mer at offset `done` to the keys
            f_part = f_m[:, done:done + n]
            r_part = r_m[:, done:done + n]
            fwd = (fwd << np.uint64(2 * m)) | f_part
            rev |= r_part << np.uint64(2 * done)
            done += m
        if 2 * m > k:
            break
        span = f_m.shape[1] - m
        f_m = (f_m[:, :span] << np.uint64(2 * m)) | f_m[:, m:m + span]
        r_m = r_m[:, :span] | (r_m[:, m:m + span] << np.uint64(2 * m))
        m *= 2
    return fwd, rev


def canonical(c: np.ndarray, k: int) -> np.ndarray:
    fwd, rev = kmers(c, k)
    return np.minimum(fwd, rev)


def revcomp(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of uint64 keys of k bases."""
    _check_k(k)
    keys = np.asarray(keys, dtype=np.uint64)
    out = np.zeros_like(keys)
    for j in range(k):
        base = (keys >> np.uint64(2 * j)) & np.uint64(3)
        out |= (np.uint64(3) - base) << np.uint64(2 * (k - 1 - j))
    return out


def _node_flags(solid: np.ndarray, k1: int):
    """Sorted distinct k-mers (k = k1 - 1) that begin or end a solid
    edge on either strand, each with bit 1 set if an edge begins with
    it (the node has an out-edge) and bit 0 if one ends with it (an
    in-edge)."""
    k = k1 - 1
    both = np.concatenate([solid, revcomp(solid, k1)])
    begins = np.unique(both >> np.uint64(2))
    ends = np.unique(both & np.uint64((1 << (2 * k)) - 1))
    table = np.union1d(begins, ends)
    flags = np.zeros(len(table), np.int8)
    flags[np.searchsorted(table, begins)] |= 2
    flags[np.searchsorted(table, ends)] |= 1
    return table, flags


def mercy_edges(fwd: np.ndarray, canon: np.ndarray, solid: np.ndarray,
                k1: int) -> np.ndarray:
    """Sorted distinct canonical mercy edges over the solid canonical
    k1-mers. fwd, canon: the forward and canonical keys of every edge
    offset of each read, (n, L - k1 + 1); only reads holding an edge
    that is not solid can hold a gap, so pass those."""
    k = k1 - 1
    n_reads, n_edges = fwd.shape
    if n_edges < 2 or len(solid) == 0 or n_reads == 0:
        # reads of fewer than k + 2 bases hold no gap
        return np.zeros(0, np.uint64)
    # node i is the first k bases of edge i, and the last node the last
    # k bases of the last edge
    node = np.empty((n_reads, n_edges + 1), np.uint64)
    node[:, :n_edges] = fwd >> np.uint64(2)
    node[:, n_edges] = fwd[:, -1] & np.uint64((1 << (2 * k)) - 1)
    table, flags = _node_flags(solid, k1)
    i = np.minimum(np.searchsorted(table, node), len(table) - 1)
    status = np.where(table[i] == node, flags[i], 0)  # 1 in, 2 out, 3
    del node, i
    pos = np.broadcast_to(np.arange(n_edges + 1), status.shape)
    # latest in-only node, and latest node with an out-edge, at or
    # before each offset
    last_in = np.maximum.accumulate(np.where(status == 1, pos, -1), axis=1)
    last_stop = np.maximum.accumulate(np.where(status >= 2, pos, -1),
                                      axis=1)
    rows, b = np.nonzero(status[:, 1:] == 2)
    b = b + 1
    a = last_in[rows, b - 1]
    live = (a >= 0) & (a > last_stop[rows, b - 1])
    rows, a, b = rows[live], a[live], b[live]
    # mark edge offsets a .. b - 1 of each live gap (gaps are disjoint)
    mark = np.zeros((n_reads, n_edges + 1), np.int8)
    mark[rows, a] += 1
    mark[rows, b] -= 1
    inside = np.cumsum(mark, axis=1, dtype=np.int8)[:, :n_edges] > 0
    return np.unique(canon[inside])


def first_graph(reads: np.ndarray, k1: int, min_count: int, mercy: bool
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The first graph of the reads (n, L codes): its canonical edges
    (sorted uint64) and their multiplicities (counts capped at 65535,
    mercy edges 1), and every distinct canonical k1-mer of the reads."""
    fwd, rev = kmers(reads, k1)
    canon = np.minimum(fwd, rev)
    del rev
    every, where, counts = np.unique(canon, return_inverse=True,
                                     return_counts=True)
    keep = counts >= min_count
    keys, mult = every[keep], np.minimum(counts[keep], 65535)
    if mercy and min_count > 1:
        rows = ~keep[where.reshape(canon.shape)].all(axis=1)
        extra = mercy_edges(fwd[rows], canon[rows], keys, k1)
        keys = np.concatenate([keys, extra])
        mult = np.concatenate([mult, np.ones(len(extra), np.int64)])
        order = np.argsort(keys, kind="stable")
        keys, mult = keys[order], mult[order]
    return keys, mult.astype(np.int64), every


def edges_differ(keys_a, counts_a, keys_b, counts_b) -> int:
    """Edges in one graph and not the other, plus shared edges whose
    multiplicities differ."""
    ka, ia = np.unique(np.asarray(keys_a, np.uint64), return_index=True)
    kb, ib = np.unique(np.asarray(keys_b, np.uint64), return_index=True)
    # a key listed twice in one graph is a difference too
    dup = (len(keys_a) - len(ka)) + (len(keys_b) - len(kb))
    both, xa, xb = np.intersect1d(ka, kb, assume_unique=True,
                                  return_indices=True)
    ca = np.asarray(counts_a)[ia][xa]
    cb = np.asarray(counts_b)[ib][xb]
    only = (len(ka) - len(both)) + (len(kb) - len(both))
    return int(dup + only + np.count_nonzero(ca != cb))


def genome_recall(genome_codes: list[np.ndarray], contig_codes:
                  list[np.ndarray], k: int = 32) -> list[float]:
    """Per genome, the share of its distinct canonical k-mers that some
    contig holds."""
    parts = [canonical(c[None, :], k)[0] for c in contig_codes
             if len(c) >= k]
    have = np.unique(np.concatenate(parts)) if parts else \
        np.zeros(0, np.uint64)
    out = []
    for g in genome_codes:
        km = np.unique(canonical(g[None, :], k)[0])
        out.append(float(np.isin(km, have).mean()) if len(km) else 1.0)
    return out
