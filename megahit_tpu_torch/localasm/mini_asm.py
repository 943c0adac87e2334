"""Batched multi-k mini-assembly for local (gap-filling) assembly.

Exact node-centric reimplementation of the reference's embedded IDBA
subsystem (src/idba/hash_graph.cpp, contig_graph.cpp,
contig_graph_branch_group.cpp) as driven by LaunchIDBA
(src/localasm/local_assemble.cpp:28-81):

per k in mink..min(maxk, max_read_len) step 6:
  1. hash graph over the group's reads: vertices are canonical k-mers
     with per-strand 4-bit adjacency sets taken from (k+1)-base windows
     and occurrence counts (hash_graph.cpp:30-55 InsertKmers);
  2. coverage threshold = percentile(1 - local_range/num_vertices) of
     the reads-only vertex-count histogram (local_assemble.cpp:56-58);
  3. the contig end joins with counts, previous-round contigs join
     without counts (local_assemble.cpp:60-64);
  4. contract unique links into contigs, dropping cyclic and folded
     paths (hash_graph.cpp:97-126 AssembleFunc: IsLoop/LockPreempt
     failures discard the whole path);
  5. RemoveDeadEnd(2k) doubling trim, RemoveBubble branch groups,
     IterateCoverage(2k, 1, threshold, 1.1) (contig_graph.cpp:91-216);
  6. stop early when one contig remains.

Batching: instead of thousands of tiny sequential hash-graph
runs, ALL contig-end read groups share one vertex array space (rows
keyed by (group, k-mer)), so every pass -- adjacency pruning, unique-
link chain contraction by pointer doubling, trims, coverage passes --
is one vectorized sweep over the union.  Only the (rare) branch-group
bubble walks run per candidate.

Known deviations from the reference (documented, both rare):
  - overlapping bubbles are processed in our deterministic contig
    order, not IDBA's hash-table order;
  - a bubble Merge() zeroes the convergence vertex's in-bitset, which
    one-directionally drops in-edges arriving from outside the bubble;
    we keep such exterior edges.

All local k values are odd (11..41 step 6), so palindromic k-mers
cannot occur; the palindrome special cases in the reference
(contig_graph.cpp:74-80, 92-95) are unreachable and omitted.

Host numpy plus the native row sort and chain walks
(native/seedscan.cpp, native/graphwalk.cpp), which it requires; the
k-mer extraction runs as torch ops on the CPU. Counterpart of
megahit_tpu/localasm/mini_asm.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import get_logger

# popcount / single-bit-index lookup for 4-bit adjacency sets
_POP4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.int8)
_BIT4 = np.array(
    [{1: 0, 2: 1, 4: 2, 8: 3}.get(i, -1) for i in range(16)],
    dtype=np.int8,
)

_U64 = np.uint64


# IdbaKmer sizes itself for kMaxK = 255 (reference definitions.h:46
# kUint64PerIdbaKmerMaxK), so local rungs can reach min(next_k,
# max_read_len) at any ladder height
IDBA_KMAX = 255


def _ncols(k: int) -> int:
    """u64 key columns for k bases (2 bits each, LEFT-aligned)."""
    assert k <= IDBA_KMAX, k
    return (2 * k + 63) // 64


def _codes_to_cols(cm: np.ndarray, k: int) -> list[np.ndarray]:
    """Fold (N, k) 2-bit codes (big-endian) into LEFT-aligned u64
    columns whose column-major lexicographic order equals base order
    (zero-padded tails, like the kmerops word layout)."""
    n = cm.shape[0]
    cols = [np.zeros(n, _U64) for _ in range(_ncols(k))]
    for j in range(k):
        c = cm[:, j].astype(_U64)
        cols[j // 32] |= c << _U64(62 - 2 * (j % 32))
    return cols


def _words_to_cols(words: np.ndarray, k: int) -> list[np.ndarray]:
    """(N, W) left-aligned kmerops u32 words -> the same left-aligned
    u64 columns (pairs of words; zero tail padding preserved)."""
    wn = words.shape[1]

    def w(i):
        return words[:, i].astype(_U64) if i < wn else \
            np.zeros(len(words), _U64)

    return [(w(2 * j) << _U64(32)) | w(2 * j + 1)
            for j in range(_ncols(k))]


def _bisect3(t_g: np.ndarray, t_cols: list, q_g: np.ndarray,
             q_cols: list) -> np.ndarray:
    """Exact-match index of each (group, key-columns) query in the
    table sorted by (group, columns); -1 where absent. The group rides
    as its own column and the key as up to 4 u64 columns (k <= 128 =
    IdbaKmer capacity): the round-1 scheme packed everything into two
    u64s, which silently overflows for k >= 65 - precisely the rungs a
    high-k ladder's local assembly runs (kmax = next_k)."""
    if len(t_g) == 0 or len(q_g) == 0:
        return np.full(len(q_g), -1, np.int64)
    lo = np.searchsorted(t_g, q_g, "left")
    hi = np.searchsorted(t_g, q_g, "right")
    nc = len(t_cols)
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) >> 1
        safe = np.minimum(mid, len(t_g) - 1)
        # lexicographic (mid < query) over the key columns
        less = np.zeros(len(q_g), dtype=bool)
        tied = np.ones(len(q_g), dtype=bool)
        for c in range(nc):
            m = t_cols[c][safe]
            less |= tied & (m < q_cols[c])
            tied &= m == q_cols[c]
        right = active & less
        lo = np.where(right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    idx = np.minimum(lo, len(t_g) - 1)
    found = t_g[idx] == q_g
    for c in range(nc):
        found &= t_cols[c][idx] == q_cols[c]
    return np.where(found, idx, -1)


def _argsort_g_cols(gid: np.ndarray, cols: list, k: int) -> np.ndarray:
    """argsort by (gid, key columns). Equal full keys are aggregation
    groups (bits OR'd, counts summed), so an unstable sort is fine -
    the native parallel MSD row sort applies when the key packs into
    4 u32 words (k <= 48: bits fit in gid + 3 words)."""
    if k <= 48 and gid.max(initial=0) < (1 << 32):
        from ..native import argsort_rows

        c0 = cols[0]
        c1 = cols[1] if len(cols) > 1 else np.zeros(len(gid), _U64)
        rows = np.empty((len(gid), 4), np.uint32)
        rows[:, 0] = gid
        rows[:, 1] = c0 >> _U64(32)
        rows[:, 2] = c0 & _U64(0xFFFFFFFF)
        rows[:, 3] = c1 >> _U64(32)  # low 32 bits zero for k <= 48
        return argsort_rows(rows)
    return np.lexsort(tuple(reversed(cols)) + (gid,))


class _VertexTable:
    """Sorted (group, canonical k-mer) vertex rows with per-strand
    adjacency bitsets and occurrence counts (the batched HashGraph)."""

    def __init__(self, k: int, gid, vk, cnt, rcnt, out0, out1):
        self.k = k
        self.gid = gid        # (V,) int64 group id
        self.vk = vk          # (V, k) uint8 canonical codes
        self.cnt = cnt        # (V,) int64 read + contig-end occurrences
        self.rcnt = rcnt      # (V,) int64 read-only occurrences
        self.out0 = out0      # (V,) uint8 out-edge bits, canonical strand
        self.out1 = out1      # (V,) uint8 out-edge bits, rc strand
        self.alive = np.ones(len(gid), dtype=bool)
        # (group, key-columns) sort key; rows arrive sorted by it
        self.key_g = gid.astype(_U64)
        self.key_cols = _codes_to_cols(vk, k)
        self._nbr_cache = None

    @property
    def size(self) -> int:
        return len(self.gid)

    def neighbor_cache(self):
        """(nbr_g (V,2,4) int64 global target row or -1, nbr_t (V,2,4)
        int8 target strand) for every out-edge bit in the ORIGINAL
        bitsets. The key table is immutable, so this resolves each
        (vertex, strand, base) lookup ONCE per k-round instead of once
        per _contract call (~10 contracts/round); _remove_bubble only
        ever clears or re-adds original bits, never adds new ones, so
        the cache stays a superset of any later bitset state."""
        if self._nbr_cache is not None:
            return self._nbr_cache
        k = self.k
        v = self.size
        nbr_g = np.full((v, 2, 4), -1, np.int32)
        nbr_t = np.zeros((v, 2, 4), np.int8)
        fwd = self.vk
        rcm = (3 - fwd[:, ::-1]).astype(np.uint8)
        raw = np.stack([self.out0, self.out1], axis=1)
        gq = self.gid.astype(_U64)
        for s in (0, 1):
            om = fwd if s == 0 else rcm
            tail = om[:, 1:]
            for b in range(4):
                has = ((raw[:, s] >> b) & 1).astype(bool)
                if not has.any():
                    continue
                sh = np.concatenate(
                    [tail[has], np.full((has.sum(), 1), b, np.uint8)],
                    axis=1)
                f_cols = _codes_to_cols(sh, k)
                rsh = (3 - sh[:, ::-1]).astype(np.uint8)
                r_cols = _codes_to_cols(rsh, k)
                # canonical = min(fwd, rc); ties (palindrome) -> fwd
                f_less = np.zeros(len(sh), dtype=bool)
                tied = np.ones(len(sh), dtype=bool)
                for fc, rc_ in zip(f_cols, r_cols):
                    f_less |= tied & (fc < rc_)
                    tied &= fc == rc_
                is_f = f_less | tied
                q_cols = [np.where(is_f, fc, rc_)
                          for fc, rc_ in zip(f_cols, r_cols)]
                gi = _bisect3(self.key_g, self.key_cols,
                              gq[has], q_cols)
                rows = np.flatnonzero(has)
                nbr_g[rows, s, b] = gi.astype(np.int32)
                nbr_t[rows, s, b] = np.where(is_f, 0, 1)
        self._nbr_cache = (nbr_g, nbr_t)
        return self._nbr_cache


def _build_vertices(seqs: list[np.ndarray], gids: list[int],
                    kinds: list[int], k: int) -> _VertexTable | None:
    """Insert every sequence's k-windows (hash_graph.cpp:30-83
    InsertKmers / InsertUncountKmers). kind 0 = read (counted, in the
    histogram), 1 = contig end (counted), 2 = previous contig
    (uncounted)."""
    keep = [(s, g, kd) for s, g, kd in zip(seqs, gids, kinds)
            if len(s) >= k]
    if not keep:
        return None
    lens = np.array([len(s) for s, _, _ in keep], dtype=np.int64)
    flat = np.concatenate([s for s, _, _ in keep]).astype(np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)])
    g_of = np.array([g for _, g, _ in keep], dtype=np.int64)
    kd_of = np.array([kd for _, _, kd in keep], dtype=np.int8)

    nwin = lens - k + 1
    sid = np.repeat(np.arange(len(keep)), nwin)
    off = np.arange(len(sid)) - np.repeat(
        np.concatenate([[0], np.cumsum(nwin)])[:-1], nwin)
    base = starts[sid] + off
    has_prev = off > 0
    has_next = off + k < lens[sid]
    prev_b = np.where(has_prev, flat[np.maximum(base - 1, 0)], 0)
    next_b = np.where(has_next,
                      flat[np.minimum(base + k, len(flat) - 1)], 0)

    # packed-word extraction + canonicalization (O(N*W) funnel-shift
    # gathers instead of an O(N*k) byte matrix), on the host
    from ..core import kmerops
    from ..graph.counter import pack_flat

    w = kmerops.words_per_kmer(k)
    packed = np.concatenate([pack_flat(flat), np.zeros(w + 1, np.uint32)])
    keys = kmerops.extract_kmers(kmerops.to_torch(packed, "cpu"),
                                 torch.from_numpy(base), k)
    canon, is_rc = kmerops.canonical_kmers(keys, k)
    canon = kmerops.to_numpy(canon)
    is_f = ~is_rc.numpy()  # tie (palindrome) -> forward
    c_cols = _words_to_cols(canon, k)

    nb_bit = np.where(has_next, (1 << next_b).astype(np.uint8), 0)
    pb_bit = np.where(has_prev, (1 << (3 - prev_b)).astype(np.uint8), 0)
    bits0 = np.where(is_f, nb_bit, pb_bit).astype(np.uint8)
    bits1 = np.where(is_f, pb_bit, nb_bit).astype(np.uint8)

    gid_w = g_of[sid]
    kd_w = kd_of[sid]
    order = _argsort_g_cols(gid_w, c_cols, k)
    gid_w = gid_w[order]
    c_cols = [c[order] for c in c_cols]
    canon, bits0, bits1 = canon[order], bits0[order], bits1[order]
    kd_w = kd_w[order]

    head = np.ones(len(gid_w), dtype=bool)
    head[1:] = gid_w[1:] != gid_w[:-1]
    for c in c_cols:
        head[1:] |= c[1:] != c[:-1]
    hidx = np.flatnonzero(head)
    seg = np.cumsum(head) - 1
    v = len(hidx)
    out0 = np.bitwise_or.reduceat(bits0, hidx)
    out1 = np.bitwise_or.reduceat(bits1, hidx)
    cnt = np.bincount(seg, weights=(kd_w <= 1), minlength=v)
    rcnt = np.bincount(seg, weights=(kd_w == 0), minlength=v)
    # base codes only for the V distinct vertices (vectorized unpack)
    hk = canon[hidx]
    pos = np.arange(k)
    vk = ((hk[:, pos // 16] >> (30 - 2 * (pos % 16)).astype(np.uint32))
          & 3).astype(np.uint8)
    return _VertexTable(
        k, gid_w[hidx], vk,
        cnt.astype(np.int64), rcnt.astype(np.int64), out0, out1,
    )


def _thresholds(tbl: _VertexTable, local_ranges: dict[int, int],
                n_groups: int) -> np.ndarray:
    """Per-group coverage cutoff: Histgram::percentile
    (utils/histgram.h:103-114) of the reads-only vertex counts at
    p = 1 - local_range/num_vertices (local_assemble.cpp:56-58).
    percentile == sorted_counts[floor(N*p)]; p < 0 (local_range >
    num_vertices) underflows size_t in the reference and yields 0."""
    thr = np.zeros(n_groups)
    has = tbl.rcnt > 0
    gidh = tbl.gid[has]
    cnts = tbl.rcnt[has]
    order = np.lexsort((cnts, gidh))  # one sort for all groups
    gs, cs = gidh[order], cnts[order]
    if len(gs) == 0:
        return thr
    bounds = np.flatnonzero(
        np.concatenate([[True], gs[1:] != gs[:-1]]))
    ends = np.concatenate([bounds[1:], [len(gs)]])
    for s, e in zip(bounds, ends):
        g = int(gs[s])
        n = e - s
        lr = local_ranges[g]
        if lr > n:
            continue
        thr[g] = cs[s + int(n * (1.0 - lr / n))]
    return thr


class _Contigs:
    """One contraction of the live vertices into maximal unique-link
    chains (= IDBA contigs after MergeSimplePaths)."""

    __slots__ = (
        "tbl", "n", "kcount", "gidc", "alive_c",
        "adaptors", "chain_start", "chain_of_adaptor",
        "nbr_chain", "nbr_strand", "raw_bits",
    )

    def __init__(self, tbl, n, kcount, gidc, adaptors, chain_start,
                 chain_of_adaptor, nbr_chain, nbr_strand, raw_bits):
        self.tbl = tbl
        self.n = n                      # (C,) vertices per chain
        self.kcount = kcount            # (C,) sum of vertex counts
        self.gidc = gidc                # (C,) group id
        self.alive_c = np.ones(len(n), dtype=bool)
        self.adaptors = adaptors        # ordered local adaptor ids
        self.chain_start = chain_start  # (C+1,) offsets into adaptors
        self.chain_of_adaptor = chain_of_adaptor
        self.nbr_chain = nbr_chain      # (C, 2, 4) neighbour chain/-1
        self.nbr_strand = nbr_strand    # (C, 2, 4) arrival strand
        self.raw_bits = raw_bits        # (C, 2) uint8 pruned bitsets

    @property
    def size(self) -> int:
        return len(self.n)

    def contig_size(self, c: int) -> int:
        return int(self.n[c]) + self.tbl.k - 1

    def terminal_adaptor(self, c: int, s: int) -> tuple[int, int]:
        """(vertex, vertex_strand) at the OUT end of chain c, strand s
        (the vertex whose out-bitset holds the chain's strand-s
        out-edges)."""
        st_, e_ = self.chain_start[c], self.chain_start[c + 1]
        ad = self.adaptors[e_ - 1] if s == 0 else self.adaptors[st_] ^ 1
        return int(ad) >> 1, int(ad) & 1

    def live_degree(self, c: int, s: int) -> int:
        d = 0
        for b in range(4):
            nc = self.nbr_chain[c, s, b]
            if nc >= 0 and self.alive_c[nc]:
                d += 1
        return d

    def degrees(self) -> tuple[np.ndarray, np.ndarray]:
        """(out_deg_strand0, out_deg_strand1) against live chains."""
        ok = (self.nbr_chain >= 0)
        ok &= self.alive_c[np.maximum(self.nbr_chain, 0)]
        d = ok.sum(axis=2)
        return d[:, 0].astype(np.int32), d[:, 1].astype(np.int32)

    def kill(self, mask: np.ndarray) -> None:
        """Mark chains dead and release their vertices."""
        self.alive_c &= ~mask
        for c in np.flatnonzero(mask):
            s, e = self.chain_start[c], self.chain_start[c + 1]
            self.tbl.alive[self.adaptors[s:e] >> 1] = False

    def codes_of(self, c: int) -> np.ndarray:
        """Base string of chain c (strand-0 orientation)."""
        tbl, k = self.tbl, self.tbl.k
        s, e = self.chain_start[c], self.chain_start[c + 1]
        ads = self.adaptors[s:e]
        vs, ss = ads >> 1, ads & 1
        first = tbl.vk[vs[0]] if ss[0] == 0 else \
            (3 - tbl.vk[vs[0]][::-1]).astype(np.uint8)
        if len(ads) == 1:
            return first.copy()
        last_b = np.where(ss[1:] == 0, tbl.vk[vs[1:], k - 1],
                          3 - tbl.vk[vs[1:], 0]).astype(np.uint8)
        return np.concatenate([first, last_b])


def _contract(tbl: _VertexTable) -> _Contigs:
    """Unique-link chain contraction over live vertices with pruned
    adjacency (contig_graph.cpp:53-83 RefreshEdges + 225-283 Assemble).
    Cyclic chains and folded (self-revisiting) chains are discarded and
    their vertices die (IsLoop / LockPreempt-failure semantics).

    Works in GLOBAL adaptor space (a = 2*row + strand over the whole
    table): dead vertices simply contribute no candidates and their
    singleton pseudo-chains are filtered at the keep step, so no
    per-contract compaction (av/inv) is ever built."""
    v_all = tbl.size
    if v_all == 0 or not tbl.alive.any():
        z = np.zeros(0, np.int64)
        return _Contigs(tbl, z, z, z, z, np.zeros(1, np.int64),
                        np.full(0, -1, np.int64),
                        np.full((0, 2, 4), -1, np.int64),
                        np.full((0, 2, 4), -1, np.int8),
                        np.zeros((0, 2), np.uint8))
    na = 2 * v_all
    # (A, 4) candidate slots: cached views, zero per-contract gathers
    cache_g, cache_t = tbl.neighbor_cache()
    slot_tgt = cache_g.reshape(na, 4)
    slot_t = cache_t.reshape(na, 4)
    bits_a = np.stack([tbl.out0, tbl.out1], axis=1).reshape(na)
    bcol = np.arange(4, dtype=np.uint8)
    alive = tbl.alive
    ok = (((bits_a[:, None] >> bcol) & 1) != 0) \
        & (slot_tgt >= 0) & alive[np.maximum(slot_tgt, 0)] \
        & np.repeat(alive, 2)[:, None]           # (A, 4)
    pop_a = ok.sum(1, dtype=np.int8)             # (A,)
    okbits = ((ok << bcol).sum(1)).astype(np.uint8)

    # succ per adaptor (GetNextVertexAdaptor, contig_graph.h:116-123:
    # unique out, unique in at next, palindrome-bounce break)
    a_ids = np.arange(na, dtype=np.int32)
    single = pop_a == 1
    rows = np.flatnonzero(single).astype(np.int32)
    b1 = np.argmax(ok[rows], axis=1)
    w = slot_tgt[rows, b1]
    t = slot_t[rows, b1].astype(np.int32)
    wa = w * 2 + t
    good = (pop_a[wa ^ 1] == 1) & (wa != (rows ^ 1))
    succ = np.full(na, -1, np.int32)
    succ[rows[good]] = wa[good]

    # predecessor via twin symmetry; rank chains (native O(n) walk)
    st = succ[a_ids ^ 1]
    pred = np.where(st >= 0, st ^ 1, np.int32(-1))
    from ..native import chain_rank, collect_chain_edges

    cs32, _, _, cyc = chain_rank(succ, pred, np.ones(na, dtype=bool))
    leader = cs32.astype(np.int64)
    if cyc.any():
        tbl.alive[np.unique(a_ids[cyc] >> 1)] = False
        return _contract(tbl)
    # chain ordering: heads ascending (leader == head id); within-chain
    # order by a native O(n) walk
    heads32 = np.flatnonzero(pred < 0).astype(np.int32)
    lens32 = np.bincount(leader, minlength=na)[heads32] \
        .astype(np.int32)
    order = collect_chain_edges(succ, heads32, lens32).astype(np.int64)
    seg_end = np.cumsum(lens32.astype(np.int64))
    sidx = seg_end - lens32
    heads = order[sidx]
    tails = order[seg_end - 1]
    keep = (heads < (tails ^ 1)) & alive[heads >> 1]
    # fold detection: a vertex appears twice within one chain iff its
    # two adaptors share a leader (the rc-bounce break prevents
    # self-twin chains, so cross-twin sharing implies a fold)
    fold_v = leader[0::2] == leader[1::2]            # (V,)
    if fold_v.any():
        # folded chains revisit a vertex: IDBA's LockPreempt fails and
        # the whole path is discarded (hash_graph.cpp:113-118); its
        # vertices never re-enter the graph
        fold_head = np.zeros(na, dtype=bool)
        fold_head[leader[0::2][fold_v]] = True
        fold_mask = fold_head[heads]
        for si in np.flatnonzero(fold_mask):
            ads = order[sidx[si]:seg_end[si]]
            tbl.alive[np.unique(ads >> 1)] = False
        keep &= ~fold_mask

    n = (seg_end - sidx)[keep].astype(np.int64)
    # ordered adaptors of kept chains, concatenated (global ids)
    keep_row = np.repeat(keep, lens32)
    adaptors = order[keep_row]
    chain_start = np.concatenate([[0], np.cumsum(n)])
    vs_all = adaptors >> 1
    kcount = np.add.reduceat(tbl.cnt[vs_all], chain_start[:-1]) \
        if len(n) else np.zeros(0, np.int64)
    gidc = tbl.gid[vs_all[chain_start[:-1]]] if len(n) \
        else np.zeros(0, np.int64)

    # adaptor -> chain (both directions map to the kept chain)
    chain_of_adaptor = np.full(na, -1, np.int64)
    chain_of_adaptor[adaptors] = np.repeat(np.arange(len(n)), n)
    chain_of_adaptor[adaptors ^ 1] = chain_of_adaptor[adaptors]

    c = len(n)
    heads_k = adaptors[chain_start[:-1]] if c else np.zeros(0, np.int64)
    tails_k = adaptors[chain_start[1:] - 1] if c else np.zeros(0, np.int64)
    raw_bits = np.zeros((c, 2), np.uint8)
    nbr_chain = np.full((c, 2, 4), -1, np.int64)
    nbr_strand = np.full((c, 2, 4), -1, np.int8)
    for s_c, ad in ((0, tails_k), (1, heads_k ^ 1)):
        raw_bits[:, s_c] = okbits[ad]
        for b in range(4):
            has = ok[ad, b]
            rows = np.flatnonzero(has)
            if len(rows) == 0:
                continue
            adr = ad[rows]
            wa = slot_tgt[adr, b] * 2 + slot_t[adr, b]
            nc = chain_of_adaptor[wa]
            nbr_chain[rows, s_c, b] = nc
            # arriving strand: 0 if the target adaptor is that
            # chain's head
            okc = nc >= 0
            hk = heads_k[np.maximum(nc, 0)]
            nbr_strand[rows, s_c, b] = np.where(
                okc & (hk == wa), 0, 1).astype(np.int8)
    return _Contigs(tbl, n, kcount, gidc, adaptors, chain_start,
                    chain_of_adaptor, nbr_chain, nbr_strand, raw_bits)


def _trim(cg: _Contigs, min_length: int) -> int:
    """ContigGraph::Trim (contig_graph.cpp:91-110): kill short chains
    with a free end and total degree <= 1. Lengths are in vertices:
    contig_size < min_length + k - 1  <=>  n < min_length."""
    d0, d1 = cg.degrees()
    kill = (cg.alive_c
            & ((d0 == 0) | (d1 == 0))
            & (d0 + d1 <= 1)
            & (cg.n < min_length))
    cg.kill(kill)
    return int(kill.sum())


def _remove_dead_end(tbl: _VertexTable, cg: _Contigs,
                     min_length: int) -> _Contigs:
    """ContigGraph::RemoveDeadEnd (contig_graph.cpp:112-123)."""
    length = 1
    while True:
        length = min(2 * length, min_length)
        if _trim(cg, length):
            cg = _contract(tbl)
        if length == min_length:
            return cg


def _internal_size(cg: _Contigs, path: list[tuple[int, int]]) -> int:
    """ContigGraphPath::internal_size (contig_graph_path.h:119-127)."""
    if len(path) <= 1:
        return len(path)
    k = cg.tbl.k
    size = k + 1
    for c, _ in path[1:-1]:
        size += cg.contig_size(c)
    return size - (len(path) - 1) * (k - 1)


def _branch_search(cg: _Contigs, c0: int, s0: int,
                   present: np.ndarray | None = None):
    """ContigGraphBranchGroup::Search (contig_graph_branch_group.cpp:
    17-85): level-synchronous expansion of <=4 branches to internal
    size exactly k+2, converging on one end vertex.

    `present` is the (C, 2, 4) bool overlay of chain-level edge bits
    (mutated by Merge during the same pass); None means all candidate
    bits are present. Branch steps are recorded as (chain, strand,
    entry_bit) so Merge can re-add exactly the traversed edges."""
    k = cg.tbl.k
    max_len = k + 2
    if cg.contig_size(c0) == k:
        return None

    def has_bit(c, s, b):
        return present is None or present[c, s, b]

    branches = [[(c0, s0, -1)]]
    converge = False
    end = None
    for _ in range(1, max_len):
        num = len(branches)
        extended = False
        for i in range(num):
            if _internal_size(cg, [(c, s) for c, s, _ in branches[i]]) \
                    >= max_len:
                continue
            cc, cs, _eb = branches[i][-1]
            first = True
            base = list(branches[i])
            found_any = False
            for b in range(4):
                nc = cg.nbr_chain[cc, cs, b]
                if nc < 0 or not has_bit(cc, cs, b):
                    continue
                if not cg.alive_c[nc]:
                    return None          # next.status().IsDead()
                nxt = (int(nc), int(cg.nbr_strand[cc, cs, b]), b)
                found_any = True
                if first:
                    branches[i].append(nxt)
                    first = False
                else:
                    if len(branches) == 4:
                        return None
                    branches.append(base + [nxt])
                extended = True
            if not found_any:
                return None              # out_edges().size() == 0
        end = branches[0][-1][:2]
        if cg.contig_size(end[0]) > k:
            converge = all(
                br[-1][:2] == end
                and _internal_size(cg, [(c, s) for c, s, _ in br])
                == max_len
                for br in branches)
            if converge:
                break
        if not extended:
            break
    if not (converge and (c0, s0) != end):
        return None
    return branches


def _remove_bubble(tbl: _VertexTable, cg: _Contigs) -> _Contigs:
    """ContigGraph::RemoveBubble (contig_graph.cpp:125-182): two-phase
    candidate collection + merge with IDBA's exact Merge semantics
    (contig_graph_branch_group.cpp:87-112): the begin vertex's whole
    out-bitset and the end vertex's whole in-bitset are ZEROED (also
    dropping edges leaving the bubble), all middles die, then the
    highest-kmer-count branch's middles revive and its edges re-add."""
    # chain-level edge-bit presence overlay, mutated by Merge; the
    # reference's refreshed bitsets match cg.nbr_chain candidacy
    present = cg.nbr_chain >= 0

    def deg(c, s):
        # reference uses out_edges().size(): bit count, regardless of
        # whether the target chain has since died
        return int(present[c, s].sum())

    def confirmed(c, s):
        br = _branch_search(cg, c, s, present)
        if br is None:
            return None
        # reverse search from rc(end) must converge back at rc(begin)
        ec, es = br[0][-1][:2]
        rbr = _branch_search(cg, ec, 1 - es, present)
        if rbr is None or rbr[0][-1][:2] != (c, 1 - s):
            return None
        return br

    candidates = []
    for c in range(cg.size):
        for s in (0, 1):
            if deg(c, s) > 1 and cg.contig_size(c) > tbl.k \
                    and confirmed(c, s) is not None:
                candidates.append((c, s))

    touched: set[tuple[int, int]] = set()
    merged = 0
    for c, s in candidates:
        if not cg.alive_c[c] or deg(c, s) <= 1:
            continue
        br = confirmed(c, s)
        if br is None:
            continue
        best = 0
        best_kc = -1
        for i, path in enumerate(br):
            kc = sum(int(cg.kcount[cc]) for cc, _, _ in path)
            if kc > best_kc:
                best, best_kc = i, kc
        kill = np.zeros(cg.size, dtype=bool)
        for path in br:
            c0p, s0p = path[0][:2]
            cep, sep = path[-1][:2]
            present[c0p, s0p, :] = False       # begin.out_edges = 0
            present[cep, 1 - sep, :] = False   # end.in_edges = 0
            touched.update(((c0p, s0p), (cep, 1 - sep)))
            for cc, ss, _ in path[1:-1]:
                present[cc, ss, :] = False
                present[cc, 1 - ss, :] = False
                touched.update(((cc, ss), (cc, 1 - ss)))
                kill[cc] = True
        bp = br[best]
        for cc, ss, _ in bp[1:-1]:
            kill[cc] = False                   # ResetDeadFlag
        for (ac, as_, _), (bc, bs, bbit) in zip(bp[:-1], bp[1:]):
            present[ac, as_, bbit] = True      # AddEdge forward bit
            touched.add((ac, as_))
            for b2 in range(4):                # ... and its rc bit
                if cg.nbr_chain[bc, 1 - bs, b2] == ac \
                        and cg.nbr_strand[bc, 1 - bs, b2] == 1 - as_:
                    present[bc, 1 - bs, b2] = True
                    touched.add((bc, 1 - bs))
                    break
        if kill.any():
            cg.kill(kill)
        merged += 1

    if merged:
        # materialize the mutated chain bits onto the terminal vertex
        # bitsets so the re-contraction (reference Refresh +
        # MergeSimplePaths) sees them
        for (c, s) in touched:
            if not cg.alive_c[c]:
                continue
            vt, st = cg.terminal_adaptor(c, s)
            bits = 0
            for b in range(4):
                if present[c, s, b]:
                    bits |= 1 << b
            if st == 0:
                tbl.out0[vt] = np.uint8(bits)
            else:
                tbl.out1[vt] = np.uint8(bits)
        cg = _contract(tbl)
    return cg


def _iterate_coverage(tbl: _VertexTable, cg: _Contigs,
                      min_length: int, thresholds: np.ndarray) -> _Contigs:
    """ContigGraph::IterateCoverage + RemoveLowCoverage
    (contig_graph.cpp:184-216) with the per-group pass schedule of
    LaunchIDBA: group g sees passes at cover = min(1, thr_g) * 1.1^j,
    always at least one, stopping before cover >= thr_g."""
    factor = 1.1
    j = 0
    while True:
        cover = np.where(thresholds > 1.0, 1.0, thresholds) \
            * (factor ** j)
        scheduled = (j == 0) | (cover < thresholds)
        if not scheduled.any():
            return cg
        if cg.size:
            cov_c = cover[cg.gidc]
            sch_c = scheduled[cg.gidc]
            d0, d1 = cg.degrees()
            weak = ((d0 <= 1) & (d1 <= 1)) | (d0 == 0) | (d1 == 0)
            coverage = cg.kcount / np.maximum(cg.n, 1)
            kill = (cg.alive_c & sch_c & weak
                    & (cg.n < min_length) & (coverage < cov_c))
            if kill.any():
                cg.kill(kill)
                cg = _contract(tbl)
        j += 1


def _idba_slab(groups_reads, contig_ends, group_ids, mink, maxk, step,
               out):
    """Run the full k-ladder for one slab of groups; writes results
    into out[g] (LaunchIDBA, local_assemble.cpp:28-81)."""
    n = len(group_ids)
    maxrl = [max((len(r) for r in reads), default=0)
             for reads in groups_reads]
    active = [True] * n
    for k in range(mink, maxk + 1, step):
        in_round = [active[i] and k <= min(maxk, maxrl[i])
                    for i in range(n)]
        if not any(in_round):
            break
        seqs, gids, kinds = [], [], []
        for i in range(n):
            if not in_round[i]:
                continue
            for r in groups_reads[i]:
                if len(r) >= k:
                    seqs.append(r)
                    gids.append(i)
                    kinds.append(0)
            seqs.append(contig_ends[i])
            gids.append(i)
            kinds.append(1)
            for cseq in out[group_ids[i]]:
                seqs.append(cseq)
                gids.append(i)
                kinds.append(2)
        tbl = _build_vertices(seqs, gids, kinds, k)
        if tbl is None:
            continue
        lr = {i: len(contig_ends[i]) for i in range(n)}
        thr = _thresholds(tbl, lr, n)

        cg = _contract(tbl)
        cg = _remove_dead_end(tbl, cg, 2 * k)
        cg = _remove_bubble(tbl, cg)
        cg = _iterate_coverage(tbl, cg, 2 * k, thr)

        for i in range(n):
            if in_round[i]:
                out[group_ids[i]] = []
        for c in np.flatnonzero(cg.alive_c):
            gi = int(cg.gidc[c])
            if in_round[gi]:
                out[group_ids[gi]].append(cg.codes_of(int(c)))
        for i in range(n):
            if in_round[i] and len(out[group_ids[i]]) == 1:
                active[i] = False      # LaunchIDBA early break


def mini_assemble(
    groups_reads: list[list[np.ndarray]],
    contig_ends: list[np.ndarray],
    mink: int = 11,
    maxk: int = 41,
    step: int = 6,
) -> dict[int, list[np.ndarray]]:
    """Assemble each group's reads + its contig end; returns
    {group: [contig codes]} (reference LaunchIDBA,
    local_assemble.cpp:28-81). Groups are packed into bounded-size
    slabs and each slab's k-ladder runs as batched vectorized sweeps."""
    log = get_logger()
    n_groups = len(groups_reads)
    out: dict[int, list[np.ndarray]] = {g: [] for g in range(n_groups)}
    if n_groups == 0:
        return out

    slab_bases = 2_000_000
    slab: list[int] = []
    acc = 0
    slabs: list[list[int]] = []
    for g in range(n_groups):
        sz = sum(len(r) for r in groups_reads[g]) + len(contig_ends[g])
        if slab and acc + sz > slab_bases:
            slabs.append(slab)
            slab, acc = [], 0
        slab.append(g)
        acc += sz
    if slab:
        slabs.append(slab)

    for members in slabs:
        _idba_slab([groups_reads[g] for g in members],
                   [contig_ends[g] for g in members],
                   members, mink, maxk, step, out)
    log.info(
        "mini-assembly: %d groups in %d slabs, %d contigs",
        n_groups, len(slabs), sum(len(v) for v in out.values()),
    )
    return out
