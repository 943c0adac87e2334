"""Contig string reconstruction and output.

Replaces reference UnitigGraph::VertexToDNAString + OutputContigs
(src/assembly/unitig_graph.cpp:357-394, contig_output.cpp:43-120).
Counterpart of megahit_tpu/graph/output.py.
The reference reconstructs each contig by walking PrevSimplePathEdge and
reading W chars one edge at a time; here the bases of all requested
unitigs are produced with one lexsort over (chain, position) plus a
vectorized last-base extraction.
"""

from __future__ import annotations

import numpy as np

from ..core import packing
from ..io.contig_io import FLAG_LOOP, FLAG_STANDALONE, ContigRecord
from ..utils import device as devices
from .unitig import UnitigGraph


def _last_base(keys: np.ndarray, k: int) -> np.ndarray:
    """Last base of each (N, W) key."""
    word = (k - 1) // 16
    sh = 30 - 2 * ((k - 1) % 16)
    return ((keys[:, word] >> np.uint32(sh)) & 3).astype(np.uint8)


def unitig_codes(graph: UnitigGraph, subset: np.ndarray | None = None
                 ) -> dict[int, np.ndarray]:
    """Base-code arrays of unitigs (forward-chain orientation).

    subset: vertex ids to extract (default: all). Returns {vid: codes}.
    Contig length = k + length - 1 (first edge contributes k bases, each
    subsequent edge its last base).
    """
    k = graph.k
    s = graph.sdbg
    if subset is None:
        subset = np.flatnonzero(graph.alive)
    subset = np.asarray(subset)
    out: dict[int, np.ndarray] = {}
    if len(subset) == 0:
        return out

    want = np.zeros(graph.size, dtype=bool)
    want[subset] = True

    # --- chain vertices: on the host route, native chain walks emit
    # members already in (chain, pos) order - O(selected edges), no
    # whole-edge scan; the card's route lexsorts (chain_start, pos)
    chain_vs = subset[~graph.is_loop[subset]]
    if len(chain_vs):
        if not devices.graph_on_card(s.device):
            from ..native import collect_chain_edges

            eidx = collect_chain_edges(
                graph.nxt, graph.start[chain_vs],
                graph.length[chain_vs],
            )
            counts = graph.length[chain_vs].astype(np.int64)
            boundaries = np.concatenate(
                [[0], np.cumsum(counts)[:-1]]).astype(np.int64)
            vids = chain_vs.astype(np.int64)
            bases = _last_base(s.keys[eidx], k)
        else:
            sel_start = np.zeros(s.size, dtype=bool)
            sel_start[graph.start[chain_vs]] = True
            emask = s.valid & (graph.vid >= 0)
            emask &= want[np.maximum(graph.vid, 0)]
            emask &= sel_start[graph.chain_start]  # forward chains only
            eidx = np.flatnonzero(emask)
            order = np.lexsort(
                (graph.edge_pos[eidx], graph.chain_start[eidx])
            )
            eidx = eidx[order]
            bases = _last_base(s.keys[eidx], k)
            chains = graph.chain_start[eidx]
            head = np.empty(len(eidx), dtype=bool)
            if len(eidx):
                head[0] = True
                np.not_equal(chains[1:], chains[:-1], out=head[1:])
            boundaries = np.flatnonzero(head)
            ends = np.concatenate([boundaries[1:], [len(eidx)]])
            row_of_start = np.full(s.size, -1, dtype=np.int64)
            row_of_start[graph.start[chain_vs]] = chain_vs
            vids = row_of_start[chains[boundaries]]
            counts = ends - boundaries
        lens = counts + (k - 1)  # k head bases + (cnt-1) tail bases
        offs = np.zeros(len(vids) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        flat = np.empty(offs[-1], dtype=np.uint8)

        # head: all k bases of each chain's first edge, vectorized
        first_keys = s.keys[eidx[boundaries]]  # (C, W)
        pos_k = np.arange(k)
        words = first_keys[:, pos_k // 16]  # (C, k)
        shifts = (30 - 2 * (pos_k % 16)).astype(np.uint32)
        heads = ((words >> shifts[None, :]) & 3).astype(np.uint8)
        head_dst = offs[:-1, None] + pos_k[None, :]
        flat[head_dst.reshape(-1)] = heads.reshape(-1)

        # tail: last base of every non-first edge, scattered to
        # offset + k + rank-1 (ranks from the group-sorted order)
        rank = np.arange(len(eidx), dtype=np.int64)
        group_start = np.repeat(boundaries, counts)
        group_id = np.repeat(
            np.arange(len(vids), dtype=np.int64), counts
        )
        tail_dst = offs[group_id] + k + (rank - group_start) - 1
        is_tail = rank > group_start
        flat[tail_dst[is_tail]] = bases[is_tail]

        for i, v in enumerate(vids):
            out[int(v)] = flat[offs[i] : offs[i + 1]]

    # --- loop vertices: walk the cycle (rare, host)
    loop_vs = subset[graph.is_loop[subset]]
    for v in loop_vs:
        v = int(v)
        cur = int(graph.start[v])
        head = packing.unpack_words(s.keys[cur], k)
        tail = np.zeros(graph.length[v] - 1, dtype=np.uint8)
        for i in range(graph.length[v] - 1):
            cur = int(graph.nxt[cur])
            tail[i] = _last_base(s.keys[cur : cur + 1], k)[0]
        out[v] = np.concatenate([head, tail])
    return out


def fold_palindrome(codes: np.ndarray, k: int, is_loop: bool) -> np.ndarray:
    """Reference FoldPalindrome (contig_output.cpp:43-59): a palindromic
    unitig stores both strands; keep one half."""
    if is_loop:
        n = len(codes)
        for i in range(1, n - k + 1):
            rc = packing.revcomp_codes(codes[i : i + k])
            if np.array_equal(rc, codes[i - 1 : i - 1 + k]):
                return codes[i : i + n // 2]
        return codes
    num_edges = len(codes) - k
    return codes[: (num_edges - 1) // 2 + k + 1]


def output_contigs(
    graph: UnitigGraph,
    change_only: bool = False,
    min_standalone: int = 0,
    want_final: bool = False,
) -> tuple[list[ContigRecord], list[ContigRecord]]:
    """Produce contig records (reference OutputContigs,
    contig_output.cpp:63-120).

    Returns (contigs, final_contigs): final_contigs get the standalone
    routing when want_final (i.e. a final-contig writer was passed).
    change_only: only vertices marked changed, with multi=1 (addi.fa).
    """
    from .counter import KMAX_MUL as kmax_mul

    # contig headers carry the megahit-level k (node length); the
    # graph's k is the EDGE length = megahit k + 1
    k = graph.k - 1
    ind, outd = graph.in_out_degree()
    if change_only:
        subset = np.flatnonzero(graph.changed & graph.alive)
    else:
        subset = np.flatnonzero(graph.alive)
    codes_by_v = unitig_codes(graph, subset)
    # contig ids = rank among alive slots (== the reference's stably-
    # compacted vertex index; ascending-slot order is preserved)
    rank = np.cumsum(graph.alive) - 1

    contigs: list[ContigRecord] = []
    finals: list[ContigRecord] = []
    # output strand: the reference's VertexToDNAString calls
    # ToUniqueFormat (unitig_graph_vertex.h:73-77) - flip to the
    # strand whose BEGIN edge id is smaller (canonical_id = min(b, rb))
    rr = graph.sdbg.ref_rank
    for v in subset:
        v = int(v)
        codes = codes_by_v[v]
        if rr[graph.rc_start[v]] < rr[graph.start[v]]:
            codes = packing.revcomp_codes(codes)
        multi = 1.0 if change_only else min(
            float(kmax_mul), graph.total_depth[v] / max(graph.length[v], 1)
        )
        if graph.is_loop[v]:
            flag = FLAG_LOOP | FLAG_STANDALONE
            sink = contigs
            if graph.is_palindrome[v]:
                codes = fold_palindrome(codes, k, True)
                flag = FLAG_STANDALONE
            if want_final:
                if len(codes) < min_standalone:
                    continue
                sink = finals
            sink.append(ContigRecord(codes, k, int(rank[v]), flag, multi))
        else:
            flag = 0
            sink = contigs
            if ind[v] == 0 and outd[v] == 0:
                if graph.is_palindrome[v]:
                    codes = fold_palindrome(codes, k, False)
                flag = FLAG_STANDALONE
                if want_final:
                    if len(codes) < min_standalone:
                        continue
                    sink = finals
            sink.append(ContigRecord(codes, k, int(rank[v]), flag, multi))
    return contigs, finals


def contig_stats(lengths: np.ndarray) -> dict:
    """N50/min/max/total (reference contig_stat.h:16-49)."""
    if len(lengths) == 0:
        return dict(n=0, total=0, min=0, max=0, avg=0, n50=0)
    ls = np.sort(lengths)[::-1]
    total = int(ls.sum())
    cum = np.cumsum(ls)
    n50 = int(ls[np.searchsorted(cum, total / 2)])
    return dict(
        n=len(ls), total=total, min=int(ls.min()), max=int(ls.max()),
        avg=int(total / len(ls)), n50=n50,
    )
