"""Unitig graph construction by parallel pointer doubling.

The reference builds unitigs with per-edge try-locks and a spinlocked
vertex vector (src/assembly/unitig_graph.cpp:13-138). Here there are no
locks: the simple-path successor relation next[e] (mutual by construction)
makes the valid subgraph a disjoint union of chains and pure cycles, so
list ranking by pointer doubling (log2 E rounds of gathers) yields every
chain's start, end, length and member positions deterministically.

A unitig VERTEX pairs a chain with its reverse-complement chain
(rc image of chain [s..t] is chain [rc(t)..rc(s)]); palindromes are
self-paired; cycles become loop vertices (unitig_graph.cpp:86-123).

On a CUDA graph the links and ranks are torch passes on the device; on
a CPU graph they are the host engine's native walks. Counterpart of
megahit_tpu/graph/unitig.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import device as devices
from ..utils.log import get_logger
from .sdbg import Sdbg, simple_path_links

NULL = np.int32(-1)


def _list_rank(nxt: torch.Tensor, prv: torch.Tensor, rounds: int):
    """Pointer-double both directions (torch, on the links' device; one
    block of _list_rank_rows: plain indexing, no exchange).

    Returns (end, dist_to_end, start, pos, min_reach):
      end[e]   = last edge of e's chain (self-stable for cycles)
      start[e] = first edge of e's chain
      pos[e]   = distance from start (undefined for cycles)
      min_reach[e] = min edge index in e's forward orbit (cycle rep)
    """
    from ..parallel.rows import Blocks, Rows

    out = _list_rank_rows(Rows(None, nxt.device), Blocks([nxt]),
                          Blocks([prv]), rounds)
    return tuple(x.b[0] for x in out)


def _list_rank_rows(rows, nxt, prv, rounds: int):
    """_list_rank over row blocks (parallel/rows.py): each round's reads
    at n and at p are one take each."""
    from ..parallel import rows as R

    idx = rows.arange(rows.n * nxt.b[0].shape[0])
    n = R.where(nxt >= 0, nxt, idx)
    p = R.where(prv >= 0, prv, idx)
    d_end = (nxt >= 0).to(torch.int32)
    d_start = (prv >= 0).to(torch.int32)
    mn = idx
    for _ in range(rounds):
        de_n, mn_n, n_n = rows.take([d_end, mn, n], n)
        ds_p, p_p = rows.take([d_start, p], p)
        d_end = d_end + de_n
        d_start = d_start + ds_p
        mn = R.minimum(mn, mn_n)
        n, p = n_n, p_p
    return n, d_end, p, d_start, mn


@dataclass
class UnitigGraph:
    """Struct-of-arrays unitig graph (reference UnitigGraphVertex,
    src/assembly/unitig_graph_vertex.h:17-49)."""

    k: int
    sdbg: Sdbg
    # per-vertex arrays
    start: np.ndarray  # (V,) int32 first edge of forward chain
    end: np.ndarray  # (V,) int32 last edge of forward chain
    rc_start: np.ndarray  # (V,) int32 = rc[end]
    rc_end: np.ndarray  # (V,) int32 = rc[start]
    length: np.ndarray  # (V,) int32 number of edges
    total_depth: np.ndarray  # (V,) int64 sum of member edge multiplicities
    is_loop: np.ndarray  # (V,) bool
    is_palindrome: np.ndarray  # (V,) bool
    # per-edge arrays (over the whole sdbg)
    vid: np.ndarray  # (E,) int32 vertex id of each valid edge (-1 else)
    chain_start: np.ndarray = field(default=None)  # (E,) int32
    edge_pos: np.ndarray = field(default=None)  # (E,) int32 (chains only)
    nxt: np.ndarray = field(default=None)  # (E,) int32 simple-path successor
    prv: np.ndarray = field(default=None)  # (E,) int32 simple-path predecessor
    # mutable marks
    to_delete: np.ndarray = field(default=None)
    to_disconnect_fwd: np.ndarray = field(default=None)
    to_disconnect_rc: np.ndarray = field(default=None)
    changed: np.ndarray = field(default=None)
    # slot-space liveness: refresh() updates vertices IN
    # PLACE and never compacts; dead slots keep stale values and every
    # consumer masks with `alive`. Row-order tie-breaks are unchanged
    # because the reference's stable compaction preserves exactly the
    # ascending-slot order (unitig_graph.cpp:210-355 std::remove_if).
    alive: np.ndarray = field(default=None)

    def __post_init__(self):
        v = len(self.start)
        if self.to_delete is None:
            self.to_delete = np.zeros(v, dtype=bool)
        if self.to_disconnect_fwd is None:
            self.to_disconnect_fwd = np.zeros(v, dtype=bool)
        if self.to_disconnect_rc is None:
            self.to_disconnect_rc = np.zeros(v, dtype=bool)
        if self.changed is None:
            self.changed = np.zeros(v, dtype=bool)
        if self.alive is None:
            self.alive = np.ones(v, dtype=bool)

    @property
    def size(self) -> int:
        return len(self.start)

    def __copy__(self):
        """Deep-ish copy owning every mutable array (refresh mutates
        in place, so shallow copies must not share)."""
        c = object.__new__(UnitigGraph)
        c.__dict__.update(self.__dict__)
        for f in ("start", "end", "rc_start", "rc_end", "length",
                  "total_depth", "is_loop", "is_palindrome", "vid",
                  "chain_start", "edge_pos", "nxt", "prv", "to_delete",
                  "to_disconnect_fwd", "to_disconnect_rc", "changed",
                  "alive"):
            a = getattr(self, f)
            if a is not None:
                setattr(c, f, np.array(a))
        return c

    def avg_depth(self) -> np.ndarray:
        return self.total_depth / np.maximum(self.length, 1)

    def contig_len(self) -> np.ndarray:
        """Base-pair length of each unitig string (k + edges - 1)."""
        return self.length + self.k - 1

    # ---------------- neighbour queries (vectorized over all vertices)

    def next_vertices(self, strand: int):
        """For every vertex, its successors when traversed on `strand`
        (0 = forward chain, 1 = rc chain).

        Returns (nbr_vid (V,4), nbr_strand (V,4), present (V,4)):
        candidate j enters neighbour `nbr_vid` in orientation
        `nbr_strand` (0 = its forward chain, 1 = its rc chain).
        """
        from .sdbg import cands_at

        s = self.sdbg
        last_edge = self.end if strand == 0 else self.rc_end
        cand = cands_at(s, last_edge, "oc_t")  # (V,4)
        safe = np.maximum(cand, 0)
        present = (cand >= 0) & s.valid[safe]
        nbr = np.where(present, self.vid[safe], NULL)
        # orientation: forward if candidate edge is the neighbour's
        # forward-chain start
        nbr_safe = np.maximum(nbr, 0)
        enter_fwd = safe == self.start[nbr_safe]
        # loops/palindromes: entering edge may be mid-chain; treat as fwd
        nbr_strand = np.where(enter_fwd, 0, 1)
        return nbr, nbr_strand, present

    def in_out_degree(self):
        """(indegree, outdegree) per vertex, forward orientation."""
        _, _, out_present = self.next_vertices(0)
        _, _, in_present = self.next_vertices(1)
        return in_present.sum(-1), out_present.sum(-1)

    def is_standalone(self) -> np.ndarray:
        ind, outd = self.in_out_degree()
        return (~self.is_loop) & (ind == 0) & (outd == 0)


def build_unitig_graph(sdbg: Sdbg) -> UnitigGraph:
    """Assemble all maximal simple paths and loops into a unitig graph."""
    log = get_logger()
    e = sdbg.size
    if e == 0:
        z = np.zeros(0, dtype=np.int32)
        return UnitigGraph(sdbg.k, sdbg, z, z.copy(), z.copy(), z.copy(),
                           z.copy(), np.zeros(0, np.int64),
                           np.zeros(0, bool), np.zeros(0, bool),
                           np.full(0, NULL, np.int32),
                           chain_start=z.copy(), edge_pos=z.copy(),
                           nxt=z.copy(), prv=z.copy())

    validn = sdbg.valid
    if not devices.graph_on_card(sdbg.device):
        # host route: native threaded links, then one O(E) native
        # pointer walk (native/graphwalk.cpp) instead of log2(E) rounds
        # of whole-graph gathers
        from ..native import chain_rank
        from .sdbg import simple_path_links_host

        nxt, prv = simple_path_links_host(sdbg)
        chain_start, chain_end_arr, pos, in_cycle = chain_rank(
            nxt, prv, validn)
        in_cycle = in_cycle & validn
    else:
        dev = sdbg.device
        nxt_t, prv_t = simple_path_links(*(
            torch.from_numpy(a).to(dev, torch.int64)
            for a in (sdbg.run_start, sdbg.nxt_link, sdbg.rc)),
            torch.from_numpy(sdbg.valid).to(dev))
        nxt = nxt_t.cpu().numpy().astype(np.int32)
        prv = prv_t.cpu().numpy().astype(np.int32)
        rounds = max(1, int(np.ceil(np.log2(max(e, 2)))))
        end, d_end, start, pos, mn = (
            t.cpu().numpy() for t in _list_rank(nxt_t, prv_t, rounds))
        # cycles: chains whose "end" still has a successor
        in_cycle = validn & (nxt[end] >= 0)
        chain_start = np.where(in_cycle, mn, start).astype(np.int32)
        chain_end_arr = np.where(in_cycle, prv[mn], end).astype(np.int32)

    # one representative row per chain: the chain-start edge
    is_rep = validn & (chain_start == np.arange(e, dtype=np.int32))
    rep_idx = np.flatnonzero(is_rep).astype(np.int32)  # chain list

    # aggregates per chain via bincount keyed by chain_start
    seg = chain_start[validn]
    length_per_start = np.bincount(seg, minlength=e).astype(np.int64)
    depth_per_start = np.bincount(
        seg, weights=sdbg.mult[validn], minlength=e
    ).astype(np.int64)

    c_start = rep_idx
    c_end = chain_end_arr[rep_idx]
    c_loop = in_cycle[rep_idx]
    c_len = length_per_start[rep_idx]
    c_depth = depth_per_start[rep_idx]

    # pair chains with their rc chains: rc image of chain [s..t] is the
    # chain containing rc(t); use that chain's canonical start so cycles
    # pair by their min-index representative.
    pair_start = chain_start[sdbg.rc[c_end]]
    # keep rule matches the reference's sequential scan
    # (unitig_graph.cpp:22-82): a chain is discovered at its TAIL edge
    # (NextSimplePathEdge == null), scanning edge ids ascending, so the
    # stored orientation is the one whose tail edge RANK (in the
    # reference's item order, Sdbg.ref_rank) is smaller (palindrome:
    # equal). Cycles are discovered at their min-rank edge over both
    # orientations (unitig_graph.cpp:90-120).
    rr = sdbg.ref_rank
    # per-cycle min-rank member edge (cycles only; host, rare)
    amin_of_start = np.full(e, NULL, dtype=np.int64)
    cyc_edges = np.flatnonzero(validn & in_cycle)
    if len(cyc_edges):
        co = cyc_edges[np.lexsort(
            (rr[cyc_edges], chain_start[cyc_edges])
        )]
        first = np.ones(len(co), dtype=bool)
        first[1:] = chain_start[co[1:]] != chain_start[co[:-1]]
        amin_of_start[chain_start[co[first]]] = co[first]
    c_amin = amin_of_start[c_start]  # cycle reps only
    pair_amin = amin_of_start[pair_start]
    keep = np.where(
        c_loop,
        rr[np.maximum(c_amin, 0)] <= rr[np.maximum(pair_amin, 0)],
        rr[c_end] <= rr[sdbg.rc[c_start]],
    )
    # reference vertex order: all simple paths (ascending tail rank),
    # then all cycles (ascending min member rank)
    okey = rr[np.where(c_loop, np.maximum(c_amin, 0), c_end)]
    order = np.lexsort((okey, c_loop.astype(np.int8)))
    order = order[keep[order]]
    c_start, c_end = c_start[order], c_end[order]
    c_loop, c_len, c_depth = c_loop[order], c_len[order], c_depth[order]
    pair_start = pair_start[order]
    c_amin = c_amin[order]
    # cycles anchor at next(min_rank_edge): reference stores
    # (begin=next(min), end=min) so the string starts one past it
    v_start = np.where(c_loop, nxt[np.maximum(c_amin, 0)],
                       c_start).astype(np.int32)
    v_end = np.where(c_loop, np.maximum(c_amin, 0),
                     c_end).astype(np.int32)
    v_pair_start = pair_start
    v_rc_start = sdbg.rc[v_end]  # traversal anchor for the rc strand
    v_rc_end = sdbg.rc[v_start]
    v_len = c_len.astype(np.int32)
    v_depth = c_depth
    v_loop = c_loop
    v_pal = c_start == v_pair_start

    # per-edge vertex id: row index by canonical chain start (both
    # chains); loops key on the chain representative (min edge), not
    # v_start, which anchors one past it
    row_of_start = np.full(e, NULL, dtype=np.int32)
    row_of_start[c_start] = np.arange(len(c_start), dtype=np.int32)
    row_of_start[v_pair_start] = np.arange(len(c_start), dtype=np.int32)
    vid = np.full(e, NULL, dtype=np.int32)
    vid[validn] = row_of_start[chain_start[validn]]

    g = UnitigGraph(
        sdbg.k, sdbg, v_start.astype(np.int32), v_end.astype(np.int32),
        v_rc_start.astype(np.int32), v_rc_end.astype(np.int32),
        v_len, v_depth, v_loop, v_pal, vid,
        chain_start=chain_start, edge_pos=pos.astype(np.int32),
        nxt=nxt, prv=prv,
    )
    log.debug(
        "unitig graph: %d vertices (%d loops, %d palindromes) from %d edges",
        g.size, int(v_loop.sum()), int(v_pal.sum()), int(validn.sum()),
    )
    return g


# ---------------------------------------------------------------------------
# refresh = apply marks to the sdbg, then rebuild
# ---------------------------------------------------------------------------


def _classify_marks(graph: UnitigGraph):
    """Split marks into whole-vertex deletions and terminal disconnects
    (reference RefreshDisconnected, unitig_graph.cpp:141-208)."""
    n_marks = (graph.to_disconnect_fwd.astype(int)
               + graph.to_disconnect_rc.astype(int))
    kill_whole = (~graph.to_delete) & (n_marks > 0) & (
        graph.length <= n_marks
    )
    disc_fwd = graph.to_disconnect_fwd & ~graph.to_delete & ~kill_whole
    disc_rc = graph.to_disconnect_rc & ~graph.to_delete & ~kill_whole
    delete = graph.to_delete | kill_whole
    # slot-space: marks on dead slots (stale flags) are void
    return (delete & graph.alive, disc_fwd & graph.alive,
            disc_rc & graph.alive)


def _kill_edge_indices(graph, delete, disc_fwd, disc_rc):
    """Edge indices to invalidate (rc partners handled by caller)."""
    parts = []
    if disc_fwd.any():
        parts.append(graph.start[disc_fwd])
    if disc_rc.any():
        parts.append(graph.rc_start[disc_rc])
    if delete.any():
        if not devices.graph_on_card(graph.sdbg.device):
            # sparse: walk only the deleted chains (forward strands;
            # invalidate_idx adds the rc partners) instead of scanning
            # every edge's vid
            from ..native import collect_chain_edges

            rows = np.flatnonzero(delete)
            fwd = collect_chain_edges(
                graph.nxt, graph.start[rows], graph.length[rows]
            )
        else:
            member = (graph.vid >= 0) & delete[np.maximum(graph.vid, 0)]
            fwd = np.flatnonzero(member)
        parts.append(fwd)
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate([np.asarray(p, dtype=np.int64)
                           for p in parts])


def _propagate_changed(graph: UnitigGraph, g2: UnitigGraph,
                       set_changed: bool) -> None:
    """changed tracking: a new vertex is "changed" if it is not
    identical (same edge membership) to an old unchanged vertex."""
    old_vid = graph.vid
    old_len = graph.length
    new_first_old = np.where(
        g2.start >= 0, old_vid[g2.start], NULL
    )
    same = (new_first_old >= 0) & (
        old_len[np.maximum(new_first_old, 0)] == g2.length
    )
    # also verify the end edge belonged to the same old vertex
    same &= old_vid[g2.end] == new_first_old
    prev_changed = np.zeros(g2.size, dtype=bool)
    if graph.changed.any():
        ok = new_first_old >= 0
        prev_changed[ok] = graph.changed[new_first_old[ok]]
    if set_changed:
        g2.changed = (~same) | prev_changed
    else:
        g2.changed = same & prev_changed


def refresh(graph: UnitigGraph, set_changed: bool = False) -> UnitigGraph:
    """Apply to_delete / to_disconnect marks to the underlying SdBG and
    rebuild the unitig graph (reference UnitigGraph::Refresh,
    unitig_graph.cpp:210-355).

    MUTATES `graph` in place (slot-space): deleted and
    merged-away vertices stay in their slots with alive=False; merged
    chains are rewritten into the slot the reference's claim order
    would assign. The returned object is the same graph. No per-edge
    remap ever runs - vid/chain arrays update only at the edges of
    changed chains.

    The update is CONTRACTED: surviving old chains become super-edges
    and the pointer-doubling ranking runs over them (O(V log V) host
    numpy) instead of over all edges (O(E log E) rounds) - the
    reference's touch-only-marked-vertices Refresh re-expressed
    deterministically. Falls back to the full edge-level rebuild
    (dense rows, all alive) for the rare shapes the contraction does
    not model (disconnects on palindromes/loops).
    """
    s = graph.sdbg
    if not (graph.to_delete.any() or graph.to_disconnect_fwd.any()
            or graph.to_disconnect_rc.any()):
        # nothing marked: the rebuild would reproduce this graph
        # exactly (and `changed` is already correct for both modes) -
        # skip the rebuild
        return graph
    delete, disc_fwd, disc_rc = _classify_marks(graph)
    if ((disc_fwd | disc_rc)
            & (graph.is_palindrome | graph.is_loop)).any():
        return _refresh_full(graph, delete, disc_fwd, disc_rc,
                             set_changed)
    return _refresh_contracted(graph, delete, disc_fwd, disc_rc,
                               set_changed)


def _refresh_full(graph, delete, disc_fwd, disc_rc,
                  set_changed: bool) -> UnitigGraph:
    """Full edge-level rebuild (fallback path), then reorder/reorient
    to the reference Refresh's stable slot semantics."""
    s = graph.sdbg
    kill_idx = _kill_edge_indices(graph, delete, disc_fwd, disc_rc)
    if len(kill_idx):
        s.invalidate_idx(kill_idx)
    g2 = build_unitig_graph(s)
    g2 = _reference_order(graph, g2, disc_fwd, disc_rc)
    _propagate_changed(graph, g2, set_changed)
    return g2


def _reference_order(graph, g2, disc_fwd, disc_rc):
    """Reorder + reorient a freshly rebuilt graph to the reference
    Refresh's STABLE slot semantics (unitig_graph.cpp:210-355 at -t 1,
    see _refresh_contracted): a merged chain claims the slot of its
    min-old-slot end vertex oriented so that vertex is the head; a
    cycle claims its min-old-slot member's slot, oriented along that
    member's stored strand and anchored at its begin edge. The rank
    order build_unitig_graph produces only matches the reference for
    the FIRST construction; every later rebuild must be slot-stable."""
    nv = g2.size
    if nv == 0 or graph.vid is None:
        return g2
    s = graph.sdbg
    old_vid = graph.vid.astype(np.int64)
    # stored-orientation start edge per old vertex, disconnect-adjusted
    adj_start = graph.start.astype(np.int64).copy()
    df = np.flatnonzero(disc_fwd)
    if len(df):
        adj_start[df] = graph.nxt[graph.start[df]]

    rep_slot = np.empty(nv, np.int64)
    flip = np.zeros(nv, bool)
    new_start = g2.start.astype(np.int64).copy()
    new_end = g2.end.astype(np.int64).copy()

    ch = ~g2.is_loop
    h = old_vid[g2.start]
    t = old_vid[g2.rc_start]
    keep_asis = (h < t) | (
        (h == t) & (g2.start.astype(np.int64)
                    == adj_start[np.maximum(h, 0)])
    )
    flip[ch] = ~keep_asis[ch]
    rep_slot[ch] = np.minimum(h, t)[ch]

    loops = np.flatnonzero(g2.is_loop)
    if len(loops):
        ok = (g2.vid >= 0) & s.valid
        mslot = np.full(nv, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(mslot, g2.vid[ok], old_vid[ok])
        rep_slot[loops] = mslot[loops]
        s0 = adj_start[mslot[loops]]
        aend = g2.prv[s0].astype(np.int64)
        new_start[loops] = s0
        new_end[loops] = aend

    f = np.flatnonzero(flip)
    if len(f):
        ns, ne = g2.rc_start[f].astype(np.int64), \
            g2.rc_end[f].astype(np.int64)
        new_start[f], new_end[f] = ns, ne

    perm = np.argsort(rep_slot, kind="stable")
    inv = np.empty(nv, dtype=np.int32)
    inv[perm] = np.arange(nv, dtype=np.int32)
    vid_new = g2.vid.copy()
    okv = vid_new >= 0
    vid_new[okv] = inv[vid_new[okv]]
    return UnitigGraph(
        g2.k, s,
        new_start[perm].astype(np.int32),
        new_end[perm].astype(np.int32),
        s.rc[new_end[perm]].astype(np.int32),
        s.rc[new_start[perm]].astype(np.int32),
        g2.length[perm], g2.total_depth[perm],
        g2.is_loop[perm], g2.is_palindrome[perm],
        vid_new,
        chain_start=g2.chain_start, edge_pos=g2.edge_pos,
        nxt=g2.nxt, prv=g2.prv,
    )


def _refresh_contracted(graph, delete, disc_fwd, disc_rc,
                        set_changed: bool) -> UnitigGraph:
    """Chain-contracted refresh.

    Surviving old chains (with disconnect-adjusted terminals) become
    super-edges; simple-path links can only change at chain terminals
    (interior nodes have degree (1,1) by definition), so ranking the
    super-edge graph and expanding back to edge-level arrays gives
    exactly the graph a full rebuild would produce - including the
    full rebuild's canonical orientation (smaller start-edge id) and
    vertex order (ascending start-edge id) so downstream tie-breaks
    are unchanged.
    """
    s = graph.sdbg
    kill_idx = _kill_edge_indices(graph, delete, disc_fwd, disc_rc)
    if len(kill_idx):
        s.invalidate_idx(kill_idx)

    live_chain = graph.alive & (~delete) & ~graph.is_loop
    lv = np.flatnonzero(live_chain)
    n_l = len(lv)

    # --- super-edges: adjusted terminals, weighted length/depth
    dfw = disc_fwd[lv]
    drc = disc_rc[lv]
    old_start = graph.start[lv]
    old_end = graph.end[lv]
    new_start = old_start.copy()
    new_end = old_end.copy()
    if dfw.any():
        new_start[dfw] = graph.nxt[old_start[dfw]]
    if drc.any():
        new_end[drc] = graph.prv[old_end[drc]]
    se_len_v = (graph.length[lv] - dfw - drc).astype(np.int64)
    dep_v = graph.total_depth[lv].astype(np.int64) \
        - np.where(dfw, s.mult[old_start], 0) \
        - np.where(drc, s.mult[old_end], 0)

    pal = graph.is_palindrome[lv]
    npal = np.flatnonzero(~pal)
    m = n_l + len(npal)
    se_start = np.concatenate([new_start, s.rc[new_end[npal]]])
    se_end = np.concatenate([new_end, s.rc[new_start[npal]]])
    se_rc = np.arange(m, dtype=np.int64)
    se_rc[npal] = n_l + np.arange(len(npal))
    se_rc[n_l:] = npal
    se_len = np.concatenate([se_len_v, se_len_v[npal]])
    se_dep = np.concatenate([dep_v, dep_v[npal]])
    se_shift = np.concatenate([dfw, drc[npal]]).astype(np.int64)

    # --- super-edge links: unique simple-path successor at terminal
    # edges under the new validity (the node between two chains has
    # degree (1,1) iff both the out- and in- side are unique)
    if m:
        from .sdbg import cands_at

        oc = cands_at(s, se_end, "oc_t")          # (M, 4)
        oc_ok = (oc >= 0) & s.valid[np.maximum(oc, 0)]
        ic = cands_at(s, se_end, "ic_t")
        ic_ok = (ic >= 0) & s.valid[np.maximum(ic, 0)]
        uniq = (oc_ok.sum(1) == 1) & (ic_ok.sum(1) == 1)
        f = np.where(uniq,
                     np.where(oc_ok, oc, -1).max(1), -1)
        # successor edge -> owning se, via a sorted M-sized join (an
        # E-sized lookup table here cost more than the whole rest of
        # the refresh)
        so = np.argsort(se_start)
        ss = se_start[so]
        pos = np.searchsorted(ss, np.maximum(f, 0))
        posc = np.minimum(pos, m - 1)
        hit = (f >= 0) & (ss[posc] == f)
        nxt_se = np.where(hit, so[posc], -1)
        # a unique successor must be some live chain's start
        assert not (uniq & (nxt_se < 0)).any(), \
            "contracted refresh: dangling simple-path link"
        prv_se = np.full(m, -1, dtype=np.int64)
        has = nxt_se >= 0
        prv_se[nxt_se[has]] = np.flatnonzero(has)
    else:
        nxt_se = prv_se = np.zeros(0, dtype=np.int64)

    # --- rank the super-edge graph: native O(M) walk (at M = 0 it
    # returns empty arrays)
    idx = np.arange(m, dtype=np.int64)
    from ..native import chain_rank

    cs32, ce32, pos32, in_cycle = chain_rank(
        nxt_se.astype(np.int32), prv_se.astype(np.int32),
        np.ones(m, dtype=bool))
    chain_of = cs32.astype(np.int64)
    chain_end = ce32.astype(np.int64)
    # cycle positions are all equal (ties break by stable index order
    # downstream)
    pos_se = np.where(in_cycle, 0, pos32).astype(np.int64)
    is_rep = chain_of == idx
    rep = np.flatnonzero(is_rep)
    len_per = np.bincount(chain_of, weights=se_len, minlength=max(m, 1)
                          ).astype(np.int64)
    dep_per = np.bincount(chain_of, weights=se_dep, minlength=max(m, 1)
                          ).astype(np.int64)

    c_first = rep
    c_last = chain_end[rep]
    c_loop = in_cycle[rep]
    pair_first = chain_of[se_rc[c_last]]

    # reference Refresh ordering/orientation (unitig_graph.cpp:210-355,
    # sequential -t 1 semantics): a merged chain takes the SLOT of its
    # min-old-slot END vertex, oriented so that vertex is the head
    # (claim loop scans slots ascending, strand 0 then 1); a NEW cycle
    # takes the slot of its min-old-slot member, oriented along that
    # member's STORED strand and anchored at its begin edge; the vertex
    # vector is then compacted STABLY (std::remove_if) - survivors keep
    # relative slot order, loops interleaved, NOT re-canonicalized.
    oldslot_se = np.concatenate([lv, lv[npal]]).astype(np.int64)
    if m:
        h_slot = oldslot_se[c_first]
        t_slot = oldslot_se[chain_end[rep]]
        anchor_start = se_start[c_first].astype(np.int64)
        anchor_end = se_end[chain_end[rep]].astype(np.int64)
    else:
        h_slot = t_slot = rep.astype(np.int64)
        anchor_start = anchor_end = rep.astype(np.int64)
    # orientation: head end with the smaller old slot claims; single-
    # vertex chains (h == t) keep their stored orientation (the claim
    # loop tries strand 0 first and linear_path is empty)
    keep = (h_slot < t_slot) | ((h_slot == t_slot) & (c_first < n_l))
    keep |= pair_first == c_first  # palindromic chains appear once
    rep_slot = np.minimum(h_slot, t_slot)
    if m and in_cycle.any():
        # per NEW cycle: min old slot over member super-edges; the
        # kept orientation is the cycle CONTAINING that member's
        # forward (stored-strand) super-edge
        ms = np.full(m, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(ms, chain_of, oldslot_se)
        cyc = in_cycle[rep]
        fwd_se_of_slot = np.full(graph.size, -1, dtype=np.int64)
        fwd_se_of_slot[lv] = np.arange(n_l)
        s_star = np.where(
            cyc, fwd_se_of_slot[np.minimum(ms[rep], graph.size - 1)], 0
        )
        keep = np.where(cyc, chain_of[s_star] == rep, keep)
        rep_slot = np.where(cyc, ms[rep], rep_slot)
        # anchor start = that member's begin edge; end = its cycle
        # predecessor's last edge (reference: b() / PrevSimplePath)
        anchor_start = np.where(cyc, se_start[s_star], anchor_start)
        anchor_end = np.where(
            cyc, se_end[prv_se[s_star]], anchor_end
        )

    v_first = c_first[keep]
    v_pairf = pair_first[keep]
    v_loop = c_loop[keep]
    slots = rep_slot[keep]
    v_start = anchor_start[keep].astype(np.int32)
    v_end = anchor_end[keep].astype(np.int32)
    nv = len(v_first)

    # slot id per super-edge's chain (both orientations map to the
    # claimed vertex SLOT)
    slot_of_chain = np.full(max(m, 1), NULL, dtype=np.int64)
    slot_of_chain[v_first] = slots
    slot_of_chain[v_pairf] = slots

    # weighted offset of each super-edge within its new chain
    offs = np.zeros(m, dtype=np.int64)
    if m:
        so = np.lexsort((pos_se, chain_of))
        grp = chain_of[so]
        csum = np.cumsum(se_len[so]) - se_len[so]
        first_in_grp = np.empty(len(so), dtype=bool)
        first_in_grp[0] = True
        np.not_equal(grp[1:], grp[:-1], out=first_in_grp[1:])
        grp_base = np.maximum.accumulate(
            np.where(first_in_grp, csum, -1)
        )
        offs[so] = csum - grp_base

    grp_sz = np.bincount(chain_of, minlength=max(m, 1))
    changed_se = (grp_sz[chain_of] > 1) | (se_shift > 0) | in_cycle \
        if m else np.zeros(0, bool)
    # a VERTEX changed iff merged/cycled or EITHER strand was
    # disconnect-shifted (the rc-strand shift changes the vertex's
    # length but not this strand's se bookkeeping)
    if m:
        shift_any = (disc_fwd | disc_rc)[oldslot_se]
        ch_chain = ((grp_sz[chain_of] > 1) | in_cycle
                    | shift_any)[v_first]
    else:
        ch_chain = np.zeros(0, bool)

    # changed edges: on the host route, walk only the changed chains
    # natively (own-strand exact); on the card's, the full-edge scan +
    # strand resolution
    se_ce = None
    if not devices.graph_on_card(s.device) and m:
        from ..native import collect_chain_edges

        sef = np.flatnonzero(changed_se[:n_l])
        ser = n_l + np.flatnonzero(changed_se[n_l:])
        rows_f = lv[sef]
        rows_r = lv[npal][ser - n_l]
        cef = collect_chain_edges(
            graph.nxt, graph.start[rows_f], graph.length[rows_f])
        cer = collect_chain_edges(
            graph.nxt, graph.rc_start[rows_r], graph.length[rows_r])
        ce0 = np.concatenate([cef, cer]).astype(np.int64)
        se0 = np.concatenate([
            np.repeat(sef, graph.length[rows_f]),
            np.repeat(ser, graph.length[rows_r]),
        ])
        keepv = s.valid[ce0]
        ce, se_ce = ce0[keepv], se0[keepv]
    else:
        chfw = np.zeros(graph.size, dtype=bool)
        chrc = np.zeros(graph.size, dtype=bool)
        if m:
            chfw[lv] = changed_se[:n_l]
            chrc[lv[npal]] = changed_se[n_l:]
        ov = graph.vid
        safe = np.maximum(ov, 0)
        okv = (ov >= 0) & s.valid
        # either-strand superset of the per-strand flag; the strand is
        # resolved sparsely on ce below
        ch_row = chfw | chrc
        ce = np.flatnonzero(ch_row[safe] & okv)

    # per-edge arrays are updated IN PLACE (slot-space refresh mutates
    # and returns the SAME graph); take ownership of read-only views
    # once.

    def _own(a):
        return a if a.flags.writeable else a.copy()

    chain_start_new = graph.chain_start = _own(graph.chain_start)
    edge_pos_new = graph.edge_pos = _own(graph.edge_pos)
    if se_ce is None and len(ce):
        rows_ce = graph.vid[ce].astype(np.int64)
        is_fwd_ce = chain_start_new[ce] == graph.start[rows_ce]
        fwd_se_row = np.full(graph.size, -1, dtype=np.int64)
        rc_se_row = np.full(graph.size, -1, dtype=np.int64)
        fwd_se_row[lv] = np.arange(n_l)
        rc_se_row[lv[npal]] = n_l + np.arange(len(npal))
        se_ce0 = np.where(is_fwd_ce, fwd_se_row[rows_ce],
                          rc_se_row[rows_ce])
        # either-strand superset: keep only rows whose OWN strand se
        # actually changed
        own = changed_se[se_ce0]
        ce, se_ce = ce[own], se_ce0[own]
    if se_ce is not None and len(ce):
        # vid: ce covers exactly the edges whose chain membership can
        # change - one SPARSE scatter replaces the old full-edge remap
        vid_new = graph.vid = _own(graph.vid)
        vid_new[ce] = slot_of_chain[chain_of[se_ce]].astype(np.int32)
        chain_start_new[ce] = se_start[chain_of[se_ce]].astype(np.int32)
        edge_pos_new[ce] = (offs[se_ce] + graph.edge_pos[ce]
                            - se_shift[se_ce]).astype(np.int32)

    # --- repair simple-path links at junctions and cut ends (also
    # in place; see note above)
    nxt_new = graph.nxt = _own(graph.nxt)
    prv_new = graph.prv = _own(graph.prv)
    if dfw.any():
        prv_new[new_start[dfw]] = NULL
    if drc.any():
        nxt_new[new_end[drc]] = NULL
    if m:
        has = nxt_se >= 0
        nxt_new[se_end[has]] = se_start[nxt_se[has]].astype(np.int32)
        prv_new[se_start[nxt_se[has]]] = se_end[has].astype(np.int32)
        no = ~has
        nxt_new[se_end[no]] = NULL
        prv_new[se_start[np.flatnonzero(prv_se < 0)]] = NULL

    # --- in-place slot updates: old chain slots die, claimed rep
    # slots are rewritten; carried loops and unchanged chains keep
    # their slots (and their `changed` flags) untouched
    alive_new = graph.alive
    alive_new[lv] = False
    alive_new[delete] = False
    alive_new[slots] = True
    graph.start[slots] = v_start
    graph.end[slots] = v_end
    graph.rc_start[slots] = s.rc[v_end]
    graph.rc_end[slots] = s.rc[v_start]
    graph.length[slots] = len_per[v_first].astype(np.int32)
    graph.total_depth[slots] = dep_per[v_first]
    graph.is_loop[slots] = v_loop
    graph.is_palindrome[slots] = v_first == v_pairf
    # reference changed semantics (_propagate_changed): an untouched
    # chain keeps its flag; a merged/cycled chain is "new" - flagged
    # per set_changed mode
    graph.changed[slots[ch_chain]] = set_changed

    # NEW cycles: re-anchor members' chain_start at the anchor (end)
    # edge (start == nxt_new[end] by construction)
    if v_loop.any() and se_ce is not None and len(ce):
        is_new_loop_slot = np.zeros(graph.size, dtype=bool)
        is_new_loop_slot[slots[v_loop]] = True
        vce = graph.vid[ce]
        sel = is_new_loop_slot[np.maximum(vce, 0)] & (vce >= 0)
        chain_start_new[ce[sel]] = graph.end[vce[sel]]

    # reset marks for the next pass (the old API returned a fresh
    # graph with zeroed marks)
    graph.to_delete[:] = False
    graph.to_disconnect_fwd[:] = False
    graph.to_disconnect_rc[:] = False
    # amortized compaction: once under half the slots are alive, pay
    # one order-preserving remap so the per-pass V-sized cleaning work
    # tracks the live vertex count (geometric, so the total remap cost
    # is ~2 full passes instead of one per refresh)
    if graph.alive.sum() * 2 < graph.size:
        _compact(graph)
    return graph


def _compact(graph: UnitigGraph) -> UnitigGraph:
    """Compact alive slots to dense rows IN ORDER (ascending slots ==
    the reference's stable compaction, so every row-order tie-break is
    unchanged). One full-edge vid gather - only at compaction."""
    alive_rows = np.flatnonzero(graph.alive)
    remap = np.full(graph.size, NULL, np.int32)
    remap[alive_rows] = np.arange(len(alive_rows), dtype=np.int32)
    for f in ("start", "end", "rc_start", "rc_end", "length",
              "total_depth", "is_loop", "is_palindrome", "changed",
              "to_delete", "to_disconnect_fwd", "to_disconnect_rc"):
        setattr(graph, f, getattr(graph, f)[alive_rows])
    ok = (graph.vid >= 0) & graph.sdbg.valid
    graph.vid = np.where(
        ok, remap[np.maximum(graph.vid, 0)], NULL
    ).astype(np.int32)
    graph.alive = np.ones(len(alive_rows), dtype=bool)
    return graph
