"""Unitig-graph cleaning: tips, bubbles, weak links, low-depth pruning.

Vectorized re-expressions of reference src/assembly/{tip_remover,
bubble_remover, weak_link_remover, low_depth_remover}.cpp. The unitig
graph after collapse is orders of magnitude smaller than the edge graph,
so these run as host numpy frontier passes over (V, 2, 4) neighbour
tables; every pass ends in a full deterministic rebuild (refresh) of the
unitig graph from the updated SdBG validity mask.

The reference's racy `is_changed` shortcut in RemoveLocalLowDepth
(low_depth_remover.cpp:61-66) is replaced by a deterministic two-phase
evaluation with the same fixpoint.
"""

from __future__ import annotations

import numpy as np

from ..core import packing
from ..utils.log import get_logger
from .counter import KMAX_MUL
from .output import unitig_codes
from .sdbg import Sdbg
from .unitig import UnitigGraph, refresh


# ---------------------------------------------------------------------------
# depth inference (reference sdbg_pruning.cpp:36-59 + utils/histgram.h)
# ---------------------------------------------------------------------------


def first_local_minimum(values: np.ndarray, counts: np.ndarray) -> int:
    """Reference Histgram::FirstLocalMinimum (histgram.h:143-156):
    running minimum over increasing keys, stop after 4 rises."""
    if len(values) == 0:
        return 0
    smoothing = 4
    order = np.argsort(values)
    v, c = values[order], counts[order]
    min_i, rises = 0, 0
    for i in range(len(v)):
        if c[i] <= c[min_i]:
            min_i, rises = i, 0
        else:
            rises += 1
            if rises >= smoothing:
                break
    if v[min_i] == v[-1]:
        return 0
    return int(v[min_i])


def _median_from_hist(values, counts):
    total = counts.sum()
    cum = np.cumsum(counts)
    return values[np.searchsorted(cum, (total + 1) // 2)]


def infer_min_depth(sdbg: Sdbg) -> float:
    """Reference sdbg_pruning::InferMinDepth."""
    mult = sdbg.mult[sdbg.valid]
    if len(mult) == 0:
        return 1.0
    values, counts = np.unique(mult, return_counts=True)
    cov = float(first_local_minimum(values, counts))
    v, c = values, counts
    for _ in range(100):
        keep = v >= np.round(cov)  # TrimLow
        v, c = v[keep], c[keep]
        if len(v) == 0:
            return 1.0
        cov1 = float(np.sqrt(_median_from_hist(v, c)))
        if abs(cov - cov1) < 1e-2:
            return cov
        cov = cov1
    get_logger().warning("Cannot detect min depth: unconverged")
    return 1.0


# ---------------------------------------------------------------------------
# neighbour tables
# ---------------------------------------------------------------------------


class NbrTables:
    """(V, 2, 4) successor tables: for each vertex and traversal strand,
    the up-to-4 successor vertices, their entry strands, and presence."""

    def __init__(self, g: UnitigGraph):
        nbr0, str0, pre0 = g.next_vertices(0)
        nbr1, str1, pre1 = g.next_vertices(1)
        self.nbr = np.stack([nbr0, nbr1], axis=1)  # (V,2,4)
        self.strand = np.stack([str0, str1], axis=1)
        self.present = np.stack([pre0, pre1], axis=1)
        self.outdeg = self.present.sum(-1)  # (V,2)

    def indeg(self, strand):
        return self.outdeg[:, 1 - strand]


# ---------------------------------------------------------------------------
# tips (reference tip_remover.cpp:8-53)
# ---------------------------------------------------------------------------


def remove_tips(g: UnitigGraph, max_tip_len: int) -> tuple[UnitigGraph, int]:
    num_removed = 0
    thre = 2
    while thre < max_tip_len:
        t = NbrTables(g)
        ind, outd = t.outdeg[:, 1], t.outdeg[:, 0]
        short = (g.length < thre) & g.alive
        avg = g.avg_depth()

        delete = short & g.is_standalone()
        delete |= short & ~g.is_loop & (ind + outd == 0)

        for strand in (0, 1):
            one_out = short & ~g.is_loop & (t.outdeg[:, strand] == 1) & (
                t.outdeg[:, 1 - strand] == 0
            )
            nb = t.nbr[:, strand, :]
            sel = np.where(t.present[:, strand, :], nb, -1).max(-1)
            ok = one_out & (sel >= 0)
            nb_avg = np.where(ok, avg[np.maximum(sel, 0)], 0)
            delete |= ok & (nb_avg > 8 * avg)

        g.to_delete |= delete
        num_removed += int(delete.sum())
        g = refresh(g, set_changed=False)
        thre = min(thre * 2, max_tip_len)
        if thre >= max_tip_len:
            break
    return g, num_removed


# ---------------------------------------------------------------------------
# bubbles (reference bubble_remover.cpp)
# ---------------------------------------------------------------------------


def _banded_similarity(a: str, b: str, min_similarity: float) -> float:
    """Banded edit-distance similarity (reference GetSimilarity,
    bubble_remover.cpp:10-54)."""
    n, m = len(a), len(b)
    max_indel = int(max(n, m) * (1 - min_similarity))
    if abs(n - m) > max_indel or max_indel < 1:
        return 0.0
    width = 2 * max_indel + 1
    big = 0x3F3F3F3F
    prev = np.full(width, big, dtype=np.int64)
    # dp[j - i + max_indel] at row i
    for j in range(0, max_indel + 1):
        prev[j + max_indel] = j
    for i in range(1, n + 1):
        cur = np.full(width, big, dtype=np.int64)
        if i - max_indel <= 0:
            cur[0 - i + max_indel] = i
        jlo = max(i - max_indel, 1)
        jhi = min(m, i + max_indel)
        for j in range(jlo, jhi + 1):
            idx = j - i + max_indel
            best = prev[idx] + (a[i - 1] != b[j - 1])  # diag (j-1, i-1)
            if j > i - max_indel:
                best = min(best, cur[idx - 1] + 1)
            if j < i + max_indel:
                best = min(best, prev[idx + 1] + 1)
            cur[idx] = best
        prev = cur
    return 1 - prev[m - n + max_indel] * 1.0 / max(n, m)


def banded_similarity_batch(
    a_codes: list, b_codes: list, min_similarity: float
) -> np.ndarray:
    """Reference banded edit-distance similarity (GetSimilarity,
    bubble_remover.cpp:10-54) for a BATCH of pairs: vectorized across
    pairs and across the band; the in-row left-neighbour chain
    cur[i] = min(nodep[i], cur[i-1]+1) becomes a prefix-min of
    (nodep[i] - i) plus i. Bit-identical to _banded_similarity."""
    p = len(a_codes)
    if p == 0:
        return np.zeros(0)
    n = np.array([len(a) for a in a_codes], np.int64)
    m = np.array([len(b) for b in b_codes], np.int64)
    mx = np.maximum(n, m)
    mi = (mx * (1 - min_similarity)).astype(np.int64)
    reject = (np.abs(n - m) > mi) | (mi < 1)
    lmax = int(max(n.max(), m.max()))
    a_mat = np.zeros((p, lmax), np.uint8)
    b_mat = np.zeros((p, lmax), np.uint8)
    for i, (a, b) in enumerate(zip(a_codes, b_codes)):
        a_mat[i, : len(a)] = a
        b_mat[i, : len(b)] = b

    big = 0x3F3F3F3F
    width = int(2 * mi.max() + 1)
    col = np.arange(width, dtype=np.int64)[None, :]  # idx axis
    mi2 = mi[:, None]
    prev = np.where(
        (col >= mi2) & (col <= 2 * mi2), col - mi2, big
    ).astype(np.int64)

    alive_rows = int(n.max())
    for i in range(1, alive_rows + 1):
        j = col + i - mi2  # text position at this band column
        jlo = np.maximum(i - mi, 1)[:, None]
        jhi = np.minimum(m, i + mi)[:, None]
        valid = (j >= jlo) & (j <= jhi) & (col <= 2 * mi2)
        sub = (
            a_mat[:, i - 1][:, None]
            != np.take_along_axis(
                b_mat, np.clip(j - 1, 0, lmax - 1).astype(np.int64),
                axis=1,
            )
        ).astype(np.int64)
        diag = prev + sub
        up = np.concatenate(
            [prev[:, 1:], np.full((p, 1), big, np.int64)], axis=1
        ) + 1
        up = np.where(j < i + mi2, up, big)
        nodep = np.where(valid, np.minimum(diag, up), big)
        # j == 0 boundary cell: cur[mi - i] = i when i <= mi
        bcol = mi2 - i
        nodep = np.where((col == bcol) & (i <= mi2),
                         np.minimum(nodep, i), nodep)
        t = nodep - col
        cur = col + np.minimum.accumulate(t, axis=1)
        cur = np.where(valid | ((col == bcol) & (i <= mi2)), cur, big)
        prev = np.where(i <= n[:, None], cur, prev)

    res_col = np.clip(m - n + mi, 0, width - 1)
    ed = np.take_along_axis(prev, res_col[:, None], axis=1)[:, 0]
    sim = 1 - ed / np.maximum(mx, 1)
    return np.where(reject, 0.0, sim)


def _find_bubble_instances(g, t, max_len):
    """Vectorized bubble-shape filter over ALL (vertex, strand) pairs.

    Returns per-instance arrays (left, lstrand, right, rstrand,
    mids (I,4), mstrands (I,4), present (I,4)) sorted by (left,
    lstrand) - the reference's scan order. The filter reads only
    pre-pass state, so batching is exact."""
    standalone = g.is_standalone()
    base = (t.outdeg > 1).any(axis=1) & ~g.is_loop & ~standalone & g.alive
    out = []
    for strand in (0, 1):
        degree = t.outdeg[:, strand]
        active = base & (degree > 1)
        mids = t.nbr[:, strand]          # (V, 4)
        mstr = t.strand[:, strand]
        pres = t.present[:, strand]
        safe = np.maximum(mids, 0)
        # middles short enough
        ok = active & ~(pres & (g.length[safe] > max_len)).any(axis=1)
        # every middle has in/out degree exactly 1 (on its strand)
        od_fwd = np.take_along_axis(t.outdeg[safe], mstr[..., None],
                                    axis=2)[..., 0]
        od_rev = np.take_along_axis(t.outdeg[safe],
                                    (1 - mstr)[..., None], axis=2)[..., 0]
        ok &= ~(pres & ((od_fwd != 1) | (od_rev != 1))).any(axis=1)

        # unique right of each middle (reference takes max over the
        # raw candidate row; absents are -1 so the single present
        # entry wins)
        r_nbr = np.take_along_axis(
            t.nbr[safe], mstr[..., None, None].repeat(4, -1), axis=2
        )[:, :, 0, :]                    # (V, 4, 4)
        r_str = np.take_along_axis(
            t.strand[safe], mstr[..., None, None].repeat(4, -1), axis=2
        )[:, :, 0, :]
        rv = r_nbr.max(-1)               # (V, 4)
        rs = np.take_along_axis(
            r_str, r_nbr.argmax(-1)[..., None], axis=-1
        )[..., 0]
        # all present middles agree on (right, rstrand)
        first_slot = pres.argmax(axis=1)
        rv0 = np.take_along_axis(rv, first_slot[:, None], 1)[:, 0]
        rs0 = np.take_along_axis(rs, first_slot[:, None], 1)[:, 0]
        ok &= ~(pres & ((rv != rv0[:, None]) | (rs != rs0[:, None]))
                ).any(axis=1)
        # right's canonical EDGE id >= left's (the reference's
        # double-processing guard compares canonical_id = min begin
        # edge id, bubble_remover.cpp:85-87, NOT vertex indices) and
        # right's reverse degree == bubble degree
        rr = g.sdbg.ref_rank
        cid = np.minimum(rr[g.start], rr[g.rc_start]).astype(np.int64)
        safe_r = np.maximum(rv0, 0)
        r_deg = np.take_along_axis(
            t.outdeg[safe_r], (1 - rs0)[:, None], 1
        )[:, 0]
        ok &= (rv0 >= 0) & (cid[safe_r] >= cid) & (r_deg == degree)

        lefts = np.flatnonzero(ok)
        out.append((lefts, np.full(len(lefts), strand), rv0[lefts],
                    rs0[lefts], mids[lefts], mstr[lefts], pres[lefts]))
    # merge strands in (left, strand) order
    lefts = np.concatenate([out[0][0], out[1][0]])
    order = np.lexsort((np.concatenate([out[0][1], out[1][1]]), lefts))
    cat = [np.concatenate([a, b], axis=0)[order]
           for a, b in zip(out[0], out[1])]
    return cat


def pop_bubbles(
    g: UnitigGraph,
    max_len: int,
    permanent: bool,
    similarity: float | None = None,
    careful_threshold: float | None = None,
    bubble_records: list | None = None,
) -> tuple[UnitigGraph, int]:
    """One bubble-popping pass over all vertices and strands.

    Bubble shape (reference SearchAndPopBubble, bubble_remover.cpp:58-152):
    left -> {middle_j} -> right where every middle has in/out degree 1,
    length <= max_len; keep the deepest middle, delete the rest.
    similarity: if set, complex-bubble checker (length-similar + banded
    edit similarity >= similarity).
    careful_threshold: if set, record removed branches with depth >=
    threshold * kept depth into bubble_records (the .bubble_seq.fa list).

    The shape filter and the edit-distance checks are batched (they
    read only pre-pass state); only deletion marking and record
    emission run sequentially, preserving the reference's scan order.
    """
    t = NbrTables(g)
    avg = g.avg_depth()
    num_removed = 0
    strings_cache: dict[int, str] = {}

    def vstring(v: int, strand: int) -> str:
        if v not in strings_cache:
            strings_cache[v] = packing.decode(unitig_codes(g, [v])[v])
        s = strings_cache[v]
        if strand == 1:
            s = packing.decode(
                packing.revcomp_codes(packing.encode(s))
            )
        return s

    clen = g.contig_len()
    lefts, lstrands, rights, rstrands, mids, mstrs, press = \
        _find_bubble_instances(g, t, max_len)

    if len(lefts) == 0:
        g = refresh(g, set_changed=not permanent)
        return g, 0

    # sort middles of every instance by (avg depth desc, canonical
    # EDGE id asc) - the reference tie-break is canonical_id = min
    # begin edge id (bubble_remover.cpp:96-101), not the vertex index
    rr = g.sdbg.ref_rank
    cid = np.minimum(rr[g.start], rr[g.rc_start]).astype(np.int64)
    safe = np.maximum(mids, 0)
    avgm = np.where(press, avg[safe], -np.inf)
    midv = np.where(press, cid[safe], np.iinfo(np.int64).max)
    order = np.lexsort((midv, -avgm), axis=1)
    mids = np.take_along_axis(mids, order, 1)
    mstrs = np.take_along_axis(mstrs, order, 1)
    press = np.take_along_axis(press, order, 1)
    keeps = mids[:, 0]

    if len(lefts) and (similarity is not None
                       or careful_threshold is not None):
        # batch-reconstruct every string the pass could need
        used = np.unique(np.concatenate([
            lefts, rights, mids[press],
        ]))
        for v, codes in unitig_codes(g, used).items():
            strings_cache[v] = packing.decode(codes)

    # batched similarity: all (keep, other-middle) pairs at once
    sim_ok_inst = np.ones(len(lefts), dtype=bool)
    if similarity is not None:
        pair_i, pair_a, pair_b = [], [], []
        for i in range(len(lefts)):
            a_len = clen[keeps[i]]
            for j in range(1, 4):
                if not press[i, j]:
                    continue
                v = mids[i, j]
                b_len = clen[v]
                if not (b_len * similarity <= a_len
                        and a_len * similarity <= b_len):
                    sim_ok_inst[i] = False
                    break
                pair_i.append(i)
                pair_a.append(packing.encode(
                    vstring(int(keeps[i]), int(mstrs[i, 0]))
                ))
                pair_b.append(packing.encode(
                    vstring(int(v), int(mstrs[i, j]))
                ))
        if pair_i:
            sims = banded_similarity_batch(pair_a, pair_b, similarity)
            bad = sims < similarity
            for idx, i in enumerate(pair_i):
                if bad[idx]:
                    sim_ok_inst[i] = False

    # sequential marking in scan order (exact double-delete / record
    # semantics of the reference loop). Records are emitted in the
    # CANONICAL strand (VertexToDNAString -> ToUniqueFormat, smaller
    # begin edge id), and are written even when the branch was already
    # deleted by an earlier bubble (SetToDelete failure still records,
    # bubble_remover.cpp:111-123).
    flip = rr[g.rc_start] < rr[g.start]

    def cstring(v: int) -> str:
        return vstring(v, 1 if flip[v] else 0)

    for i in range(len(lefts)):
        if not sim_ok_inst[i]:
            continue
        keep_v = int(keeps[i])
        careful_any = False
        for j in range(1, 4):
            if not press[i, j]:
                continue
            v = int(mids[i, j])
            if not g.to_delete[v]:
                g.to_delete[v] = True
                num_removed += 1
            if (careful_threshold is not None
                    and bubble_records is not None
                    and avg[v] >= avg[keep_v] * careful_threshold):
                bubble_records.append((cstring(v), float(avg[v])))
                careful_any = True
        if careful_any:
            bubble_records.append(
                (cstring(int(lefts[i])), float(avg[lefts[i]]))
            )
            bubble_records.append(
                (cstring(int(rights[i])), float(avg[rights[i]]))
            )
    g = refresh(g, set_changed=not permanent)
    return g, num_removed


def pop_complex_bubbles(
    g: UnitigGraph,
    merge_level: int,
    similarity: float,
    permanent: bool,
    careful_threshold: float | None = None,
    bubble_records: list | None = None,
) -> tuple[UnitigGraph, int]:
    """Reference ComplexBubbleRemover::PopBubbles
    (bubble_remover.cpp:154-170). Uses the megahit-level k = edge
    length - 1."""
    max_len = int(round(merge_level * (g.k - 1) / similarity))
    if max_len * (1 - similarity) < 1:
        return g, 0
    return pop_bubbles(
        g, max_len, permanent, similarity=similarity,
        careful_threshold=careful_threshold, bubble_records=bubble_records,
    )


# ---------------------------------------------------------------------------
# weak links (reference weak_link_remover.cpp:8-37)
# ---------------------------------------------------------------------------


def disconnect_weak_links(
    g: UnitigGraph, local_ratio: float = 0.1
) -> tuple[UnitigGraph, int]:
    t = NbrTables(g)
    avg = g.avg_depth()
    skip = g.is_standalone() | g.is_palindrome | g.is_loop
    num = 0
    for strand in (0, 1):
        deg = t.outdeg[:, strand]
        act = (~skip) & (deg > 1) & g.alive
        pres = t.present[:, strand, :] & act[:, None]
        nb = np.maximum(t.nbr[:, strand, :], 0)
        depths = np.where(pres, avg[nb], 0.0)
        total = depths.sum(-1, keepdims=True)
        weak = pres & (depths <= local_ratio * total)
        # mark the neighbour on its ENTRY strand
        for j in range(4):
            sel = weak[:, j]
            if not sel.any():
                continue
            targets = t.nbr[sel, strand, j]
            tstrands = t.strand[sel, strand, j]
            fwd = targets[tstrands == 0]
            rcs = targets[tstrands == 1]
            before = (g.to_disconnect_fwd[fwd].sum()
                      + g.to_disconnect_rc[rcs].sum())
            g.to_disconnect_fwd[fwd] = True
            g.to_disconnect_rc[rcs] = True
            num += len(targets) - int(before)
    g = refresh(g, set_changed=False)
    return g, num


# ---------------------------------------------------------------------------
# low depth (reference low_depth_remover.cpp)
# ---------------------------------------------------------------------------


def _local_depth(g: UnitigGraph, t: NbrTables, local_width: int
                 ) -> np.ndarray:
    """Depth of the neighbourhood of each vertex (LocalDepth,
    low_depth_remover.cpp:10-35), vectorized over all vertices."""
    avg = g.avg_depth()
    total = np.zeros(g.size)
    edges = np.zeros(g.size)
    for strand in (0, 1):
        pres = t.present[:, strand, :]
        nb = np.maximum(t.nbr[:, strand, :], 0)
        ln = np.where(pres, g.length[nb], 0)
        short = ln <= local_width
        contrib_e = np.where(short, ln, local_width) * pres
        contrib_d = np.where(
            short, np.where(pres, g.total_depth[nb], 0),
            avg[nb] * local_width * pres,
        )
        edges += contrib_e.sum(-1)
        total += contrib_d.sum(-1)
    return np.where(edges > 0, total / np.maximum(edges, 1), 0.0)


def remove_local_low_depth(
    g: UnitigGraph,
    min_depth: float,
    max_len: int,
    local_width: int,
    local_ratio: float,
    permanent: bool,
) -> tuple[UnitigGraph, int, bool]:
    t = NbrTables(g)
    ind, outd = t.outdeg[:, 1], t.outdeg[:, 0]
    cand = g.alive & (~g.is_standalone()) & (g.length <= max_len)
    cand &= ind + outd > 0
    cand &= ((ind <= 1) & (outd <= 1)) | (ind == 0) | (outd == 0)
    mean = _local_depth(g, t, local_width)
    threshold = np.minimum(min_depth, mean * local_ratio)
    depth = g.avg_depth()
    remove = cand & (depth < threshold)
    is_changed = bool((cand & (min_depth < mean * local_ratio)).any()
                      or remove.any())
    n = int(remove.sum())
    if n:
        g.to_delete |= remove
        g = refresh(g, set_changed=not permanent)
    return g, n, is_changed


def iterate_local_low_depth(
    g: UnitigGraph,
    min_depth: float,
    min_len: int,
    local_width: int,
    local_ratio: float,
    permanent: bool,
) -> tuple[UnitigGraph, int]:
    total = 0
    while min_depth < KMAX_MUL:
        g, n, changed = remove_local_low_depth(
            g, min_depth, min_len, local_width, local_ratio, permanent
        )
        if not changed:
            break
        total += n
        min_depth *= 1.1
    return g, total


def remove_low_depth(g: UnitigGraph, min_depth: float
                     ) -> tuple[UnitigGraph, int]:
    remove = (g.avg_depth() < min_depth) & g.alive
    n = int(remove.sum())
    if n:
        g.to_delete |= remove
    g = refresh(g, set_changed=False)
    return g, n
