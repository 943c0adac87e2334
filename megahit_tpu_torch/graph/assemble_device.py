"""Device-resident unitig-graph cleaning on the graph's torch device.

The host cleaning passes (graph/cleaning.py) are numpy frontier sweeps
with a host refresh between passes. This engine keeps the whole
cleaning loop on the device instead: the SdBG navigation core
(run_start / nxt_link / rc / ref_rank / mult) uploads once, and every
mark pass and every refresh is a torch pass over device tensors.
Per-pass host traffic is one scalar sync (the mark count) plus, in the
careful/similarity bubble passes, the small per-instance payloads and
the strings of the vertices those passes read. One download at output
time materializes the host UnitigGraph.

Semantics are the host engine's, bit for bit (held by
tests/test_torch_cleaning.py against megahit_tpu's device engine, pass
by pass, and against both packages' assemble()):

- refresh reproduces the reference Refresh's STABLE slot semantics
  (unitig_graph.cpp:210-355 at -t 1): a merged chain claims the slot of
  its min-old-slot end vertex oriented so that vertex is the head (ties:
  the disconnect-adjusted stored start edge, then the flip of the
  ref_rank build orientation); a cycle claims its min-old-slot member's
  slot anchored at that member's adjusted begin edge.
- tie-breaks in the mark passes use the same canonical EDGE ids
  (min(ref_rank[start], ref_rank[rc_start])) as the host passes.
- depths are computed and compared in float64, as the host engine
  (and MEGAHIT) does: the scalars arrive as 0-d float64/int32 tensors
  and the 4-candidate sums are explicit left-to-right adds, on the
  row's owner. megahit_tpu's device engine keeps them in float32 (the
  TPU has no fast float64); at exact ties, such as a careful bubble's
  depth at exactly 0.2 times the kept branch's, float32 and float64
  decide differently, and the bubble records' depths round
  differently, so a float32 engine on the card would not give the
  CPU's contigs.

Every pass is written over row blocks (parallel/rows.py): each E-sized
and Vc-sized tensor is a ``Blocks``, a read of another row is a
``rows.take`` and a write to another row a ``rows.scatter``. Masked
writes go nowhere (a whole-tensor pass sends them to a pad row), and
every scatter is order-free or writes one value per row, so results
stay deterministic on CUDA.

Precision: per-chain depth accumulates in int32 (``index_add_``); sums
are exact below 2^31. pipeline.assemble checks the sound sufficient
condition (total valid multiplicity < 2^31) and falls back to the host
engine otherwise.

Mesh sharding (``DeviceCleaner(g, mesh=)``, parallel/multihost.py):
when the mesh is taken (more than one shard, and the shard count
divides both the edge capacity E and the vertex capacity Vc), shard i
owns rows [i*E/n, (i+1)*E/n) of every E-sized tensor and [i*Vc/n,
(i+1)*Vc/n) of every Vc-sized one, and computes every pass on those
rows only; under torch.distributed a rank holds and computes only its
own block. The blocks are uploaded from host slices of the graph, so
no shard ever holds a tensor of the whole graph's rows; megahit_tpu
gets the same split from XLA's partitioner. The exchanges: a take is a
request and a reply (``Mesh.all_to_all_v``, after an exchange of the
split sizes), a scatter one send. A refresh runs about 2*ceil(log2 E)
takes in its list ranking plus some 20 more, a mark pass 5 to 20; the
engine's ``rows.exchanges`` and ``rows.bytes`` count them. What still
crosses to the host, as in megahit_tpu: the mark counts (global sums,
taken before any shard branches), the careful/similarity bubble
payloads and, for their strings, one download of ``nxt``, and
to_host(). With no mesh the same passes run on one block, where every
take is plain indexing and no exchange runs.

Counterpart of megahit_tpu/graph/assemble_device.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core import packing
from ..parallel import rows as R
from ..parallel.rows import Rows
from ..utils.debug import check_finite
from ..utils.log import get_logger
from .output import _last_base
from .sdbg import Sdbg, simple_path_links_rows
from .unitig import UnitigGraph, _list_rank_rows

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NULL = -1


# ---------------------------------------------------------------------------
# state (every tensor field a parallel.rows.Blocks)
# ---------------------------------------------------------------------------


@dataclass
class DevStatic:
    """Per-SdBG immutable device tensors (uploaded once)."""

    run_start: R.Blocks  # (E,) i64
    nxt_link: R.Blocks   # (E,) i64
    rc: R.Blocks         # (E,) i64
    ref_rank: R.Blocks   # (E,) i32
    mult: R.Blocks       # (E,) i32
    e: int               # edge capacity
    rounds: int          # pointer-doubling rounds = ceil(log2 E)
    k: int               # EDGE length (megahit k + 1)


@dataclass
class DevState:
    """Mutable graph state, all on the device."""

    valid: R.Blocks        # (E,) bool
    vid: R.Blocks          # (E,) i64 slot of each edge's vertex
    nxt: R.Blocks          # (E,) i64 simple-path successor
    prv: R.Blocks          # (E,) i64
    chain_start: R.Blocks  # (E,) i64
    edge_pos: R.Blocks     # (E,) i32
    # vertex tensors, slot-indexed at fixed capacity Vc
    start: R.Blocks        # (Vc,) i64
    end: R.Blocks          # (Vc,) i64
    length: R.Blocks       # (Vc,) i32
    depth: R.Blocks        # (Vc,) i32 total depth (exact < 2^31)
    is_loop: R.Blocks      # (Vc,) bool
    is_pal: R.Blocks       # (Vc,) bool
    alive: R.Blocks        # (Vc,) bool
    changed: R.Blocks      # (Vc,) bool


def _upload_static(sdbg: Sdbg, rows: Rows) -> DevStatic:
    e = sdbg.size
    return DevStatic(
        run_start=rows.put(sdbg.run_start, e, I64),
        nxt_link=rows.put(sdbg.nxt_link, e, I64),
        rc=rows.put(sdbg.rc, e, I64),
        ref_rank=rows.put(sdbg.ref_rank, e, I32),
        mult=rows.put(sdbg.mult, e, I32),
        e=e,
        rounds=max(1, int(np.ceil(np.log2(max(e, 2))))),
        k=sdbg.k,
    )


def _upload_state(g: UnitigGraph, vc: int, rows: Rows) -> DevState:
    e = g.sdbg.size
    return DevState(
        valid=rows.put(g.sdbg.valid, e, torch.bool),
        vid=rows.put(g.vid, e, I64),
        nxt=rows.put(g.nxt, e, I64),
        prv=rows.put(g.prv, e, I64),
        chain_start=rows.put(g.chain_start, e, I64),
        edge_pos=rows.put(g.edge_pos, e, I32),
        start=rows.put(g.start, vc, I64),
        end=rows.put(g.end, vc, I64),
        length=rows.put(g.length, vc, I32),
        depth=rows.put(g.total_depth, vc, I32),
        is_loop=rows.put(g.is_loop, vc, torch.bool, False),
        is_pal=rows.put(g.is_palindrome, vc, torch.bool, False),
        alive=rows.put(g.alive, vc, torch.bool, False),
        changed=rows.put(g.changed, vc, torch.bool, False),
    )


def _gather_blocks(x, rows: Rows, device):
    """A state dataclass with every Blocks field gathered into one
    whole tensor on `device` (tests only: no pass calls it)."""
    out = {}
    for f in dataclasses.fields(x):
        t = getattr(x, f.name)
        if isinstance(t, R.Blocks):
            t = t.b[0] if rows.mesh is None else \
                rows.mesh.all_gather(t.b, device)
        out[f.name] = t
    return type(x)(**out)


def _finite(name: str, x: R.Blocks) -> R.Blocks:
    for t in x.b:
        check_finite(name, t)
    return x


def _arange4(t):
    return t[..., None] + torch.arange(4, device=t.device)


# ---------------------------------------------------------------------------
# navigation
# ---------------------------------------------------------------------------


def _run4(rows, starts, run_valid, e: int):
    """run-start rows (any shape) -> (rows, present), each of shape
    starts.shape + (4,): the <= 4 consecutive members of each run that
    are valid. run_valid is run_start where valid, else -1 (one column
    to read instead of two: safe >= 0 never equals -1). The members may
    lie in the next shard's block."""
    safe = starts.clamp(min=0)
    idx = R.bmap(_arange4, safe)
    clip = idx.clamp(max=e - 1)
    (rs,) = rows.take([run_valid], clip)
    ok = (starts >= 0)[..., None] & (idx < e) & (rs == safe[..., None])
    return clip, ok


def _nbr_tables(rows, st: DevStatic, s: DevState, end0, end1):
    """Successor tables for both traversal strands: (Vc,2,4) neighbour
    slots / entry strands / presence (unitig.next_vertices)."""
    last = R.stack([end0, end1], 1).clamp(min=0)
    (link,) = rows.take([st.nxt_link], last)
    cand, ok = _run4(rows, link, R.where(s.valid, st.run_start, NULL),
                     st.e)
    ok = ok & s.alive[:, None, None]
    (vid,) = rows.take([s.vid], cand)
    nbr = R.where(ok, vid, NULL)
    (start,) = rows.take([s.start], nbr.clamp(min=0))
    strands = R.where(cand == start, 0, 1).to(torch.int8)
    return nbr, strands, ok


def _sum4(x):
    """Row sums of an (N, 4) tensor as explicit left-to-right adds."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


# ---------------------------------------------------------------------------
# refresh (kill edges -> rebuild -> reference slot order); on one block
# no host sync, on a mesh one per exchange (its split sizes)
# ---------------------------------------------------------------------------


def _refresh(rows: Rows, st: DevStatic, s: DevState, to_delete, to_dfwd,
             to_drc, vc: int, set_changed: bool) -> DevState:
    """Apply marks, rebuild chains, restore reference slot semantics
    (unitig._refresh_full + _reference_order + _propagate_changed).

    Gathers that megahit_tpu leaves to XLA's index clamping are clamped
    here explicitly, so every intermediate equals megahit_tpu's."""
    e = st.e
    idx = rows.arange(e)

    # ---- classify marks (unitig._classify_marks)
    n_marks = to_dfwd.to(I32) + to_drc.to(I32)
    kill_whole = ~to_delete & (n_marks > 0) & (s.length <= n_marks)
    delete = (to_delete | kill_whole) & s.alive
    disc_f = to_dfwd & ~to_delete & ~kill_whole & s.alive
    disc_r = to_drc & ~to_delete & ~kill_whole & s.alive

    # ---- kill edges (unitig._kill_edge_indices)
    (rc_end,) = rows.take([st.rc], s.end.clamp(min=0))
    (kill,) = rows.scatter(
        [rows.full(e, False, torch.bool)],
        R.stack([R.where(disc_f, s.start, NULL),
                 R.where(disc_r, rc_end, NULL)]), [True])
    (del_vid,) = rows.take([delete], s.vid.clamp(min=0))
    kill = kill | ((s.vid >= 0) & del_vid)
    (kill_rc,) = rows.take([kill], st.rc)
    valid = s.valid & ~(kill | kill_rc)

    # ---- rebuild chains
    nxt, prv = simple_path_links_rows(rows, st.run_start, st.nxt_link,
                                      st.rc, valid)
    endr, _, startr, pos, mn = _list_rank_rows(rows, nxt, prv, st.rounds)
    (nxt_endr,) = rows.take([nxt], endr)
    (prv_mn,) = rows.take([prv], mn)
    in_cycle = valid & (nxt_endr >= 0)
    chain_start = R.where(in_cycle, mn, startr)
    chain_end = R.where(in_cycle, prv_mn, endr)
    ce = chain_end.clamp(min=0)

    seg = R.where(valid, chain_start, NULL)
    len_per_start, dep_per_start = rows.scatter(
        [rows.full(e, 0, I32), rows.full(e, 0, I32)], seg, [1, st.mult],
        "add")

    # disconnect-adjusted old start per old slot (_reference_order)
    (nxt_start,) = rows.take([s.nxt], s.start.clamp(min=0))
    adj_start = R.where(disc_f, nxt_start, s.start)
    is_rep = valid & (chain_start == idx)

    # per-chain min old slot (for cycles; h/t for chains)
    vid_seg = R.where(valid & (s.vid >= 0), s.vid, vc)
    (mslot,) = rows.scatter([rows.full(e, vc, I64)], seg, [vid_seg],
                            "amin")

    h = s.vid                    # old slot of first edge
    t, ref_ce, rc_ce = rows.take([s.vid, st.ref_rank, st.rc], ce)
    (pair_start,) = rows.take([chain_start], rc_ce)
    (ref_rc,) = rows.take([st.ref_rank], st.rc)

    # chain orientation winner: min-old-slot head; tie: adjusted start
    # edge; tie: flip of the ref_rank build orientation
    (adj_h,) = rows.take([adj_start], h.clamp(min=0))
    r2_is_adj = pair_start == adj_h
    self_is_adj = idx == adj_h
    build_flip = ref_ce > ref_rc
    win_chain = (h < t) | (
        (h == t) & (self_is_adj | (~r2_is_adj & build_flip)))
    # palindrome (pair == self): single rep, wins
    is_self_pair = pair_start == idx
    win_chain = win_chain | is_self_pair

    # cycle winner: the strand cycle containing the min-slot member's
    # adjusted start edge, anchored there
    (cyc_anchor,) = rows.take([adj_start], mslot.clamp(0, vc - 1))
    cs_anchor, prv_anchor = rows.take([chain_start, prv],
                                      cyc_anchor.clamp(min=0))
    win_cycle = cs_anchor == idx

    win = is_rep & R.where(in_cycle, win_cycle, win_chain)
    slot = R.where(in_cycle, mslot, R.minimum(h, t))
    new_start = R.where(in_cycle, cyc_anchor, idx)
    new_end = R.where(in_cycle, prv_anchor, chain_end)

    # ---- changed propagation (_propagate_changed)
    (vid_ends,) = rows.take([s.vid], R.stack(
        [new_start.clamp(min=0), new_end.clamp(min=0)], 1))
    nfo = vid_ends[:, 0]
    len_nfo, changed_nfo = rows.take([s.length, s.changed],
                                     nfo.clamp(min=0))
    same = (nfo >= 0) & (len_nfo == len_per_start) \
        & (vid_ends[:, 1] == nfo)
    prev_changed = (nfo >= 0) & changed_nfo
    ch_val = (~same | prev_changed) if set_changed else \
        (same & prev_changed)

    # ---- scatter winners into vertex slots (slot-space: dead slots
    # keep stale values; each slot gets at most one winner)
    wslot = R.where(win, slot, NULL)
    (alive_new, start_new, end_new, length_new, depth_new, loop_new,
     pal_new, changed_new) = rows.scatter(
        [rows.full(vc, False, torch.bool), s.start, s.end, s.length,
         s.depth, s.is_loop, s.is_pal, s.changed], wslot,
        [True, new_start, new_end, len_per_start, dep_per_start, in_cycle,
         is_self_pair, ch_val])

    # ---- per-edge vid
    (slot_of_start,) = rows.scatter([rows.full(e, NULL, I64)],
                                    R.where(win, idx, NULL), [wslot])
    (slot_of_start,) = rows.scatter([slot_of_start],
                                    R.where(win, pair_start, NULL), [wslot])
    (sos,) = rows.take([slot_of_start], chain_start.clamp(max=e - 1))
    vid_new = R.where(valid, sos, NULL)

    return DevState(
        valid=valid, vid=vid_new, nxt=nxt, prv=prv,
        chain_start=chain_start, edge_pos=pos,
        start=start_new, end=end_new, length=length_new,
        depth=depth_new, is_loop=loop_new, is_pal=pal_new,
        alive=alive_new, changed=changed_new,
    )


# ---------------------------------------------------------------------------
# mark passes (translations of graph/cleaning.py, same tie-breaks; each
# returns mark masks + a per-block count)
# ---------------------------------------------------------------------------


def _avg_depth(s: DevState):
    return _finite("average depth", s.depth.to(F64) / s.length.clamp(min=1))


def _tips_marks(rows, st, s, end0, end1, thre):
    """cleaning.remove_tips body for one threshold."""
    nbr, _, present = _nbr_tables(rows, st, s, end0, end1)
    outdeg = present.sum(-1)
    ind, outd = outdeg[:, 1], outdeg[:, 0]
    short = (s.length < thre) & s.alive
    avg = _avg_depth(s)
    delete = short & ~s.is_loop & (ind + outd == 0)
    sel = R.where(present, nbr, NULL).amax(-1)  # (Vc, 2)
    (nb_avg,) = rows.take([avg], sel.clamp(min=0))
    for strand in (0, 1):
        one_out = short & ~s.is_loop & (outdeg[:, strand] == 1) & (
            outdeg[:, 1 - strand] == 0)
        ok = one_out & (sel[:, strand] >= 0)
        nb = R.where(ok, nb_avg[:, strand], 0.0)
        delete = delete | (ok & (nb > 8 * avg))
    return delete, delete.sum()


def _weak_marks(rows, st, s, end0, end1, local_ratio, vc: int):
    """cleaning.disconnect_weak_links marks. num reproduces the host's
    counting exactly: each (strand, j) batch adds its selected entries
    minus those whose target was already marked before the batch.
    The marks are one (2*Vc,) row space: row 2*v + strand holds v's
    forward (0) or rc (1) disconnect mark."""
    nbr, nstr, present = _nbr_tables(rows, st, s, end0, end1)
    outdeg = present.sum(-1)
    standalone = ~s.is_loop & (outdeg[:, 0] == 0) & (outdeg[:, 1] == 0)
    skip = standalone | s.is_pal | s.is_loop
    avg = _avg_depth(s)
    (nb_avg,) = rows.take([avg], nbr.clamp(min=0))
    marks = rows.full(2 * vc, False, torch.bool)
    num = rows.const(0, I64)
    for strand in (0, 1):
        act = ~skip & (outdeg[:, strand] > 1) & s.alive
        pres = present[:, strand] & act[:, None]
        depths = R.where(pres, nb_avg[:, strand], 0.0)
        total = _finite("weak-link depth sum", _sum4(depths))
        weak = pres & (depths <= local_ratio * total[:, None])
        for j in range(4):
            sel = weak[:, j]
            row = 2 * nbr[:, strand, j].clamp(min=0) + nstr[:, strand, j]
            (before,) = rows.take([marks], row)
            num = num + sel.sum() - (sel & before).sum()
            (marks,) = rows.scatter([marks], R.where(sel, row, NULL),
                                    [True])
    marks = marks.reshape(-1, 2)
    return marks[:, 0], marks[:, 1], num


def _lld_marks(rows, st, s, end0, end1, min_depth, max_len, local_width,
               local_ratio):
    """cleaning.remove_local_low_depth marks + is_changed."""
    depth = s.depth.to(F64)
    nbr, _, present = _nbr_tables(rows, st, s, end0, end1)
    outdeg = present.sum(-1)
    ind, outd = outdeg[:, 1], outdeg[:, 0]
    standalone = ~s.is_loop & (ind == 0) & (outd == 0)
    cand = s.alive & ~standalone & (s.length <= max_len)
    cand = cand & (ind + outd > 0)
    cand = cand & (((ind <= 1) & (outd <= 1)) | (ind == 0) | (outd == 0))
    avg = _avg_depth(s)
    # _local_depth
    total = R.bmap(torch.zeros_like, depth)
    edges = R.bmap(torch.zeros_like, total)
    for strand in (0, 1):
        pres = present[:, strand]
        ln_nb, dep_nb, avg_nb = rows.take([s.length, depth, avg],
                                          nbr[:, strand].clamp(min=0))
        ln = R.where(pres, ln_nb, 0)
        short = ln <= local_width
        contrib_e = R.where(short, ln, local_width) * pres
        contrib_d = R.where(
            short, R.where(pres, dep_nb, 0.0),
            avg_nb * local_width * pres)
        edges = edges + _sum4(contrib_e)
        total = total + _sum4(contrib_d)
    mean = _finite("local depth mean", R.where(
        edges > 0, total / edges.clamp(min=1), 0.0))
    threshold = _finite("local depth threshold",
                        R.minimum(min_depth, mean * local_ratio))
    remove = cand & (avg < threshold)
    is_changed = (cand & (min_depth < mean * local_ratio)).any() \
        | remove.any()
    return remove, remove.sum(), is_changed


def _low_depth_marks(s, min_depth):
    remove = (_avg_depth(s) < min_depth) & s.alive
    return remove, remove.sum()


def _successor_rows(nbr, nstr, outdeg):
    """Per (vertex, strand) row 2*v + strand, what a bubble middle
    entered on that strand contributes: its successors' max slot, the
    strand of the first successor holding it, its out-degree on that
    strand and on the other, each (2*Vc,)."""
    rv = nbr.amax(-1)
    first_max = R.bmap(
        lambda n, m: torch.where(n == m[..., None],
                                 torch.arange(4, device=n.device), 4
                                 ).amin(-1), nbr, rv)
    rs = nstr.gather(-1, first_max[..., None])[..., 0]
    return (rv.reshape(-1), rs.reshape(-1), outdeg.reshape(-1),
            outdeg.flip(1).reshape(-1))


def _bubble_shape(rows, st, s, end0, end1, max_len):
    """cleaning._find_bubble_instances, both strands at once.

    Returns per-(vertex, strand): ok, right slot, right strand, and the
    (4,) middle slots / strands / presence SORTED by the reference keep
    order (avg depth desc, canonical edge id asc); and avg."""
    nbr, nstr, present = _nbr_tables(rows, st, s, end0, end1)
    outdeg = present.sum(-1)
    standalone = ~s.is_loop & (outdeg[:, 0] == 0) & (outdeg[:, 1] == 0)
    base = (outdeg > 1).any(1) & ~s.is_loop & ~standalone & s.alive
    avg = _avg_depth(s)
    (rc_end,) = rows.take([st.rc], s.end.clamp(min=0))
    (rr,) = rows.take([st.ref_rank],
                      R.stack([s.start.clamp(min=0), rc_end], 1))
    cid = R.minimum(rr[:, 0], rr[:, 1])
    succ = _successor_rows(nbr, nstr, outdeg)

    out = {name: [] for name in ("ok", "right", "rstr", "mids", "mstr",
                                 "pres")}
    for strand in (0, 1):
        degree = outdeg[:, strand]
        active = base & (degree > 1)
        mids = nbr[:, strand]
        mstr = nstr[:, strand].to(I64)
        pres = present[:, strand]
        safe = mids.clamp(min=0)
        len_m, avg_m, cid_m = rows.take([s.length, avg, cid], safe)
        # each middle's successors on its entry strand
        rv, rs, od_fwd, od_rev = rows.take(succ, 2 * safe + mstr)
        ok = active & ~(pres & (len_m > max_len)).any(1)
        ok = ok & ~(pres & ((od_fwd != 1) | (od_rev != 1))).any(1)
        first_slot = R.bmap(
            lambda p: torch.where(p, torch.arange(4, device=p.device), 4
                                  ).amin(1), pres)
        first_slot = R.where(first_slot == 4, 0, first_slot)
        rv0 = rv.gather(1, first_slot[:, None])[:, 0]
        rs0 = rs.gather(1, first_slot[:, None])[:, 0]
        ok = ok & ~(pres & ((rv != rv0[:, None]) | (rs != rs0[:, None]))
                    ).any(1)
        od_r, cid_r = rows.take([outdeg, cid], rv0.clamp(min=0))
        r_deg = od_r.gather(1, (1 - rs0.to(I64))[:, None])[:, 0]
        ok = ok & (rv0 >= 0) & (cid_r >= cid) & (r_deg == degree)

        # sort middles by (avg desc, cid asc), absents last: two stable
        # sorts, the secondary key first (numpy's lexsort order)
        avgm = R.where(pres, avg_m, -torch.inf)
        midv = R.where(pres, cid_m, torch.iinfo(I32).max)
        o1 = R.bmap(lambda m: torch.sort(m, dim=1, stable=True).indices,
                    midv)
        neg = (-avgm).gather(1, o1) + 0.0  # + 0.0: no -0.0 keys
        order = o1.gather(1, R.bmap(
            lambda x: torch.sort(x, dim=1, stable=True).indices, neg))
        out["mids"].append(mids.gather(1, order))
        out["mstr"].append(nstr[:, strand].gather(1, order))
        out["pres"].append(pres.gather(1, order))
        out["ok"].append(ok)
        out["right"].append(rv0)
        out["rstr"].append(rs0)
    return {k: R.stack(v, 1) for k, v in out.items()}, avg


def _naive_bubble_marks(rows, ok2, mids2, pres2, vc: int):
    """Union of non-keep present middles over all instances (order-free:
    marking is a monotone set union; the host's sequential scan order
    only affects record emission, which the naive path has none of)."""
    tgt = R.where(ok2[:, :, None] & pres2[:, :, 1:], mids2[:, :, 1:],
                  NULL)
    (marks,) = rows.scatter([rows.full(vc, False, torch.bool)], tgt,
                            [True])
    return marks


def _instances(rows, st, s, shape, avg, vc: int) -> np.ndarray:
    """The bubble instances as one host int64 array, in the reference
    scan order (left slot asc, strand asc; shard blocks concatenate in
    row order). Columns: the four sorted middles' slots, strands and
    presence, then for the six vertices (middles, left, right) their
    length, start edge, flip (build orientation) and avg depth (float64
    bits). Only instance rows cross to the host."""
    lv, sv = R.bmap(lambda ok: torch.nonzero(ok, as_tuple=True),
                    shape["ok"])

    def at(x):
        return R.bmap(lambda t, i, j: t[i, j], x, lv, sv)

    mids = at(shape["mids"])
    left = R.bmap(lambda a, i: a[i], rows.arange(vc), lv)
    verts = R.bmap(lambda m, lt, r: torch.cat([m, lt[:, None], r[:, None]],
                                              1),
                   mids, left, at(shape["right"]))
    (rc_end,) = rows.take([st.rc], s.end.clamp(min=0))
    (rr,) = rows.take([st.ref_rank],
                      R.stack([rc_end, s.start.clamp(min=0)], 1))
    flip = rr[:, 0] < rr[:, 1]
    length, start, flip, avg = rows.take([s.length, s.start, flip, avg],
                                         verts.clamp(min=0))
    cols = [verts, at(shape["mstr"]), at(shape["pres"]), length, start,
            flip, avg.view(I64)]
    return rows.fetch(R.bmap(
        lambda *c: torch.cat([x.to(I64) for x in c], 1), *cols))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class DeviceCleaner:
    """Holds the device state and runs cleaning passes.

    Mirrors the graph/cleaning.py API (through pipeline.assemble's
    engine interface); construct from a freshly built host graph (the
    initial build + reference ordering happen once on the host), then
    every pass runs on the graph's device, or on the mesh's shards.
    """

    def __init__(self, g: UnitigGraph, mesh=None):
        self.sdbg = g.sdbg
        self.dev = g.sdbg.device
        self.k = g.k  # megahit-k + 1 (edge length)
        self.vc = max(16, 1 << int(np.ceil(np.log2(max(g.size, 2)))))
        # megahit_tpu's rule: shard only when the mesh splits both
        # capacities evenly (else the engine runs unsharded)
        self.mesh = None
        if mesh is not None:
            nd = mesh.size
            if (nd > 1 and self.sdbg.size % nd == 0
                    and self.vc % nd == 0 and self.sdbg.size >= nd):
                self.mesh = mesh
        self.rows = Rows(self.mesh, self.dev)
        self.static = _upload_static(g.sdbg, self.rows)
        self.state = _upload_state(g, self.vc, self.rows)
        self._host_graph_template = g

    def gathered(self, device=None) -> tuple[DevStatic, DevState]:
        """The static and mutable state as whole tensors on `device`
        (default: the graph's). For tests: no pass calls it."""
        device = self.dev if device is None else torch.device(device)
        return (_gather_blocks(self.static, self.rows, device),
                _gather_blocks(self.state, self.rows, device))

    # -- helpers ----------------------------------------------------

    def _f64(self, x) -> R.Blocks:
        return self.rows.const(x, F64)

    def _i32(self, x) -> R.Blocks:
        return self.rows.const(x, I32)

    def _ends(self, st: DevStatic, s: DevState):
        """(end0, end1): the last edge of each vertex's forward chain
        and of its rc chain (rc_end = rc[start])."""
        (end1,) = self.rows.take([st.rc], s.start.clamp(min=0))
        return s.end, end1

    def _refresh(self, st, s, to_delete, to_dfwd, to_drc,
                 set_changed: bool):
        self.state = _refresh(self.rows, st, s, to_delete, to_dfwd,
                              to_drc, self.vc, set_changed)

    def _zeros_v(self):
        return self.rows.full(self.vc, False, torch.bool)

    # -- cleaning passes (graph/cleaning.py API) --------------------

    def remove_tips(self, max_tip_len: int) -> int:
        num = 0
        thre = 2
        while thre < max_tip_len:
            st, s = self.static, self.state
            end0, end1 = self._ends(st, s)
            delete, n = _tips_marks(self.rows, st, s, end0, end1,
                                    self._i32(thre))
            (n,) = self.rows.total(n)
            num += n
            if n:
                self._refresh(st, s, delete, self._zeros_v(),
                              self._zeros_v(), set_changed=False)
            thre = min(thre * 2, max_tip_len)
            if thre >= max_tip_len:
                break
        return num

    def disconnect_weak_links(self, local_ratio: float = 0.1) -> int:
        st, s = self.static, self.state
        end0, end1 = self._ends(st, s)
        dfwd, drc, n = _weak_marks(self.rows, st, s, end0, end1,
                                   self._f64(local_ratio), self.vc)
        (n,) = self.rows.total(n)
        if n:
            self._refresh(st, s, self._zeros_v(), dfwd, drc,
                          set_changed=False)
        return n

    def remove_local_low_depth(self, min_depth: float, max_len: int,
                               local_width: int, local_ratio: float,
                               permanent: bool) -> tuple[int, bool]:
        st, s = self.static, self.state
        end0, end1 = self._ends(st, s)
        remove, n, is_changed = _lld_marks(
            self.rows, st, s, end0, end1, self._f64(min_depth),
            self._i32(max_len), self._i32(local_width),
            self._f64(local_ratio))
        n, is_changed = self.rows.total(n, is_changed)
        if n:
            self._refresh(st, s, remove, self._zeros_v(), self._zeros_v(),
                          set_changed=not permanent)
        return n, bool(is_changed)

    def iterate_local_low_depth(self, min_depth: float, min_len: int,
                                local_width: int, local_ratio: float,
                                permanent: bool) -> int:
        from .counter import KMAX_MUL

        total = 0
        passes = 0
        while min_depth < KMAX_MUL:
            n, changed = self.remove_local_low_depth(
                min_depth, min_len, local_width, local_ratio, permanent)
            passes += 1
            if not changed:
                break
            total += n
            min_depth *= 1.1
        get_logger().info("local low depth: %d passes on the device",
                          passes)
        return total

    def remove_low_depth(self, min_depth: float) -> int:
        st, s = self.static, self.state
        remove, n = _low_depth_marks(s, self._f64(min_depth))
        (n,) = self.rows.total(n)
        # the host path always refreshes here (set_changed=False), but
        # a refresh with no marks is the identity
        if n:
            self._refresh(st, s, remove, self._zeros_v(), self._zeros_v(),
                          set_changed=False)
        return n

    # -- bubbles ----------------------------------------------------

    def _vertex_codes(self, vs: np.ndarray, start: np.ndarray,
                      lens: np.ndarray, nxt: np.ndarray
                      ) -> dict[int, np.ndarray]:
        """Host base codes of the given vertex slots, from their start
        edges and lengths (forward chain orientation; loops walk their
        intact nxt cycle from the anchor), by a native chain walk over
        the downloaded nxt."""
        from ..native import collect_chain_edges

        if len(vs) == 0:
            return {}
        eidx = collect_chain_edges(nxt, start, lens)
        keys = self.sdbg.keys
        bases = _last_base(keys[eidx], self.k)
        offs = np.concatenate([[0], np.cumsum(lens)])
        out = {}
        for i, v in enumerate(vs.tolist()):
            head = packing.unpack_words(keys[start[i]], self.k)
            out[v] = np.concatenate(
                [head, bases[offs[i] + 1: offs[i + 1]]]).astype(np.uint8)
        return out

    def pop_bubbles(self, max_len: int, permanent: bool,
                    similarity: float | None = None,
                    careful_threshold: float | None = None,
                    bubble_records: list | None = None) -> int:
        rows = self.rows
        st, s = self.static, self.state
        end0, end1 = self._ends(st, s)
        shape, avg_d = _bubble_shape(rows, st, s, end0, end1,
                                     self._i32(max_len))
        (n_inst,) = rows.total(shape["ok"].sum())
        if n_inst == 0:
            # the host path refreshes with no marks: the identity
            return 0

        if similarity is None and careful_threshold is None:
            # fully device marking: union of non-keep present middles
            delete = _naive_bubble_marks(rows, shape["ok"], shape["mids"],
                                         shape["pres"], self.vc)
            (n,) = rows.total(delete.sum())
            if n:
                self._refresh(st, s, delete, self._zeros_v(),
                              self._zeros_v(), set_changed=not permanent)
            return n

        # host sequential part over the (small) instance list, in the
        # reference scan order (left slot asc, strand asc); only
        # instance rows cross to the host
        inst = _instances(rows, st, s, shape, avg_d, self.vc)
        verts, mstrs = inst[:, 0:6], inst[:, 6:10]
        press = inst[:, 10:14].astype(bool)
        mids, lv, rights = verts[:, :4], verts[:, 4], verts[:, 5]
        # per vertex: length, start edge, flip, avg depth
        known = np.concatenate([press, np.ones((len(inst), 2), bool)], 1)
        vinfo = {}
        for v, ln, se, fl, av in zip(
                verts[known].tolist(), inst[:, 14:20][known].tolist(),
                inst[:, 20:26][known].tolist(),
                inst[:, 26:32][known].astype(bool).tolist(),
                inst[:, 32:38].view(np.float64)[known]):
            vinfo[v] = (ln, se, fl, av)
        clen = inst[:, 14:18] + (self.k - 1)
        avg = inst[:, 32:36].view(np.float64)
        nxt = None  # downloaded at a pass's first string fetch
        codes_of: dict[int, np.ndarray] = {}

        def fetch(vs):
            nonlocal nxt
            need = np.setdiff1d(np.unique(np.asarray(vs, np.int64)),
                                np.fromiter(codes_of, np.int64,
                                            len(codes_of)))
            if len(need) == 0:
                return
            if nxt is None:
                nxt = rows.fetch(s.nxt.to(I32))
            info = [vinfo[v] for v in need.tolist()]
            codes_of.update(self._vertex_codes(
                need, np.array([i[1] for i in info], np.int64),
                np.array([i[0] for i in info], np.int64), nxt))

        def vstring(v, strand):
            c = codes_of[int(v)]
            return packing.revcomp_codes(c) if strand == 1 else c

        sim_ok = np.ones(len(inst), dtype=bool)
        if similarity is not None:
            from .cleaning import banded_similarity_batch

            pairs = []  # (instance, keep, keep strand, v, v strand)
            for i in range(len(inst)):
                a_len = clen[i, 0]
                for j in range(1, 4):
                    if not press[i, j]:
                        continue
                    b_len = clen[i, j]
                    if not (b_len * similarity <= a_len
                            and a_len * similarity <= b_len):
                        sim_ok[i] = False
                        break
                    pairs.append((i, mids[i, 0], mstrs[i, 0], mids[i, j],
                                  mstrs[i, j]))
            if pairs:
                fetch([p[1] for p in pairs] + [p[3] for p in pairs])
                sims = banded_similarity_batch(
                    [vstring(p[1], p[2]) for p in pairs],
                    [vstring(p[3], p[4]) for p in pairs], similarity)
                for (i, *_), bad in zip(pairs, sims < similarity):
                    if bad:
                        sim_ok[i] = False

        # marks, and the vertices whose strings the records need
        marked = np.zeros(self.vc, dtype=bool)
        num_removed = 0
        records: list[tuple[int, ...]] = []  # vertex slots per instance
        careful = careful_threshold is not None \
            and bubble_records is not None
        for i in range(len(inst)):
            if not sim_ok[i]:
                continue
            rec = []
            for j in range(1, 4):
                if not press[i, j]:
                    continue
                v = int(mids[i, j])
                if not marked[v]:
                    marked[v] = True
                    num_removed += 1
                if careful and avg[i, j] >= avg[i, 0] * careful_threshold:
                    rec.append(v)
            if rec:
                records.append((*rec, int(lv[i]), int(rights[i])))
        if records:
            fetch([v for r in records for v in r])
            for r in records:
                for v in r:
                    _, _, fl, av = vinfo[v]
                    c = vstring(v, 1 if fl else 0)
                    bubble_records.append((packing.decode(c), float(av)))
        if num_removed:
            self._refresh(st, s, rows.put(marked, self.vc, torch.bool),
                          self._zeros_v(), self._zeros_v(),
                          set_changed=not permanent)
        return num_removed

    def pop_complex_bubbles(self, merge_level: int, similarity: float,
                            permanent: bool,
                            careful_threshold: float | None = None,
                            bubble_records: list | None = None) -> int:
        max_len = int(round(merge_level * (self.k - 1) / similarity))
        if max_len * (1 - similarity) < 1:
            return 0
        return self.pop_bubbles(
            max_len, permanent, similarity=similarity,
            careful_threshold=careful_threshold,
            bubble_records=bubble_records)

    def to_host(self) -> UnitigGraph:
        """Materialize the host UnitigGraph (and sync sdbg validity)."""
        s = self.state
        g0 = self._host_graph_template

        def host(t, dtype=None):
            a = self.rows.fetch(t)
            return a if dtype is None else a.astype(dtype)

        sdbg = self.sdbg
        sdbg.valid = host(s.valid).copy()
        sdbg._rvc = None
        start = host(s.start, np.int32)
        end = host(s.end, np.int32)
        g = UnitigGraph(
            g0.k, sdbg, start, end,
            sdbg.rc[end].astype(np.int32), sdbg.rc[start].astype(np.int32),
            host(s.length, np.int32), host(s.depth, np.int64),
            host(s.is_loop), host(s.is_pal),
            host(s.vid, np.int32),
            chain_start=host(s.chain_start, np.int32),
            edge_pos=host(s.edge_pos, np.int32),
            nxt=host(s.nxt, np.int32), prv=host(s.prv, np.int32),
        )
        g.alive = host(s.alive)
        g.changed = host(s.changed)
        # slot-space arrays are Vc-capacity; host consumers mask alive
        return g
