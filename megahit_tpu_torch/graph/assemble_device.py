"""Device-resident unitig-graph cleaning on the graph's torch device.

The host cleaning passes (graph/cleaning.py) are numpy frontier sweeps
with a host refresh between passes. This engine keeps the whole
cleaning loop on the device instead: the SdBG navigation core
(run_start / nxt_link / rc / ref_rank / mult) uploads once, and every
mark pass and every refresh is a whole-graph torch pass over device
tensors. Per-pass host traffic is one scalar sync (the mark count) plus,
in the careful/similarity bubble passes, the small per-instance payloads
and the strings of the vertices those passes read. One download at
output time materializes the host UnitigGraph.

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
- depths are compared in float32, as megahit_tpu's device engine does:
  the scalars arrive as 0-d float32/int32 tensors and the 4-candidate
  sums are explicit left-to-right adds.

Masked rows of every scatter write to one pad row (index vc or e), all
with the same value, so duplicate indices in ``index_put_`` stay
deterministic on CUDA.

Precision: per-chain depth accumulates in int32 (``index_add_``); sums
are exact below 2^31. pipeline.assemble checks the sound sufficient
condition (total valid multiplicity < 2^31) and falls back to the host
engine otherwise.

Mesh sharding (``DeviceCleaner(g, mesh=)``, parallel/multihost.py):
when the mesh is taken (more than one shard, and the shard count
divides both the edge capacity E and the vertex capacity Vc), every
E-sized and Vc-sized tensor of DevStatic and DevState is held at rest as
row blocks, block i on shard i's device; under torch.distributed a rank
holds only its own block. Each pass gathers the blocks into full tensors
(a ``torch.cat`` in one process, ``all_gather_into_tensor`` across
ranks), runs the same pass function and keeps each shard's block of the
result. Every rank computes the whole pass, so its results are
byte-identical to the unsharded engine's. This shards the state at
rest, not the compute: a pass holds the full tensors, so there is no
peak-memory win during a pass. megahit_tpu lets XLA's partitioner split
each pass by owner rows; doing so here is later work.

Counterpart of megahit_tpu/graph/assemble_device.py.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import packing
from ..utils.debug import check_finite
from ..utils.devlink import latency_bound_link
from ..utils.log import get_logger
from .output import _last_base
from .sdbg import Sdbg, simple_path_links
from .unitig import UnitigGraph, _list_rank

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
NULL = -1


def use_device_cleaning(device) -> bool:
    """True when the cleaning loop runs on this engine: the graph's
    device is a card on a latency-cheap link (utils/devlink.py). On the
    CPU the host engine (graph/cleaning.py) runs it, and so it does for
    a card behind a remote link, where each of the engine's many small
    passes would pay a round trip. MEGAHIT_TPU_TORCH_DEVICE_CLEAN=1/0
    forces or forbids the engine (=1 on a CPU graph runs it on CPU
    tensors)."""
    env = os.environ.get("MEGAHIT_TPU_TORCH_DEVICE_CLEAN")
    if env is not None:
        return env == "1"
    if torch.device(device).type == "cpu":
        return False
    return not latency_bound_link()


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@dataclass
class DevStatic:
    """Per-SdBG immutable device tensors (uploaded once)."""

    run_start: torch.Tensor  # (E,) i64
    nxt_link: torch.Tensor   # (E,) i64
    rc: torch.Tensor         # (E,) i64
    ref_rank: torch.Tensor   # (E,) i32
    mult: torch.Tensor       # (E,) i32
    e: int                   # edge capacity
    rounds: int              # pointer-doubling rounds = ceil(log2 E)
    k: int                   # EDGE length (megahit k + 1)


@dataclass
class DevState:
    """Mutable graph state, all on the device."""

    valid: torch.Tensor        # (E,) bool
    vid: torch.Tensor          # (E,) i64 slot of each edge's vertex
    nxt: torch.Tensor          # (E,) i64 simple-path successor
    prv: torch.Tensor          # (E,) i64
    chain_start: torch.Tensor  # (E,) i64
    edge_pos: torch.Tensor     # (E,) i32
    # vertex tensors, slot-indexed at fixed capacity Vc
    start: torch.Tensor        # (Vc,) i64
    end: torch.Tensor          # (Vc,) i64
    length: torch.Tensor       # (Vc,) i32
    depth: torch.Tensor        # (Vc,) i32 total depth (exact < 2^31)
    is_loop: torch.Tensor      # (Vc,) bool
    is_pal: torch.Tensor       # (Vc,) bool
    alive: torch.Tensor        # (Vc,) bool
    changed: torch.Tensor      # (Vc,) bool


def _put(a, dev, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _upload_static(sdbg: Sdbg) -> DevStatic:
    dev = sdbg.device
    e = sdbg.size
    return DevStatic(
        run_start=_put(sdbg.run_start, dev, I64),
        nxt_link=_put(sdbg.nxt_link, dev, I64),
        rc=_put(sdbg.rc, dev, I64),
        ref_rank=_put(sdbg.ref_rank, dev, I32),
        mult=_put(sdbg.mult, dev, I32),
        e=e,
        rounds=max(1, int(np.ceil(np.log2(max(e, 2))))),
        k=sdbg.k,
    )


def _upload_state(g: UnitigGraph, vc: int) -> DevState:
    dev = g.sdbg.device

    def vpad(a, fill, dtype):
        out = np.full(vc, fill, np.asarray(a).dtype)
        out[: g.size] = a
        return _put(out, dev, dtype)

    return DevState(
        valid=_put(g.sdbg.valid, dev, torch.bool),
        vid=_put(g.vid, dev, I64),
        nxt=_put(g.nxt, dev, I64),
        prv=_put(g.prv, dev, I64),
        chain_start=_put(g.chain_start, dev, I64),
        edge_pos=_put(g.edge_pos, dev, I32),
        start=vpad(g.start, 0, I64),
        end=vpad(g.end, 0, I64),
        length=vpad(g.length, 0, I32),
        depth=vpad(g.total_depth, 0, I32),
        is_loop=vpad(g.is_loop, False, torch.bool),
        is_pal=vpad(g.is_palindrome, False, torch.bool),
        alive=vpad(g.alive, False, torch.bool),
        changed=vpad(g.changed, False, torch.bool),
    )


def _shard_blocks(x, mesh):
    """A state dataclass with each tensor field split into the mesh's
    row blocks: per field, this process's blocks, each a copy on its
    shard's device."""
    out = {}
    for f in dataclasses.fields(x):
        t = getattr(x, f.name)
        if isinstance(t, torch.Tensor):
            blocks = t.chunk(mesh.size)
            t = [blocks[i].to(mesh.devices[i], copy=True)
                 for i in mesh.local]
        out[f.name] = t
    return type(x)(**out)


def _gather_blocks(x, mesh, device):
    """Inverse of _shard_blocks: full tensors on `device`."""
    out = {}
    for f in dataclasses.fields(x):
        t = getattr(x, f.name)
        if isinstance(t, list):
            t = mesh.all_gather(t, device)
        out[f.name] = t
    return type(x)(**out)


# ---------------------------------------------------------------------------
# navigation
# ---------------------------------------------------------------------------


def _run4_dev(starts, run_start, valid, e: int):
    """(N,) run-start rows -> ((N,4) rows, (N,4) present): the <= 4
    consecutive members of each run that are valid."""
    safe = starts.clamp(min=0)
    idx = safe[:, None] + torch.arange(4, device=starts.device)[None, :]
    clip = idx.clamp(max=e - 1)
    ok = (starts >= 0)[:, None] & (idx < e) \
        & (run_start[clip] == safe[:, None]) & valid[clip]
    return clip, ok


def _nbr_tables(st: DevStatic, s: DevState, end0, end1):
    """Successor tables for both traversal strands: (Vc,2,4) neighbour
    slots / entry strands / presence (unitig.next_vertices)."""
    nbrs, strands, pres = [], [], []
    for last in (end0, end1):
        cand, ok = _run4_dev(st.nxt_link[last.clamp(min=0)],
                             st.run_start, s.valid, st.e)
        ok = ok & s.alive[:, None]
        nbr = torch.where(ok, s.vid[cand], NULL)
        enter_fwd = cand == s.start[nbr.clamp(min=0)]
        strands.append(torch.where(enter_fwd, 0, 1).to(torch.int8))
        nbrs.append(nbr)
        pres.append(ok)
    return (torch.stack(nbrs, 1), torch.stack(strands, 1),
            torch.stack(pres, 1))


def _sum4(x):
    """Row sums of an (N, 4) tensor as explicit left-to-right adds."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


# ---------------------------------------------------------------------------
# refresh (kill edges -> rebuild -> reference slot order), no host sync
# ---------------------------------------------------------------------------


def _refresh(st: DevStatic, s: DevState, to_delete, to_dfwd, to_drc,
             vc: int, set_changed: bool) -> DevState:
    """Apply marks, rebuild chains, restore reference slot semantics
    (unitig._refresh_full + _reference_order + _propagate_changed).

    Gathers that megahit_tpu leaves to XLA's index clamping are clamped
    here explicitly, so every intermediate equals megahit_tpu's."""
    e = st.e
    dev = s.valid.device
    idx = torch.arange(e, device=dev)
    rc, ref_rank = st.rc, st.ref_rank

    # ---- classify marks (unitig._classify_marks)
    n_marks = to_dfwd.to(I32) + to_drc.to(I32)
    kill_whole = ~to_delete & (n_marks > 0) & (s.length <= n_marks)
    delete = (to_delete | kill_whole) & s.alive
    disc_f = to_dfwd & ~to_delete & ~kill_whole & s.alive
    disc_r = to_drc & ~to_delete & ~kill_whole & s.alive

    # ---- kill edges (unitig._kill_edge_indices)
    kill = torch.zeros(e + 1, dtype=torch.bool, device=dev)
    kill[torch.where(disc_f, s.start, e)] = True
    kill[torch.where(disc_r, rc[s.end.clamp(min=0)], e)] = True
    kill = kill[:e] | ((s.vid >= 0) & delete[s.vid.clamp(min=0)])
    kill = kill | kill[rc]
    valid = s.valid & ~kill

    # ---- rebuild chains
    nxt, prv = simple_path_links(st.run_start, st.nxt_link, rc, valid)
    endr, _, startr, pos, mn = _list_rank(nxt, prv, st.rounds)
    in_cycle = valid & (nxt[endr] >= 0)
    chain_start = torch.where(in_cycle, mn, startr)
    chain_end = torch.where(in_cycle, prv[mn], endr)
    ce = chain_end.clamp(min=0)

    seg = torch.where(valid, chain_start, e)
    len_per_start = torch.zeros(e + 1, dtype=I32, device=dev).index_add_(
        0, seg, torch.ones(e, dtype=I32, device=dev))[:e]
    dep_per_start = torch.zeros(e + 1, dtype=I32, device=dev).index_add_(
        0, seg, st.mult)[:e]

    # disconnect-adjusted old start per old slot (_reference_order)
    adj_start = torch.where(disc_f, s.nxt[s.start.clamp(min=0)], s.start)
    is_rep = valid & (chain_start == idx)

    # per-chain min old slot (for cycles; h/t for chains)
    vid_seg = torch.where(valid & (s.vid >= 0), s.vid, vc)
    mslot = torch.full((e + 1,), vc, dtype=I64, device=dev).scatter_reduce_(
        0, seg, vid_seg, reduce="amin")[:e]

    h = s.vid                    # old slot of first edge
    t = s.vid[ce]                # old slot of last edge
    pair_start = chain_start[rc[ce]]

    # chain orientation winner: min-old-slot head; tie: adjusted start
    # edge; tie: flip of the ref_rank build orientation
    adj_h = adj_start[h.clamp(min=0)]
    r2_is_adj = pair_start == adj_h
    self_is_adj = idx == adj_h
    build_flip = ref_rank[ce] > ref_rank[rc]
    win_chain = (h < t) | (
        (h == t) & (self_is_adj | (~r2_is_adj & build_flip)))
    # palindrome (pair == self): single rep, wins
    is_self_pair = pair_start == idx
    win_chain = win_chain | is_self_pair

    # cycle winner: the strand cycle containing the min-slot member's
    # adjusted start edge, anchored there
    cyc_anchor = adj_start[mslot.clamp(0, vc - 1)]
    win_cycle = chain_start[cyc_anchor.clamp(min=0)] == idx

    win = is_rep & torch.where(in_cycle, win_cycle, win_chain)
    slot = torch.where(in_cycle, mslot, torch.minimum(h, t))
    new_start = torch.where(in_cycle, cyc_anchor, idx)
    new_end = torch.where(in_cycle, prv[cyc_anchor.clamp(min=0)],
                          chain_end)

    # ---- scatter winners into vertex slots (slot-space: dead slots
    # keep stale values); masked rows write their own pad value to row vc
    wslot = torch.where(win, slot, vc)
    alive_new = torch.zeros(vc + 1, dtype=torch.bool, device=dev)
    alive_new[wslot] = True
    alive_new = alive_new[:vc]

    def scat2(base, val, fill):
        padded = torch.cat(
            [base, torch.full((1,), fill, dtype=base.dtype, device=dev)])
        padded[wslot] = torch.where(win, val.to(base.dtype), padded[wslot])
        return padded[:vc]

    start_new = scat2(s.start, new_start, 0)
    end_new = scat2(s.end, new_end, 0)
    length_new = scat2(s.length, len_per_start, 0)
    depth_new = scat2(s.depth, dep_per_start, 0)
    loop_new = scat2(s.is_loop, in_cycle, False)
    pal_new = scat2(s.is_pal, is_self_pair, False)

    # ---- changed propagation (_propagate_changed)
    nfo = s.vid[new_start.clamp(min=0)]
    nfo_c = nfo.clamp(min=0)
    same = (nfo >= 0) & (s.length[nfo_c] == len_per_start) \
        & (s.vid[new_end.clamp(min=0)] == nfo)
    prev_changed = (nfo >= 0) & s.changed[nfo_c]
    ch_val = (~same | prev_changed) if set_changed else \
        (same & prev_changed)
    changed_new = scat2(s.changed, ch_val, False)

    # ---- per-edge vid
    slot_of_start = torch.full((e + 1,), NULL, dtype=I64, device=dev)
    wval = torch.where(win, slot, NULL)
    slot_of_start[torch.where(win, idx, e)] = wval
    slot_of_start[torch.where(win, pair_start, e)] = wval
    vid_new = torch.where(
        valid, slot_of_start[chain_start.clamp(max=e - 1)], NULL)

    return DevState(
        valid=valid, vid=vid_new, nxt=nxt, prv=prv,
        chain_start=chain_start, edge_pos=pos,
        start=start_new, end=end_new, length=length_new,
        depth=depth_new, is_loop=loop_new, is_pal=pal_new,
        alive=alive_new, changed=changed_new,
    )


# ---------------------------------------------------------------------------
# mark passes (translations of graph/cleaning.py, same tie-breaks; each
# returns mark masks + a scalar count tensor)
# ---------------------------------------------------------------------------


def _avg_depth(s: DevState):
    return check_finite("average depth",
                        s.depth.to(F32) / s.length.clamp(min=1))


def _tips_marks(st, s, end0, end1, thre):
    """cleaning.remove_tips body for one threshold."""
    nbr, _, present = _nbr_tables(st, s, end0, end1)
    outdeg = present.sum(-1)
    ind, outd = outdeg[:, 1], outdeg[:, 0]
    short = (s.length < thre) & s.alive
    avg = _avg_depth(s)
    delete = short & ~s.is_loop & (ind + outd == 0)
    for strand in (0, 1):
        one_out = short & ~s.is_loop & (outdeg[:, strand] == 1) & (
            outdeg[:, 1 - strand] == 0)
        sel = torch.where(present[:, strand], nbr[:, strand], NULL).amax(-1)
        ok = one_out & (sel >= 0)
        nb_avg = torch.where(ok, avg[sel.clamp(min=0)], 0.0)
        delete = delete | (ok & (nb_avg > 8 * avg))
    return delete, delete.sum()


def _weak_marks(st, s, end0, end1, local_ratio, vc: int):
    """cleaning.disconnect_weak_links marks. num reproduces the host's
    counting exactly: each (strand, j) batch adds its selected entries
    minus those whose target was already marked before the batch."""
    dev = s.valid.device
    nbr, nstr, present = _nbr_tables(st, s, end0, end1)
    outdeg = present.sum(-1)
    standalone = ~s.is_loop & (outdeg[:, 0] == 0) & (outdeg[:, 1] == 0)
    skip = standalone | s.is_pal | s.is_loop
    avg = _avg_depth(s)
    dfwd = torch.zeros(vc + 1, dtype=torch.bool, device=dev)
    drc = torch.zeros(vc + 1, dtype=torch.bool, device=dev)
    num = torch.zeros((), dtype=I64, device=dev)
    for strand in (0, 1):
        act = ~skip & (outdeg[:, strand] > 1) & s.alive
        pres = present[:, strand] & act[:, None]
        depths = torch.where(pres, avg[nbr[:, strand].clamp(min=0)], 0.0)
        total = check_finite("weak-link depth sum", _sum4(depths))
        weak = pres & (depths <= local_ratio * total[:, None])
        for j in range(4):
            sel = weak[:, j]
            tgt = nbr[:, strand, j]
            ts = nstr[:, strand, j]
            m0 = sel & (ts == 0)
            m1 = sel & (ts == 1)
            safe_t = tgt.clamp(min=0)
            before = (m0 & dfwd[safe_t]).sum() + (m1 & drc[safe_t]).sum()
            num = num + m0.sum() + m1.sum() - before
            dfwd[torch.where(m0, tgt, vc)] = True
            drc[torch.where(m1, tgt, vc)] = True
    return dfwd[:vc], drc[:vc], num


def _lld_marks(st, s, end0, end1, min_depth, max_len, local_width,
               local_ratio):
    """cleaning.remove_local_low_depth marks + is_changed."""
    depth = s.depth.to(F32)
    nbr, _, present = _nbr_tables(st, s, end0, end1)
    outdeg = present.sum(-1)
    ind, outd = outdeg[:, 1], outdeg[:, 0]
    standalone = ~s.is_loop & (ind == 0) & (outd == 0)
    cand = s.alive & ~standalone & (s.length <= max_len)
    cand = cand & (ind + outd > 0)
    cand = cand & (((ind <= 1) & (outd <= 1)) | (ind == 0) | (outd == 0))
    avg = _avg_depth(s)
    # _local_depth
    total = torch.zeros(depth.shape[0], dtype=F32, device=depth.device)
    edges = torch.zeros_like(total)
    for strand in (0, 1):
        pres = present[:, strand]
        nb = nbr[:, strand].clamp(min=0)
        ln = torch.where(pres, s.length[nb], 0)
        short = ln <= local_width
        contrib_e = torch.where(short, ln, local_width) * pres
        contrib_d = torch.where(
            short, torch.where(pres, depth[nb], 0.0),
            avg[nb] * local_width * pres)
        edges = edges + _sum4(contrib_e)
        total = total + _sum4(contrib_d)
    mean = check_finite("local depth mean", torch.where(
        edges > 0, total / edges.clamp(min=1), 0.0))
    threshold = check_finite("local depth threshold",
                             torch.minimum(min_depth, mean * local_ratio))
    remove = cand & (avg < threshold)
    is_changed = (cand & (min_depth < mean * local_ratio)).any() \
        | remove.any()
    return remove, remove.sum(), is_changed


def _low_depth_marks(s, min_depth):
    remove = (_avg_depth(s) < min_depth) & s.alive
    return remove, remove.sum()


def _bubble_shape(st, s, end0, end1, max_len):
    """cleaning._find_bubble_instances, both strands at once.

    Returns per-(vertex, strand): ok, right slot, right strand, and the
    (4,) middle slots / strands / presence SORTED by the reference keep
    order (avg depth desc, canonical edge id asc); and avg, cid."""
    nbr, nstr, present = _nbr_tables(st, s, end0, end1)
    vc = nbr.shape[0]
    outdeg = present.sum(-1)
    standalone = ~s.is_loop & (outdeg[:, 0] == 0) & (outdeg[:, 1] == 0)
    base = (outdeg > 1).any(1) & ~s.is_loop & ~standalone & s.alive
    avg = _avg_depth(s)
    cid = torch.minimum(st.ref_rank[s.start.clamp(min=0)],
                        st.ref_rank[st.rc[s.end.clamp(min=0)]])
    ar4 = torch.arange(4, device=nbr.device)
    # (Vc*2, .) views: row 2*v + strand
    nbr_rows = nbr.reshape(vc * 2, 4)
    nstr_rows = nstr.reshape(vc * 2, 4)
    outdeg_flat = outdeg.reshape(-1)

    out = {name: [] for name in ("ok", "right", "rstr", "mids", "mstr",
                                 "pres")}
    for strand in (0, 1):
        degree = outdeg[:, strand]
        active = base & (degree > 1)
        mids = nbr[:, strand]
        mstr = nstr[:, strand].to(I64)
        pres = present[:, strand]
        safe = mids.clamp(min=0)
        ok = active & ~(pres & (s.length[safe] > max_len)).any(1)
        od_fwd = outdeg_flat[2 * safe + mstr]
        od_rev = outdeg_flat[2 * safe + 1 - mstr]
        ok = ok & ~(pres & ((od_fwd != 1) | (od_rev != 1))).any(1)

        # each middle's successors on its entry strand: (Vc, 4, 4)
        r_nbr = nbr_rows[2 * safe + mstr]
        r_str = nstr_rows[2 * safe + mstr]
        rv = r_nbr.amax(-1)
        first_max = torch.where(r_nbr == rv[..., None], ar4, 4).amin(-1)
        rs = r_str.gather(-1, first_max[..., None])[..., 0]
        first_slot = torch.where(pres, ar4, 4).amin(1)
        first_slot = torch.where(first_slot == 4, 0, first_slot)
        rv0 = rv.gather(1, first_slot[:, None])[:, 0]
        rs0 = rs.gather(1, first_slot[:, None])[:, 0]
        ok = ok & ~(pres & ((rv != rv0[:, None]) | (rs != rs0[:, None]))
                    ).any(1)
        safe_r = rv0.clamp(min=0)
        r_deg = outdeg_flat[2 * safe_r + 1 - rs0.to(I64)]
        ok = ok & (rv0 >= 0) & (cid[safe_r] >= cid) & (r_deg == degree)

        # sort middles by (avg desc, cid asc), absents last: two stable
        # sorts, the secondary key first (numpy's lexsort order)
        avgm = torch.where(pres, avg[safe], -torch.inf)
        midv = torch.where(pres, cid[safe], torch.iinfo(I32).max)
        o1 = torch.sort(midv, dim=1, stable=True).indices
        neg = (-avgm).gather(1, o1) + 0.0  # + 0.0: no -0.0 keys
        order = o1.gather(1, torch.sort(neg, dim=1, stable=True).indices)
        out["mids"].append(mids.gather(1, order))
        out["mstr"].append(nstr[:, strand].gather(1, order))
        out["pres"].append(pres.gather(1, order))
        out["ok"].append(ok)
        out["right"].append(rv0)
        out["rstr"].append(rs0)
    return ({k: torch.stack(v, 1) for k, v in out.items()}, avg, cid)


def _naive_bubble_marks(ok2, mids2, pres2, vc: int):
    """Union of non-keep present middles over all instances (order-free:
    marking is a monotone set union; the host's sequential scan order
    only affects record emission, which the naive path has none of)."""
    tgt = torch.where(ok2[:, :, None] & pres2[:, :, 1:], mids2[:, :, 1:],
                      vc)
    marks = torch.zeros(vc + 1, dtype=torch.bool, device=ok2.device)
    marks[tgt.reshape(-1)] = True
    return marks[:vc]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class DeviceCleaner:
    """Holds the device state and runs cleaning passes.

    Mirrors the graph/cleaning.py API (through pipeline.assemble's
    engine interface); construct from a freshly built host graph (the
    initial build + reference ordering happen once on the host), then
    every pass runs on the graph's device.
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
        self.static = _upload_static(g.sdbg)
        self.state = _upload_state(g, self.vc)
        self._host_graph_template = g

    # -- state at rest: whole, or the mesh's row blocks ---------------

    @property
    def static(self) -> DevStatic:
        if self.mesh is None:
            return self._static
        return _gather_blocks(self._static, self.mesh, self.dev)

    @static.setter
    def static(self, st: DevStatic) -> None:
        self._static = st if self.mesh is None \
            else _shard_blocks(st, self.mesh)

    @property
    def state(self) -> DevState:
        if self.mesh is None:
            return self._state
        return _gather_blocks(self._state, self.mesh, self.dev)

    @state.setter
    def state(self, s: DevState) -> None:
        self._state = s if self.mesh is None \
            else _shard_blocks(s, self.mesh)

    # -- helpers ----------------------------------------------------

    def _f32(self, x) -> torch.Tensor:
        return torch.tensor(x, dtype=F32, device=self.dev)

    def _i32(self, x) -> torch.Tensor:
        return torch.tensor(x, dtype=I32, device=self.dev)

    @staticmethod
    def _ends(st: DevStatic, s: DevState):
        """(end0, end1): the last edge of each vertex's forward chain
        and of its rc chain (rc_end = rc[start])."""
        return s.end, st.rc[s.start.clamp(min=0)]

    def _refresh(self, st, s, to_delete, to_dfwd, to_drc,
                 set_changed: bool):
        self.state = _refresh(st, s, to_delete, to_dfwd, to_drc, self.vc,
                              set_changed)

    def _zeros_v(self):
        return torch.zeros(self.vc, dtype=torch.bool, device=self.dev)

    # -- cleaning passes (graph/cleaning.py API) --------------------

    def remove_tips(self, max_tip_len: int) -> int:
        num = 0
        thre = 2
        while thre < max_tip_len:
            st, s = self.static, self.state
            end0, end1 = self._ends(st, s)
            delete, n = _tips_marks(st, s, end0, end1, self._i32(thre))
            n = int(n)
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
        dfwd, drc, n = _weak_marks(st, s, end0, end1,
                                   self._f32(local_ratio), self.vc)
        n = int(n)
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
            st, s, end0, end1, self._f32(min_depth),
            self._i32(max_len), self._i32(local_width),
            self._f32(local_ratio))
        n, is_changed = torch.stack([n, is_changed.to(n.dtype)]).tolist()
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
        t0 = time.monotonic()
        while min_depth < KMAX_MUL:
            n, changed = self.remove_local_low_depth(
                min_depth, min_len, local_width, local_ratio, permanent)
            passes += 1
            if not changed:
                break
            total += n
            min_depth *= 1.1
        get_logger().info("local low depth: %d passes on the device, %.2fs",
                          passes, time.monotonic() - t0)
        return total

    def remove_low_depth(self, min_depth: float) -> int:
        st, s = self.static, self.state
        remove, n = _low_depth_marks(s, self._f32(min_depth))
        n = int(n)
        # the host path always refreshes here (set_changed=False), but
        # a refresh with no marks is the identity
        if n:
            self._refresh(st, s, remove, self._zeros_v(), self._zeros_v(),
                          set_changed=False)
        return n

    # -- bubbles ----------------------------------------------------

    def _vertex_codes(self, s: DevState, vs: np.ndarray, nxt: np.ndarray
                      ) -> dict[int, np.ndarray]:
        """Host base codes of the given vertex slots (forward chain
        orientation; loops walk their intact nxt cycle from the anchor),
        from a native chain walk over the downloaded nxt."""
        from ..native import collect_chain_edges

        if len(vs) == 0:
            return {}
        vt = torch.from_numpy(vs).to(self.dev)
        se = torch.stack([s.start[vt], s.length[vt].to(I64)]).cpu().numpy()
        start, lens = se[0], se[1]
        eidx = collect_chain_edges(nxt, start, lens)
        if eidx is None:
            raise RuntimeError(
                "the native chain walk (native/graphwalk.cpp) did not "
                "build; the device cleaning engine needs it")
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
        st, s = self.static, self.state
        end0, end1 = self._ends(st, s)
        shape, avg_d, cid_d = _bubble_shape(st, s, end0, end1,
                                            self._i32(max_len))
        ok2_np = shape["ok"].cpu().numpy()  # (Vc, 2) bool download
        n_inst = int(ok2_np.sum())
        if n_inst == 0:
            # the host path refreshes with no marks: the identity
            return 0

        if similarity is None and careful_threshold is None:
            # fully device marking: union of non-keep present middles
            delete = _naive_bubble_marks(shape["ok"], shape["mids"],
                                         shape["pres"], self.vc)
            n = int(delete.sum())
            if n:
                self._refresh(st, s, delete, self._zeros_v(),
                              self._zeros_v(), set_changed=not permanent)
            return n

        # host sequential part over the (small) instance list, in the
        # reference scan order (left slot asc, strand asc); only (I, .)
        # and (Vc,) results cross to the host
        lv, sv = np.nonzero(ok2_np)
        lt = torch.from_numpy(lv).to(self.dev)
        svt = torch.from_numpy(sv).to(self.dev)
        inst = torch.cat([
            shape["mids"][lt, svt], shape["mstr"][lt, svt].to(I64),
            shape["pres"][lt, svt].to(I64), shape["right"][lt, svt][:, None],
        ], 1).cpu().numpy()
        mids, mstrs = inst[:, 0:4], inst[:, 4:8]
        press, rights = inst[:, 8:12].astype(bool), inst[:, 12]
        flip_d = st.ref_rank[st.rc[s.end.clamp(min=0)]] \
            < st.ref_rank[s.start.clamp(min=0)]
        avg = avg_d.cpu().numpy()
        flip = flip_d.cpu().numpy()
        clen = s.length.cpu().numpy().astype(np.int64) + self.k - 1
        keeps = mids[:, 0]
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
                nxt = s.nxt.to(I32).cpu().numpy()
            codes_of.update(self._vertex_codes(s, need, nxt))

        def vstring(v, strand):
            c = codes_of[int(v)]
            return packing.revcomp_codes(c) if strand == 1 else c

        sim_ok = np.ones(len(lv), dtype=bool)
        if similarity is not None:
            from .cleaning import banded_similarity_batch

            pairs = []  # (instance, keep, keep strand, v, v strand)
            for i in range(len(lv)):
                a_len = clen[keeps[i]]
                for j in range(1, 4):
                    if not press[i, j]:
                        continue
                    b_len = clen[mids[i, j]]
                    if not (b_len * similarity <= a_len
                            and a_len * similarity <= b_len):
                        sim_ok[i] = False
                        break
                    pairs.append((i, keeps[i], mstrs[i, 0], mids[i, j],
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
        for i in range(len(lv)):
            if not sim_ok[i]:
                continue
            keep_v = int(keeps[i])
            rec = []
            for j in range(1, 4):
                if not press[i, j]:
                    continue
                v = int(mids[i, j])
                if not marked[v]:
                    marked[v] = True
                    num_removed += 1
                if careful and avg[v] >= avg[keep_v] * careful_threshold:
                    rec.append(v)
            if rec:
                records.append((*rec, int(lv[i]), int(rights[i])))
        if records:
            fetch([v for r in records for v in r])
            for r in records:
                for v in r:
                    c = vstring(v, 1 if flip[v] else 0)
                    bubble_records.append((packing.decode(c),
                                           float(avg[v])))
        if num_removed:
            self._refresh(st, s, torch.from_numpy(marked).to(self.dev),
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

        def host(t, dtype):
            return t.cpu().numpy().astype(dtype)

        sdbg = self.sdbg
        sdbg.valid = s.valid.cpu().numpy().copy()
        sdbg._rvc = None
        start = host(s.start, np.int32)
        end = host(s.end, np.int32)
        g = UnitigGraph(
            g0.k, sdbg, start, end,
            sdbg.rc[end].astype(np.int32), sdbg.rc[start].astype(np.int32),
            host(s.length, np.int32), host(s.depth, np.int64),
            s.is_loop.cpu().numpy(), s.is_pal.cpu().numpy(),
            host(s.vid, np.int32),
            chain_start=host(s.chain_start, np.int32),
            edge_pos=host(s.edge_pos, np.int32),
            nxt=host(s.nxt, np.int32), prv=host(s.prv, np.int32),
        )
        g.alive = s.alive.cpu().numpy()
        g.changed = s.changed.cpu().numpy()
        # slot-space arrays are Vc-capacity; host consumers mask alive
        return g
