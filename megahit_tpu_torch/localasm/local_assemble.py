"""Paired-end local assembly (gap filling).

Reference: src/localasm/local_assemble.cpp RunLocalAssembly - map all
reads to contigs with the sparse seed mapper, estimate insert sizes
from concordant pairs, collect reads hanging off contig ends (plus
stray mates of end-anchored reads), and mini-assemble each contig end's
read set; the `.local.fa` contigs seed the next-k graph.

Mapping scans on the host (native seed scan) and scores on the device
(see mapper.py); the per-end IDBA runs collapse into one group-batched
graph per k on the host (see mini_asm.py). Counterpart of
megahit_tpu/localasm/local_assemble.py.
"""

from __future__ import annotations

import numpy as np

from ..io.contig_io import ContigRecord
from ..io.lib import SequenceLib
from ..utils.histogram import Histogram
from ..utils.log import get_logger
from .mapper import MapResult, build_seed_index, map_reads
from .mini_asm import mini_assemble

MAX_LOCAL_RANGE = 650  # reference kMaxLocalRange (local_assemble.cpp:25)
MIN_LOCAL_CONTIG = 200  # LocalAsmOption.min_contig_len
LOCAL_KMIN, LOCAL_KMAX, LOCAL_STEP = 11, 41, 6


def estimate_insert_sizes(
    lib: SequenceLib, res: MapResult
) -> list[tuple[float, float]]:
    """Per-library (mean, sd) of insert size from concordant pairs
    (reference EstimateInsertSize, local_assemble.cpp:83-138; 1%
    trimmed)."""
    log = get_logger()
    out = []
    lengths = lib.lengths
    for begin, end, is_paired in lib.lib_ranges:
        if not is_paired:
            out.append((0.0, 0.0))
            continue
        i = np.arange(begin, end - 1, 2)
        j = i + 1
        ok = (res.valid[i] & res.valid[j]
              & (res.contig_id[i] == res.contig_id[j])
              & (res.strand[i] != res.strand[j]))
        i, j = i[ok], j[ok]
        ins = np.where(
            res.strand[i] == 0,
            res.contig_to[j] + lengths[j] - res.query_to[j]
            - (res.contig_from[i] - res.query_from[i]),
            res.contig_to[i] + lengths[i] - res.query_to[i]
            - (res.contig_from[j] - res.query_from[j]),
        )
        ins = ins[(ins >= lengths[i]) & (ins >= lengths[j])]
        if len(ins) == 0:
            out.append((0.0, 0.0))
            continue
        hist = Histogram(ins)
        hist.trim(0.01)  # unconditional (local_assemble.cpp:130)
        out.append((hist.mean(), hist.sd()))
        log.info("lib [%d,%d): insert size %.2f sd %.2f",
                 begin, end, out[-1][0], out[-1][1])
    return out


def local_range_for(lib_range, lengths, insert_size) -> int:
    """Reference LocalRange (local_assemble.cpp:140-153)."""
    begin, end, is_paired = lib_range
    max_len = int(lengths[begin:end].max()) if end > begin else 0
    lr = max_len - 1
    mean, sd = insert_size
    if is_paired and mean >= max_len:
        lr = int(min(2 * mean, mean + 3 * sd))
    return min(lr, MAX_LOCAL_RANGE)


def collect_mappings(
    lib: SequenceLib,
    res: MapResult,
    insert_sizes,
    contig_lens: np.ndarray,
):
    """Per (contig, side) read collections (reference
    MappingResultCollector AddSingle/AddMate), fully vectorized.

    Returns dict[(cid, side)] -> (pos, is_mate, rid) arrays sorted by
    the reference's encoded order (pos, is_mate, mismatch, strand,
    read_id); side 0 = contig start, side 1 = contig end."""
    lengths = lib.lengths
    cols = {k: [] for k in ("cid", "side", "pos", "mate", "rid",
                            "mm", "st")}

    def add(cid, side, pos, is_mate, rid, mm, st):
        cols["cid"].append(cid.astype(np.int64))
        cols["side"].append(np.full(len(cid), side, np.int8))
        cols["pos"].append(pos.astype(np.int64))
        cols["mate"].append(np.full(len(cid), is_mate, np.int8))
        cols["rid"].append(rid.astype(np.int64))
        cols["mm"].append(mm.astype(np.int64))
        cols["st"].append(st.astype(np.int64))

    for li, rng in enumerate(lib.lib_ranges):
        begin, end, is_paired = rng
        lr = local_range_for(rng, lengths, insert_sizes[li])
        ids = np.arange(begin, end)
        ids = ids[res.valid[ids]]
        if len(ids) == 0:
            continue
        cid = res.contig_id[ids]
        cl = contig_lens[cid]
        rl = lengths[ids]
        cfrom, cto = res.contig_from[ids], res.contig_to[ids]
        qfrom, qto = res.query_from[ids], res.query_to[ids]
        mm, st = res.mismatch[ids], res.strand[ids]

        f = (cto < lr) & (qfrom != 0) & (qto == rl - 1)
        b = ~f & (cfrom + lr >= cl) & (qto < rl - 1) & (qfrom == 0)
        add(cid[f], 0, cto[f], 0, ids[f], mm[f], st[f])
        add(cid[b], 1, (cl - 1 - cfrom)[b], 0, ids[b], mm[b], st[b])

        if is_paired:
            mate = begin + ((ids - begin) ^ 1)
            ok = ~(res.valid[mate] & (res.contig_id[mate] == cid))
            mf = ok & (cto < lr) & (st == 1)
            mb = ok & ~mf & (cfrom + lr >= cl) & (st == 0)
            add(cid[mf], 0, cto[mf], 1, mate[mf], mm[mf], st[mf])
            add(cid[mb], 1, (cl - 1 - cfrom)[mb], 1, mate[mb],
                mm[mb], st[mb])

    out: dict[tuple[int, int], tuple] = {}
    if not cols["cid"]:
        return out
    c = {k: np.concatenate(v) for k, v in cols.items()}
    if len(c["cid"]) == 0:
        return out
    order = np.lexsort((c["rid"], c["st"], c["mm"], c["mate"],
                        c["pos"], c["side"], c["cid"]))
    for k in c:
        c[k] = c[k][order]
    key = c["cid"] * 2 + c["side"]
    bounds = np.flatnonzero(
        np.concatenate([[True], key[1:] != key[:-1]])
    )
    ends = np.concatenate([bounds[1:], [len(key)]])
    for s, e in zip(bounds, ends):
        out[(int(c["cid"][s]), int(c["side"][s]))] = (
            c["pos"][s:e], c["mate"][s:e], c["rid"][s:e]
        )
    return out


def run_local_assembly(
    lib: SequenceLib,
    contigs: list[ContigRecord],
    local_kmax: int = LOCAL_KMAX,
    device="cuda",
) -> list[ContigRecord]:
    """Full local assembly pass; returns local contig records
    (reference RunLocalAssembly, local_assemble.cpp:306-347). The seed
    index and the mapper's scores run on `device`."""
    from ..io.contig_io import FLAG_LOOP

    log = get_logger()
    # the reference mapper discards loop contigs (hash_mapper.cpp:60
    # SetDiscardFlag(kLoop)) and contigs shorter than min_contig_len
    # (local_assemble.cpp:311 LoadAndBuild(..., opt.min_contig_len, ..)):
    # circular contigs have no ends to extend, short ones are noise
    contigs = [
        c for c in contigs
        if not (c.flag & FLAG_LOOP) and c.length >= MIN_LOCAL_CONTIG
        # (reader drops seq.l < min_len, contig_reader.h:62)
    ]
    contig_codes = [c.codes for c in contigs]
    if not contigs or lib.num_seqs == 0:
        return []
    index = build_seed_index(contig_codes, device=device)
    res = map_reads(lib.pool, lib.starts, index, device=device)
    insert_sizes = estimate_insert_sizes(lib, res)
    contig_lens = np.array([len(c) for c in contig_codes])
    entries = collect_mappings(lib, res, insert_sizes, contig_lens)

    max_read_len = lib.max_len
    max_lr = max(
        (local_range_for(r, lib.lengths, insert_sizes[i])
         for i, r in enumerate(lib.lib_ranges)), default=0,
    )
    min_num_reads = max_lr // max_read_len if max_read_len > 0 else 1

    groups_reads: list[list[np.ndarray]] = []
    contig_ends: list[np.ndarray] = []
    group_meta: list[tuple[int, int]] = []
    for (cid, side), (pos, _mate, rid) in entries.items():
        if len(pos) <= min_num_reads:
            continue
        # <=3 reads per mapping position (reference :260-275)
        new_pos = np.concatenate([[True], pos[1:] != pos[:-1]])
        gidx = np.cumsum(new_pos) - 1
        rank = np.arange(len(pos)) - np.flatnonzero(new_pos)[gidx]
        keep = rid[rank < 3]
        reads = [lib.seq(r) for r in keep]
        codes = contig_codes[cid]
        cl = len(codes)
        end_len = min(max_lr, cl)
        ce = codes[:end_len] if side == 0 else codes[cl - end_len:]
        groups_reads.append(reads)
        contig_ends.append(ce)
        group_meta.append((cid, side))

    if not groups_reads:
        log.info("local assembly: no eligible contig ends")
        return []
    log.info("local assembly: %d contig ends, %d reads",
             len(groups_reads), sum(map(len, groups_reads)))
    result = mini_assemble(
        groups_reads, contig_ends, LOCAL_KMIN, local_kmax, LOCAL_STEP
    )

    out: list[ContigRecord] = []
    for g, (cid, side) in enumerate(group_meta):
        for j, codes in enumerate(result[g]):
            if len(codes) > MIN_LOCAL_CONTIG and len(codes) > local_kmax:
                out.append(ContigRecord(
                    codes, 0, len(out), 0, 1.0
                ))
    log.info("local assembly: %d local contigs", len(out))
    return out
