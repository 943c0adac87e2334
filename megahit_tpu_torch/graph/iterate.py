"""Multi-k iteration: seed (k+step+1)-mer edges from reads spanning
contig junctions.

Reference: ContigFlankIndex (src/iterate/contig_flank_index.h) + the
`iterate` subprogram (src/main_iterate.cpp). Semantics: index the first
(k+1)-mer of each contig strand ("flank") together with up to step-1
following bases ("extension") and the contig's multiplicity; scan every
read, marking node positions whose (k+1)-mer is a flank (either strand)
or is validated by a flank's extension; every run of step+1 consecutive
marked positions emits the read's (k+step+1)-mer over that run - these
junction-spanning edges connect contigs in the next-k graph.

The scan is the native rolling-window seed scan (native/seedscan.cpp,
threaded over read ranges); the greedy left-to-right skip of the
reference is emulated exactly on the sparse hits; the emitted
(k+step+1)-mers are gathered and canonicalized on the device.

Junction-edge multiplicity is 0, matching the reference exactly: its
FeedBatchContigs receives the contig mul but never stores it
(contig_flank_index.h:64 constructs FlankInfo{ext_seq, ext_len},
zero-initializing .mul), so the windowed average always rounds to 0.

Counterpart of megahit_tpu/graph/iterate.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import kmerops, packing
from ..utils.device import resolve_device
from ..utils.log import get_logger


@dataclass
class FlankIndex:
    k: int
    step: int
    keys: np.ndarray  # (F, W1) sorted (k+1)-mer keys
    ext_bases: np.ndarray  # (F, step-1) uint8, 255 = unused
    ext_len: np.ndarray  # (F,) int32
    mul: np.ndarray  # (F,) float32

    @property
    def size(self) -> int:
        return len(self.keys)


def build_flank_index(
    contigs: list[np.ndarray],
    muls: list[float] | np.ndarray,
    k: int,
    step: int,
) -> FlankIndex:
    """Index both-strand flank (k+1)-mers of contigs (host numpy).

    Keeps, per distinct flank k-mer, the longest extension (ties: the
    larger packed extension value - reference FeedBatchContigs,
    contig_flank_index.h:63-74).
    """
    k1 = k + 1
    w = kmerops.words_per_kmer(k1)
    ext_cap = max(step - 1, 1)
    rows_k: list[np.ndarray] = []
    rows_e: list[np.ndarray] = []
    rows_l: list[int] = []
    rows_m: list[float] = []
    for codes, m in zip(contigs, muls):
        L = len(codes)
        if L < k1:
            continue
        for strand in (0, 1):
            s = codes if strand == 0 else packing.revcomp_codes(codes)
            flank = s[:k1]
            rc = packing.revcomp_codes(flank)
            if np.array_equal(flank, rc):
                continue  # palindrome flanks are skipped
            ext_len = min(step - 1, L - k1)
            ext = np.full(ext_cap, 255, dtype=np.uint8)
            ext[:ext_len] = s[k1 : k1 + ext_len]
            rows_k.append(packing.pack_codes(flank)[:w])
            rows_e.append(ext)
            rows_l.append(ext_len)
            rows_m.append(float(m))
            if L == k1:
                break
    if not rows_k:
        return FlankIndex(
            k, step, np.zeros((0, w), np.uint32),
            np.zeros((0, ext_cap), np.uint8), np.zeros(0, np.int32),
            np.zeros(0, np.float32),
        )
    keys = np.stack(rows_k).astype(np.uint32)
    ext_b = np.stack(rows_e)
    ext_l = np.array(rows_l, dtype=np.int32)
    mul = np.array(rows_m, dtype=np.float32)

    # dedup: per key keep (max ext_len, then max packed ext value)
    ext_val = np.zeros(len(keys), dtype=np.uint64)
    for j in range(ext_cap):
        b = np.where(ext_b[:, j] == 255, 0, ext_b[:, j]).astype(np.uint64)
        ext_val |= b << np.uint64(2 * j)
    order = np.lexsort(
        (-ext_val.astype(np.int64), -ext_l,)
        + tuple(keys[:, i] for i in range(w - 1, -1, -1))
    )
    keys, ext_b, ext_l, mul = (
        keys[order], ext_b[order], ext_l[order], mul[order]
    )
    head = np.ones(len(keys), dtype=bool)
    head[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    return FlankIndex(
        k, step, keys[head], ext_b[head], ext_l[head], mul[head]
    )


def _fwd_extension(pool, hpos, hfv, rows, read_end, index, k1):
    """Yield (j, rows) for j = 0.. while the forward-hit rows still match
    their flank's extension base j at read position p + k1 + j."""
    for j in range(index.step - 1):
        rows = rows[hpos[rows] + k1 + j < read_end[rows]]
        if len(rows) == 0:
            return
        h = hfv[rows]
        rows = rows[
            (pool.bases_at(hpos[rows] + k1 + j) == index.ext_bases[h, j])
            & (j < index.ext_len[h])
        ]
        yield j, rows


def find_next_kmers(
    flat_codes,
    starts: np.ndarray,
    index: FlankIndex,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Scan the read pool against the flank index.

    Returns (keys (M, W2) canonical (k+step+1)-mers deduplicated with
    max multiplicity, muls (M,) int32). The emitted windows are gathered
    and canonicalized on `device`. Raises if the native scan library
    cannot be built."""
    device = resolve_device(device)
    log = get_logger()
    k, step = index.k, index.step
    k1, k2 = k + 1, k + step + 1
    w2 = kmerops.words_per_kmer(k2)
    n_bases = int(starts[-1])
    empty = (np.zeros((0, w2), np.uint32), np.zeros(0, np.int32))
    if n_bases < k2 or index.size == 0:
        return empty

    from ..native import SCAN_BOTH, seed_scan
    from .counter import as_pool

    w1 = kmerops.words_per_kmer(k1)
    pool = as_pool(flat_codes)
    packed_np = np.concatenate(
        [pool.window_padded(0, pool.n_words),
         np.zeros(max(w1, w2) + 1, dtype=np.uint32)]
    )
    # native rolling-window scan: fwd + rc probes, threaded over read
    # ranges; hits arrive position-sorted (the greedy-skip emulation
    # depends on it) with the window inside its read
    hpos, hrid, hfv, hrv, _ = seed_scan(packed_np, starts, k1,
                                        index.keys, SCAN_BOTH)
    hpos = hpos.astype(np.int64)
    hrid = hrid.astype(np.int64)
    read_start_h = starts[hrid]
    read_end_h = starts[hrid + 1]

    # forward-extension match length per fwd-hit row
    n_hits = len(hpos)
    m_fwd = np.zeros(n_hits, dtype=np.int32)
    for j, rows in _fwd_extension(pool, hpos, hfv, np.flatnonzero(hfv >= 0),
                                  read_end_h, index, k1):
        m_fwd[rows] = j + 1

    # the reference scans each read LEFT-TO-RIGHT and skips lookups at
    # positions covered by an earlier forward extension (next_pos
    # advances past matched bases, contig_flank_index.h:113-170): a hit
    # is PERFORMED iff its position is not inside a previously-performed
    # hit's forward-extension jump (hpos is ascending)
    performed = np.zeros(n_hits, dtype=bool)
    skip_until = -1
    for r, (p, rs, hf, m) in enumerate(zip(
        hpos.tolist(), read_start_h.tolist(),
        (hfv >= 0).tolist(), m_fwd.tolist(),
    )):
        if rs > skip_until:
            skip_until = -1  # new read resets the jump
        if p <= skip_until:
            continue
        performed[r] = True
        if hf:
            skip_until = p + m

    # marked positions (sparse): performed hits + their extension
    # targets (forward: p+1..p+m; rc: p-1-j for matched prefix bases)
    mark_parts = [hpos[performed]]
    for j, rows in _fwd_extension(
            pool, hpos, hfv, np.flatnonzero((hfv >= 0) & performed),
            read_end_h, index, k1):
        tgt = hpos[rows] + j + 1
        mark_parts.append(tgt[tgt + k1 <= read_end_h[rows]])

    rows = np.flatnonzero((hrv >= 0) & performed)
    for j in range(step - 1):
        rows = rows[hpos[rows] - 1 - j >= read_start_h[rows]]
        if len(rows) == 0:
            break
        h = hrv[rows]
        rows = rows[
            ((3 - pool.bases_at(hpos[rows] - 1 - j)) == index.ext_bases[h, j])
            & (j < index.ext_len[h])
        ]
        mark_parts.append(hpos[rows] - 1 - j)

    marks = np.unique(np.concatenate(mark_parts))
    if len(marks) == 0:
        return empty

    # runs of step+1 consecutive marked positions -> emit the read's
    # (k2)-mer at every window covering a full run stretch
    brk = np.flatnonzero(np.concatenate([[True], np.diff(marks) != 1]))
    run_s = marks[brk]
    run_e = marks[np.concatenate([brk[1:] - 1, [len(marks) - 1]])]
    n_win = run_e - run_s - step + 1  # windows [s, e-step]
    keep = n_win > 0
    run_s, n_win = run_s[keep], n_win[keep]
    if len(run_s) == 0:
        return empty
    total = int(n_win.sum())
    a_list = np.repeat(run_s, n_win) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(n_win) - n_win, n_win)
    )
    # the emitted (k2)-window must lie inside one read
    arid = np.searchsorted(starts, a_list, side="right") - 1
    a_list = a_list[a_list + k2 <= starts[arid + 1]]
    if len(a_list) == 0:
        return empty
    mul_list = np.zeros(len(a_list), dtype=np.int32)

    # gather + canonicalize the emitted (k2)-mers on the device
    keys = kmerops.extract_kmers(
        kmerops.to_torch(packed_np, device),
        torch.from_numpy(a_list).to(device), k2)
    canon, _ = kmerops.canonical_kmers(keys, k2)
    keys_all = kmerops.to_numpy(canon)

    order = np.lexsort(
        (-mul_list,) + tuple(keys_all[:, i] for i in range(w2 - 1, -1, -1))
    )
    keys_all, mul_list = keys_all[order], mul_list[order]
    head = np.ones(len(keys_all), dtype=bool)
    head[1:] = (keys_all[1:] != keys_all[:-1]).any(axis=1)
    log.info(
        "iterate k=%d+%d: %d junction windows -> %d distinct edges",
        k, step, len(a_list), int(head.sum()),
    )
    return keys_all[head], mul_list[head]
