"""Mercy k-mer rescue.

Reference semantics (SeqToSdbg::GenMercyEdges, seq_to_sdbg.cpp:171-357):
for every candidate read, each node position i (k-mer = read[i:i+k]) is
flagged has_in if some solid edge ends with that k-mer and has_out if
some solid edge starts with it. Scanning left to right, a maximal run of
positions between the latest in-only position `a` and the next flagged
position `b` with status(b) = out-only donates the read's (k+1)-mers at
windows [a, b) as multiplicity-1 "mercy" edges.

k-mer extraction, the node table at k <= 31 (the distinct k-prefixes
and k-suffixes of the solid edges) and the membership queries run as
torch ops on the given device, which hands back one byte a position;
the candidate reads (the native seed scan) and the gap state machine
run on the host. Its steps are child spans of the caller's open span:
candidates (with rare keys at k <= 31), node_table, flag_scan and emit.
Counterpart of megahit_tpu/graph/mercy.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import kmerops
from ..utils.device import resolve_device
from ..utils.log import get_logger
from ..utils.timers import count, span

def _neighbor_flags(packed: torch.Tensor, solid_keys: torch.Tensor,
                    k: int, k1: int):
    """has_in/has_out for the k-mer at every base offset of `packed`
    (device path for k > 31: 8 canonical membership queries)."""
    kmers = kmerops.extract_all_kmers(packed, k)
    q = kmers.shape[0]
    has_in = torch.zeros(q, dtype=torch.bool, device=packed.device)
    has_out = torch.zeros_like(has_in)
    for c in range(4):
        q_in, _ = kmerops.canonical_kmers(
            kmerops.prepend_base(kmers, c, k1), k1)
        q_out, _ = kmerops.canonical_kmers(
            kmerops.mask_tail(kmerops.set_base(kmers, k, c), k1), k1)
        _, f_in = kmerops.searchsorted_keys(solid_keys, q_in)
        _, f_out = kmerops.searchsorted_keys(solid_keys, q_out)
        has_in |= f_in
        has_out |= f_out
    return has_in, has_out


def _node_sets(solid_keys: np.ndarray, k1: int, device):
    """Union table of the k-prefixes and k-suffixes of both strands of
    the solid edge set, built with torch ops on `device`, with a per-row
    2-bit flag (1 = prefix: some solid edge starts with it; 2 = suffix:
    some solid edge ends with it). Returned on `device` as ascending
    int64 node keys (`_node_keys` form) and uint8 flags, for one binary
    search per query with no canonicalization.

    A k-mer with k <= 31 leaves the low 2 bits of its key zero, so each
    row carries its side there (0 prefix, 1 suffix) and one torch.unique
    sorts and dedupes both sides at once: a node is then one row or a
    prefix row followed by a suffix row."""
    k = k1 - 1
    keys = kmerops.to_torch(solid_keys, device)
    both = torch.cat([keys, kmerops.revcomp_kmers(keys, k1)])
    del keys
    prefixes = _node_keys(kmerops.mask_tail(both, k))
    suffixes = _node_keys(kmerops.mask_tail(
        kmerops.drop_first_base(both, k1), k))
    del both
    rows = torch.unique(torch.cat([prefixes, suffixes | 1]))
    del prefixes, suffixes
    node = rows & ~3
    bit = (rows & 1) + 1
    # a suffix row right after its node's prefix row adds flag 2 to it
    bit[:-1] |= torch.where(node[1:] == node[:-1], bit[1:], 0)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = node[1:] != node[:-1]
    return node[first], bit[first].to(torch.uint8)


def _node_keys(kmers: torch.Tensor) -> torch.Tensor:
    """(N, W <= 2) int64 k-mer words -> one int64 each whose signed order
    is the k-mers' order (pack_sort_keys: word 0's top bit flipped)."""
    return kmerops.pack_sort_keys(kmers.unbind(1))[0]


def _node_flags(table: torch.Tensor, flags: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Per-query node flags on the table's device: flags[i] where
    table[i] == q, else 0 (uint8)."""
    if len(table) == 0:
        return torch.zeros(len(q), dtype=torch.uint8, device=q.device)
    i = torch.searchsorted(table, q).clamp_(max=len(table) - 1)
    return torch.where(table[i] == q, flags[i], 0)


def _chunk_windows(packed_np, n_bases, w, chunk_bases):
    """(lo, lo_w, size, span) per word-aligned chunk of the pool."""
    n_dense = (len(packed_np) - w) * 16
    for lo in range(0, n_bases, chunk_bases):
        hi = min(n_dense, lo + chunk_bases)
        lo_w = lo // 16
        size = min((hi + 15) // 16 + w + 1, len(packed_np)) - lo_w
        span = min(min(hi, n_bases) - lo, (size - w) * 16)
        yield lo, lo_w, size, span
        if hi >= n_dense:
            break


def _dense_status(packed, packed_np, table, tflags, starts, k, k1,
                  chunk_bases) -> np.ndarray:
    """Every pool position's node status (1 in-only, 2 out-only, 3 stop),
    made on the device a chunk at a time and downloaded as one int8 a
    position. A window that crosses its read's end is a hard reset
    (status 3), and so is every position of a read shorter than k + 2
    (reference seq_to_sdbg.cpp:202 `read_len < opt_.k + 2`). Flags come
    from the node table at k <= 31 (`tflags` given), else from eight
    canonical queries of the solid set (`_neighbor_flags`)."""
    n_bases = int(starts[-1])
    dev = packed.device
    w = kmerops.words_per_kmer(k1)
    rs = torch.from_numpy(np.asarray(starts, dtype=np.int64)).to(dev)
    # a read's positions below `stop` are the windows that count
    stop = torch.where(rs[1:] - rs[:-1] >= k1 + 1, rs[1:] - k + 1, rs[:-1])
    status = np.empty(n_bases, dtype=np.int8)
    for lo, lo_w, size, n in _chunk_windows(
            packed_np, n_bases, w, chunk_bases):
        window = packed[lo_w:lo_w + size]
        if tflags is not None:
            f = _node_flags(table, tflags, _node_keys(
                kmerops.extract_all_kmers(window, k)[:n]))
            s = ((f >> 1) & 1) | ((f & 1) << 1)
        else:
            has_in, has_out = _neighbor_flags(window, table, k, k1)
            s = has_in[:n].to(torch.uint8) | (
                has_out[:n].to(torch.uint8) << 1)
        p = torch.arange(lo, lo + n, device=dev)
        rid = torch.searchsorted(rs, p, right=True) - 1
        s = torch.where(p < stop[rid], s, 3)
        status[lo:lo + n] = s.to(torch.int8).cpu().numpy()
    return status


def _candidate_reads(packed_np, rare_keys, k1, starts) -> np.ndarray:
    """Reads containing at least one NON-solid (k1)-window: a fully-
    solid read cannot host a mercy gap (the native canonical seed
    scan)."""
    cand = np.zeros(len(starts) - 1, dtype=bool)
    if len(rare_keys) == 0:
        return cand
    from ..native import SCAN_CANON, seed_scan

    _, rid, _, _, _ = seed_scan(packed_np, starts, k1, rare_keys,
                                SCAN_CANON)
    cand[rid] = True
    return cand


def find_mercy_edges(
    flat_codes,
    starts: np.ndarray,
    solid_keys: np.ndarray,
    k1: int,
    chunk_bases: int = 1 << 22,
    rare_keys: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """Return (M, W) canonical mercy (k1)-mers (deduplicated).

    flat_codes/starts: the read pool. solid_keys: sorted canonical
    solid (k1)-mers. k1 = edge length = megahit k + 1. rare_keys
    (optional): the counter's NON-solid distinct keys; when given, the
    node-flag scan runs only over candidate reads."""
    device = resolve_device(device)
    chunk_bases = max(1 << 16, (chunk_bases + 15) & ~15)
    log = get_logger()
    k = k1 - 1
    w = kmerops.words_per_kmer(k1)
    n_bases = int(starts[-1])
    if n_bases < k1 or len(solid_keys) == 0:
        return np.zeros((0, w), dtype=np.uint32)

    if k <= 31 and rare_keys is not None:
        return _mercy_candidate_reads_path(
            flat_codes, starts, solid_keys, rare_keys, k, k1,
            chunk_bases, device, log)
    table, tflags = _node_table(solid_keys, k1, device)
    with span("flag_scan"):
        packed_np, packed = _upload_pool(flat_codes, w, device)
        status = _dense_status(packed, packed_np, table, tflags, starts, k,
                               k1, chunk_bases)
        count("lookups", n_bases)
    return _emit_gap_edges(status, None, starts, packed, k1, w, log)


def _node_table(solid_keys: np.ndarray, k1: int, device):
    """The table the flag scan looks nodes up in, under the span
    node_table: at k <= 31 the prefix/suffix node sets with their flags,
    built and kept on `device` (`_node_sets`), else the solid set itself
    and no flags; either is searched on the device."""
    with span("node_table"):
        if k1 - 1 <= 31:
            return _node_sets(solid_keys, k1, device)
        return kmerops.to_torch(solid_keys, device), None


def _upload_pool(flat_codes, w: int, device):
    """The read pool's packed words, padded by w + 1 zero words, on the
    host and on `device`."""
    from .counter import as_pool

    pool = as_pool(flat_codes)
    packed_np = np.concatenate(
        [pool.window_padded(0, pool.n_words),
         np.zeros(w + 1, dtype=np.uint32)])
    return packed_np, kmerops.to_torch(packed_np, device)


def _mercy_candidate_reads_path(flat_codes, starts, solid_keys,
                                rare_keys, k, k1, chunk_bases, device, log
                                ) -> np.ndarray:
    """Node-flag scan restricted to candidate reads (identical output
    to the dense scan: non-candidate reads are provably gap-free)."""
    w = kmerops.words_per_kmer(k1)
    lengths = np.diff(starts)
    with span("candidates"):
        packed_np, packed = _upload_pool(flat_codes, w, device)
        cand = _candidate_reads(packed_np, rare_keys, k1, starts)
        cand &= lengths >= k1 + 1
        n_cand = int(cand.sum())
    if n_cand == 0:
        return np.zeros((0, w), dtype=np.uint32)
    log.debug("mercy: %d/%d candidate reads", n_cand, len(cand))
    table, tflags = _node_table(solid_keys, k1, device)
    with span("flag_scan"):
        rs = starts[:-1][cand]
        re_ = starts[1:][cand]
        seg = (re_ - rs).astype(np.int64)
        total = int(seg.sum())
        # ALL positions of every candidate read, ascending
        pos = np.repeat(rs, seg) + (
            np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(seg) - seg, seg))
        read_end = np.repeat(re_, seg)
        f = np.empty(total, dtype=np.uint8)
        for lo in range(0, total, chunk_bases):
            hi = min(total, lo + chunk_bases)
            keys_k = kmerops.extract_kmers(
                packed, torch.from_numpy(pos[lo:hi]).to(packed.device), k)
            f[lo:hi] = _node_flags(table, tflags,
                                   _node_keys(keys_k)).cpu().numpy()
        count("lookups", total)
        status = ((f >> 1) & 1) | ((f & 1) << 1)  # 1 in-only, 2 out-only
        status[pos + k > read_end] = 3
    return _emit_gap_edges(status, pos, starts, packed, k1, w, log)


def _emit_gap_edges(status, pos, starts, packed, k1, w, log
                    ) -> np.ndarray:
    """The mercy edges of the node statuses `status` (1 in-only, 2
    out-only, 3 stop) at positions `pos` (None: status[i] is position
    i): each gap runs from the latest in-only position before an
    out-only one, cancelled by any later stop (status 2 or 3)."""
    with span("emit"):
        lists = [np.flatnonzero(m) for m in
                 (status == 1, status == 2, status >= 2)]
        if pos is not None:
            lists = [pos[i] for i in lists]
        return _gap_edges(*lists, starts, packed, k1, w, log)


def _gap_edges(one_list, b_list, stop_list, starts, packed, k1, w, log
               ) -> np.ndarray:
    """Gap windows from (in-only, out-only, stop) position lists: the
    distinct canonical mercy edges."""
    none = np.zeros((0, w), dtype=np.uint32)
    if len(b_list) == 0 or len(one_list) == 0:
        return none
    ia = np.searchsorted(one_list, b_list)
    a_list = np.where(ia > 0, one_list[np.maximum(ia - 1, 0)], -1)
    is_ = np.searchsorted(stop_list, b_list)
    prev_stop_b = np.where(is_ > 0, stop_list[np.maximum(is_ - 1, 0)],
                           -1)
    live = (a_list >= 0) & (a_list > prev_stop_b) & (b_list > 0)
    a_list, b_list = a_list[live], b_list[live]
    if len(a_list) == 0:
        return none
    seg = (b_list - a_list).astype(np.int64)
    total = int(seg.sum())
    if total == 0:
        return none
    pos = np.repeat(a_list, seg) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(seg) - seg, seg))
    # a mercy window must itself be a full (k1)-window of its read
    rid = np.searchsorted(starts, pos, side="right") - 1
    pos = pos[pos + k1 <= starts[rid + 1]]
    n_mercy_windows = len(pos)
    if n_mercy_windows == 0:
        return none
    keys = kmerops.extract_kmers(
        packed, torch.from_numpy(pos).to(packed.device), k1)
    canon, _ = kmerops.canonical_kmers(keys, k1)
    mercy = np.unique(kmerops.to_numpy(canon), axis=0)
    log.info("mercy: %d gap windows -> %d distinct mercy edges",
             n_mercy_windows, len(mercy))
    return mercy
