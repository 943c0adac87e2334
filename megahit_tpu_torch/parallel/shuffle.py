"""Mesh-sharded k-mer counting and sample sort: the scale-out path.

The reference partitions (k+1)-mers into 65,536 prefix buckets and
schedules bucket ranges under a memory budget on one node
(src/sorting/base_engine.cpp:176-281). Here the work shards over a
``Mesh`` (parallel/multihost.py): every shard extracts canonical k-mers
from its share of the read windows, routes each to an owner shard by a
hash of its key (uniform, unlike prefix buckets), exchanges them with
one ``all_to_all``, then counts locally with a sort and a run-length
count. Each distinct k-mer is counted on exactly one shard, so the union
of the shards' results is the global answer.

The exchange has a fixed capacity per (source, destination) pair; the
overflow is summed over every shard before any shard decides to retry
at the capacity that cannot overflow (a whole source shard per
destination), so every process calls the same collectives.

The local steps are torch ops of core/kmerops.py, as megahit_tpu's are
XLA ops: no hand kernel is reached here (in particular not kernels 1
and 2 of graph/counter.py).

Key words are int64 tensors holding u32 values (core/kmerops.py):
gloo has no uint32, and every product and shift of the hash is masked
back to 32 bits so that owners equal megahit_tpu's, shard for shard.

Counterpart of megahit_tpu/parallel/shuffle.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import kmerops
from ..core.kmerops import M32
from ..utils.log import get_logger
from .multihost import Mesh, fetch_global, put_global


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in int64 without overflow:
    the constant in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def kmer_hash(keys: torch.Tensor) -> torch.Tensor:
    """Mix the words of each (N, W) key into one u32 hash (int64).

    Murmur3-style finalizer per word, combined with rotation - plays the
    role of the reference's XXH3 KmerHash (src/sequence/kmer_plus.h:31).
    Bit for bit megahit_tpu's uint32 arithmetic."""
    h = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
    for i in range(keys.shape[-1]):
        x = _mul32(keys[..., i] & M32, 0xCC9E2D51)
        x = _mul32(_rotl32(x, 15), 0x1B873593)
        h = _rotl32(h ^ x, 13)
        h = (h * 5 + 0xE6546B64) & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _group_rank(dst: torch.Tensor) -> torch.Tensor:
    """Rank of each row within its run of equal consecutive dst."""
    b = dst.shape[0]
    idx = torch.arange(b, device=dst.device)
    head = torch.ones(b, dtype=torch.bool, device=dst.device)
    head[1:] = dst[1:] != dst[:-1]
    return idx - torch.cummax(torch.where(head, idx, 0), 0).values


def _scatter_to_buffer(keys, dst, rank, n_dev: int, capacity: int):
    """(n_dev, capacity, W) sentinel-filled send buffer holding row r at
    [dst[r], rank[r]] where dst < n_dev and rank < capacity; returns it
    and the number of real rows that did not fit."""
    w = keys.shape[1]
    real = dst < n_dev
    ok = real & (rank < capacity)
    n_over = (real & ~ok).sum()
    flat = torch.where(ok, dst * capacity + rank, n_dev * capacity)
    buf = torch.full((n_dev * capacity + 1, w), M32, dtype=torch.int64,
                     device=keys.device)
    # every dropped row writes into the one extra row, several of them
    # different keys (which one lands is unspecified); harmless only
    # because that row is sliced off here
    buf[flat] = keys
    return buf[:-1].reshape(n_dev, capacity, w), n_over


def _route_to_buffer(keys: torch.Tensor, valid: torch.Tensor, n_dev: int,
                     capacity: int):
    """Scatter (B, W) keys into an (n_dev, capacity, W) send buffer by
    hash owner, sentinel-filled, each destination's rows in input order.
    Returns (buffer, n_overflowed)."""
    dst = torch.where(valid, kmer_hash(keys) % n_dev, n_dev)
    order = torch.argsort(dst, stable=True)
    rank = torch.empty_like(dst)
    rank[order] = _group_rank(dst[order])
    return _scatter_to_buffer(keys, dst, rank, n_dev, capacity)


def _count_local(keys: torch.Tensor, valid: torch.Tensor):
    """Sort local keys and run-length count. Returns (sorted keys,
    counts on head rows, head mask)."""
    keys = torch.where(valid[:, None], keys, M32)
    skeys, svalid = kmerops.sort_keys_with_payload(keys, valid)
    head, counts = kmerops.count_sorted_runs(skeys, svalid)
    return skeys, counts, head


def _capacity(rows: int, capacity_factor: float, n_dev: int) -> int:
    return max(16, int(np.ceil(rows * capacity_factor / n_dev)))


def make_sharded_counter(mesh: Mesh, k1: int, capacity_factor: float = 2.0):
    """The sharded count step over `mesh`.

    Returns fn(packed, positions, valid) over per-local-shard lists:
    the replicated (P,) pool words, the shard's (B,) window positions and
    their validity -> (sorted keys, counts, head) per local shard over
    its n * C received rows, the valid rows each received, and the
    overflow summed over the mesh."""
    n_dev = mesh.size

    def step(packed, positions, valid):
        # capacity is per (source, destination): sized from the rows of
        # one shard, so buffers shrink as shards are added
        capacity = _capacity(positions[0].shape[0], capacity_factor, n_dev)
        sends, over = [], []
        for pk, pos, val in zip(packed, positions, valid):
            keys = kmerops.extract_kmers(pk, pos, k1)
            canon, _ = kmerops.canonical_kmers(keys, k1)
            # explicit validity column: an all-ones key is a legal
            # canonical k-mer when 16 | k1, so padding can't be
            # recognized by key pattern alone
            aug = torch.cat([canon, val.to(torch.int64)[:, None]], dim=1)
            buf, n_over = _route_to_buffer(aug, val, n_dev, capacity)
            sends.append(buf)
            over.append(n_over)
        recvs = mesh.all_to_all(sends)
        del sends
        skeys, counts, head, received = [], [], [], []
        for recv in recvs:
            ra = recv.reshape(n_dev * capacity, -1)
            rvalid = ra[:, -1] == 1
            sk, c, h = _count_local(ra[:, :-1], rvalid)
            skeys.append(sk)
            counts.append(c)
            head.append(h)
            received.append(int(rvalid.sum()))
        return skeys, counts, head, received, mesh.psum(over)

    return step


def make_sharded_sorter(mesh: Mesh, w: int, capacity_factor: float = 2.5):
    """Distributed sample sort of (N, W) multi-word keys over `mesh`.

    The scale-out replacement for the graph-build sort (reference: the
    bucket-sharded CX1 output files merged by bucket metadata,
    edge_io_meta.h): each shard sorts its rows, samples splitters, all
    shards' samples are gathered, rows go to owner shards by splitter
    bin with one capacity-bounded all_to_all, and each shard sorts
    again - the concatenation of the shards' results is globally
    sorted.

    Ties are broken by an appended (shard, rank) word before splitting
    so runs of equal keys spread evenly across bins instead of
    overflowing one shard; the word refines key order, so global
    sortedness is preserved.

    Returns fn(keys, valid) over per-local-shard (B, W) int64 words and
    (B,) validity -> (sorted keys per local shard, valid mask per local
    shard, overflow summed over the mesh)."""
    n_dev = mesh.size

    def step(keys, valid):
        b = keys[0].shape[0]  # rows a shard
        capacity = _capacity(b, capacity_factor, n_dev)
        n_samples = 32 * n_dev
        # evenly spaced samples spanning the whole shard, in int64
        # (megahit_tpu's int32 product wraps past 2^31 / n_samples rows)
        sample_idx = torch.arange(n_samples, dtype=torch.int64) * b \
            // n_samples
        local, samples = [], []
        for i, k, v in zip(mesh.local, keys, valid):
            k = torch.where(v[:, None], k, M32)
            sk, sv = kmerops.sort_keys_with_payload(k, v)
            # tie-break word: globally unique, rank-major so equal keys
            # interleave across shards
            tie = torch.arange(b, dtype=torch.int64, device=k.device) \
                * n_dev + i
            ska = torch.cat([sk, tie[:, None]], dim=1)
            samples.append(ska[sample_idx.to(k.device)])
            local.append((sk, sv, ska))
        all_samples = mesh.all_gather(samples)
        ssamp = kmerops.sort_keys_with_payload(all_samples)[0]
        step_q = ssamp.shape[0] // n_dev
        splitters = ssamp[step_q::step_q][: n_dev - 1]
        sends, over = [], []
        for sk, sv, ska in local:
            spl = splitters.to(ska.device)
            # destination = number of splitters <= row
            dst = torch.zeros(b, dtype=torch.int64, device=ska.device)
            for j in range(n_dev - 1):
                dst += ~kmerops.lex_less(ska, spl[j].expand_as(ska))
            dst = torch.where(sv, dst, n_dev)
            # the rows are sorted, so each destination's rows are one run
            buf, n_over = _scatter_to_buffer(sk, dst, _group_rank(dst),
                                             n_dev, capacity)
            sends.append(buf)
            over.append(n_over)
        del local
        recvs = mesh.all_to_all(sends)
        del sends
        out_k, out_v = [], []
        for recv in recvs:
            r = recv.reshape(n_dev * capacity, w)
            rvalid = (r != M32).any(dim=-1)
            sk, sv = kmerops.sort_keys_with_payload(r, rvalid)
            out_k.append(sk)
            out_v.append(sv)
        return out_k, out_v, mesh.psum(over)

    return step


def sharded_sort_kmers(keys: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Globally sort (N, W) u32 keys across the mesh; host wrapper.

    Sentinel (all-ones) rows are treated as padding and dropped."""
    n_dev = mesh.size
    n, w = keys.shape
    npad = -(-n // n_dev) * n_dev
    kp = np.full((npad, w), M32, np.uint32)
    kp[:n] = keys
    vp = np.zeros(npad, dtype=bool)
    vp[:n] = ~np.all(keys == M32, axis=1)
    kd = put_global(kp, mesh)
    vd = put_global(vp, mesh)
    out_k, out_v, n_over = make_sharded_sorter(mesh, w)(kd, vd)
    if n_over:
        # a source shard concentrated one splitter bin (e.g. the input
        # was already key-clustered across shards); retry with the
        # guaranteed capacity = full shard per destination
        get_logger().info(
            "sharded sort: %d rows overflowed; retrying at capacity "
            "factor %d", n_over, n_dev)
        out_k, out_v, n_over = make_sharded_sorter(
            mesh, w, capacity_factor=float(n_dev))(kd, vd)
    assert n_over == 0, "sample-sort overflow at guaranteed capacity (bug)"
    return fetch_global([k[v] for k, v in zip(out_k, out_v)],
                        mesh).astype(np.uint32)


def window_positions(starts: np.ndarray, k: int) -> np.ndarray:
    """Flat base offsets (int64) of every length-k window fully inside
    one sequence, in order."""
    starts = np.asarray(starts, dtype=np.int64)
    n_win = np.maximum(np.diff(starts) - k + 1, 0)
    total = int(n_win.sum())
    seg_start = np.repeat(starts[:-1], n_win)
    first = np.repeat(np.cumsum(n_win) - n_win, n_win)
    return seg_start + np.arange(total, dtype=np.int64) - first


def sharded_count_kmers(
    flat_codes,
    starts: np.ndarray,
    k1: int,
    min_count: int,
    mesh: Mesh,
    return_rare: bool = False,
) -> tuple[np.ndarray, ...]:
    """Sharded canonical k-mer count; host-side wrapper.

    Same contract as graph.counter.count_canonical_kmers, over `mesh`.
    Result keys are globally deduplicated (hash ownership) and sorted on
    the host after the gather. With return_rare=True, also the sorted
    NON-solid distinct keys (count < min_count), the mercy
    candidate-read filter basis."""
    from ..graph.counter import KMAX_MUL, as_pool

    n_dev = mesh.size
    log = get_logger()
    positions = window_positions(starts, k1)
    n = len(positions)
    w = kmerops.words_per_kmer(k1)
    if n == 0:
        empty = (np.zeros((0, w), np.uint32), np.zeros(0, np.int32))
        return empty + (np.zeros((0, w), np.uint32),) if return_rare \
            else empty

    # pad the window count to a multiple of the mesh size
    npad = -(-n // n_dev) * n_dev
    pos = np.zeros(npad, dtype=np.int64)
    pos[:n] = positions
    val = np.zeros(npad, dtype=bool)
    val[:n] = True

    pool = as_pool(flat_codes)
    packed = put_global(pool.window_padded(0, pool.n_words), mesh,
                        replicate=True)
    posd = put_global(pos, mesh)
    vald = put_global(val, mesh)

    factor = 2.0
    skeys, counts, head, received, n_over = \
        make_sharded_counter(mesh, k1, factor)(packed, posd, vald)
    if n_over:
        # hash-skewed input overflowed the 2x capacity; retry at the
        # guaranteed capacity (a whole source shard per destination)
        log.info("sharded count: %d rows overflowed at capacity factor "
                 "%.1f; retrying at capacity factor %d", n_over, factor,
                 n_dev)
        factor = float(n_dev)
        skeys, counts, head, received, n_over = make_sharded_counter(
            mesh, k1, factor)(packed, posd, vald)
    assert n_over == 0, "all_to_all overflow at guaranteed capacity (bug)"
    log.info("sharded count: %d shards (%d here), capacity %d a pair, "
             "received rows max %d mean %.1f", n_dev, len(received),
             _capacity(npad // n_dev, factor, n_dev), max(received),
             sum(received) / len(received))
    # only the distinct keys (head rows) cross to the host
    keys = fetch_global([k[h] for k, h in zip(skeys, head)], mesh)
    counts = fetch_global([c[h] for c, h in zip(counts, head)], mesh)
    keys = keys.astype(np.uint32)
    solid = counts >= min_count
    out_keys = keys[solid]
    # clamp to the reference's kMaxMul, as the single-device counter does
    out_counts = np.minimum(counts[solid], KMAX_MUL).astype(np.int32)
    # keys are distinct, so an unstable row sort orders them uniquely
    order = kmerops.argsort_rows_np(out_keys)
    if not return_rare:
        return out_keys[order], out_counts[order]
    rare = np.ascontiguousarray(keys[~solid])
    return (out_keys[order], out_counts[order],
            rare[kmerops.argsort_rows_np(rare)])
