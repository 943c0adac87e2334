"""Canonical k-mer counting.

Replaces the reference `count` subprogram (src/sorting/kmer_counter.cpp
with the CX1 engine): extract the canonical (k+1)-mer at every base
offset of the 2-bit pool, sort, and run-length count.

Three branches, as in megahit_tpu/graph/counter.py:

- CUDA, single shot (``_count_fused``): kernel 1
  (``kernels.canonical_all_kmers``), the validity mask realigned to the
  kernel's phase layout, ``torch.sort``, kernel 2
  (``kernels.count_sorted_runs``) and a cumsum/scatter compaction of the
  distinct rows into ``cap`` rows; only those cross to the host. When
  there are more than ``cap`` distinct keys it falls back to the chunked
  branch, as megahit_tpu does.
- chunked (``_count_chunked``): the pool in word-aligned chunks through
  kernel 1, compacted by validity, padded to a power of two with
  sentinel keys, sorted and counted with kernel 2, on either device.
- CPU, k1 <= 32 (``_count_host_u64``): keys as one u64 each, numpy sort
  and run-length diff.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import kernels, kmerops
from ..utils.device import resolve_device
from ..utils.log import get_logger

KMAX_MUL = 65535  # reference kBitsPerMul=16 (src/definitions.h)


def _pow2_pad(n: int, minimum: int = 16) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def window_valid_range(starts: np.ndarray, k: int, lo: int, hi: int
                       ) -> np.ndarray:
    """valid[p - lo] = the k-window at flat offset p lies inside one
    sequence, for positions [lo, hi) only - O(range).

    Invalid positions are exactly the per-read tails [end - k + 1, end)
    (whole read when shorter than k), which are disjoint ascending
    ranges. Precondition: hi <= starts[-1]."""
    assert hi <= int(starts[-1]), (hi, int(starts[-1]))
    n = hi - lo
    if n <= 0:
        return np.zeros(0, dtype=bool)
    out = np.ones(n, dtype=bool)
    j0 = max(int(np.searchsorted(starts, lo, side="right")) - 1, 0)
    j1 = int(np.searchsorted(starts, hi, side="left"))
    s = starts[j0:j1].astype(np.int64)
    e = starts[j0 + 1 : j1 + 1].astype(np.int64)
    inv_s = np.maximum(np.maximum(e - k + 1, s), lo)
    inv_e = np.minimum(e, hi)
    seg = np.maximum(inv_e - inv_s, 0)
    total = int(seg.sum())
    if total:
        idx = (np.repeat(inv_s - lo, seg)
               + np.arange(total, dtype=np.int64)
               - np.repeat(np.cumsum(seg) - seg, seg))
        out[idx] = False
    return out


def num_windows(starts: np.ndarray, k: int) -> int:
    """Total k-windows inside sequences."""
    return int(np.maximum(np.diff(starts) - k + 1, 0).sum())


def as_pool(pool_or_codes):
    """Accept either a PackedPool or raw u8 base codes."""
    from ..io.lib import PackedPool

    if isinstance(pool_or_codes, PackedPool):
        return pool_or_codes
    return PackedPool.from_codes(pool_or_codes)


def pack_flat(flat_codes: np.ndarray) -> np.ndarray:
    """u8 base codes -> packed u32 words (host numpy, bounded chunks)."""
    n = len(flat_codes)
    chunk = 1 << 27  # a multiple of 16
    out = np.empty((n + 15) // 16, np.uint32)
    for lo in range(0, n, chunk):
        part = flat_codes[lo:lo + chunk]
        pad = (-len(part)) % 16
        if pad:
            part = np.concatenate([part, np.zeros(pad, np.uint8)])
        out[lo // 16:lo // 16 + len(part) // 16] = \
            kmerops.pack_flat_codes(part)
    return out


def _device_words(words: np.ndarray, device) -> torch.Tensor:
    """u32 numpy words -> int32 (same bits) tensor on `device`."""
    a = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def _sorted_words(words: list[torch.Tensor]) -> list[torch.Tensor]:
    """Lexicographic sort of key columns (int64 u32 words)."""
    packed = kmerops.pack_sort_keys(words)
    if len(packed) == 1:
        packed = [torch.sort(packed[0]).values]
    else:
        perm = kmerops.argsort_packed(packed)
        packed = [c[perm] for c in packed]
    return kmerops.unpack_sort_keys(packed, len(words))


def _count_device_fused(packed: torch.Tensor, pm: torch.Tensor, k1: int,
                        cap: int):
    """Single-shot count with on-device compaction.

    packed: (P,) int32 pool words; pm: phase-grouped window validity
    over canonical_all_kmers' columns. Returns (keys (cap, W) int64
    words, sentinel-padded; counts (cap,) int32; n_distinct); the
    caller falls back when n_distinct > cap."""
    cols = kernels.canonical_all_kmers(packed, k1)
    w = cols.shape[0]
    n_inv = int((~pm).sum())
    words = [torch.where(pm, kmerops.u32_value(cols[i]), kmerops.M32)
             for i in range(w)]
    del cols
    words = _sorted_words(words)
    head, counts = kernels.count_sorted_runs(
        [kmerops.i32_bits(c) for c in words], n_inv)
    pos = torch.cumsum(head, dim=0, dtype=torch.int64) - 1
    tgt = torch.where(head & (pos < cap), pos, cap)
    out_keys = torch.full((cap + 1, w), kmerops.M32, dtype=torch.int64,
                          device=packed.device)
    for i in range(w):
        out_keys[:, i].index_put_((tgt,), words[i])
    out_counts = torch.zeros(cap + 1, dtype=torch.int32,
                             device=packed.device)
    out_counts.index_put_((tgt,), counts)
    return out_keys[:cap], out_counts[:cap], int(head.sum())


def _count_fused(pool, starts, k1, min_count, device, cap=None):
    """The single-shot branch over the whole pool on `device`. Returns
    numpy (keys, counts, rare), or None when the pool has more than
    `cap` distinct keys (the caller then counts in chunks)."""
    w = kmerops.words_per_kmer(k1)
    n_bases = int(starts[-1])
    n = num_windows(starts, k1)
    total_words = pool.n_words + w + 1
    q = total_words - w
    vm = np.zeros(q * 16, dtype=bool)
    span = min(q * 16, n_bases)
    vm[:span] = window_valid_range(starts, k1, 0, span)
    pm = torch.from_numpy(kernels.phase_grouped_mask(vm)).to(device)
    if cap is None:
        cap = _pow2_pad(max(n // 4, 1 << 16))
    keys_c, counts_c, nd = _count_device_fused(
        _device_words(pool.window_padded(0, total_words), device),
        pm, k1, cap)
    if nd > cap:
        get_logger().debug(
            "fused count capacity %d < distinct %d; falling back", cap, nd)
        return None
    out_keys = kmerops.to_numpy(keys_c[:nd])
    out_counts = counts_c[:nd].cpu().numpy()
    keep = out_counts >= min_count
    get_logger().debug("count (fused): %d windows -> %d distinct, %d solid",
                       n, nd, int(keep.sum()))
    return (out_keys[keep],
            np.minimum(out_counts[keep], KMAX_MUL).astype(np.int32),
            out_keys[~keep])


def _chunks(pool, starts, k1, chunk):
    """(lo, sub words (u32 numpy), window validity) per word-aligned
    chunk of the pool; validity covers (len(sub) - W) * 16 offsets."""
    w = kmerops.words_per_kmer(k1)
    n_bases = int(starts[-1])
    total_words = pool.n_words + w + 1
    n_dense = (total_words - w) * 16
    for lo in range(0, n_bases, chunk):
        hi = min(n_dense, lo + chunk)
        lo_w, hi_w = lo // 16, (hi + 15) // 16
        size = min(hi_w + w + 1, total_words) - lo_w
        span = min(min(hi, n_bases) - lo, (size - w) * 16)
        vm = np.zeros((size - w) * 16, dtype=bool)
        vm[:span] = window_valid_range(starts, k1, lo, lo + span)
        yield lo, pool.window_padded(lo_w, size), vm
        if hi >= n_dense:
            break


def _chunked_sorted_words(pool, starts, k1, chunk, device):
    """The chunked branch up to kernel 2: kernel 1 per chunk, compaction
    by validity, sentinel padding to a power of two, sort. Returns
    (sorted int64 u32 word columns, sentinel rows, chunks)."""
    w = kmerops.words_per_kmer(k1)
    n = num_windows(starts, k1)
    parts = []
    for _, sub, vm in _chunks(pool, starts, k1, chunk):
        cols = kernels.canonical_all_kmers(_device_words(sub, device), k1)
        pm = torch.from_numpy(kernels.phase_grouped_mask(vm)).to(device)
        parts.append(cols[:, pm])
    n_chunks = len(parts)
    keys = torch.cat(parts, dim=1)
    del parts
    assert keys.shape[1] == n, (keys.shape[1], n)
    pad_rows = _pow2_pad(n) - n
    words = [torch.cat([kmerops.u32_value(keys[i]),
                        keys.new_full((pad_rows,), kmerops.M32,
                                      dtype=torch.int64)])
             for i in range(w)]
    del keys
    return _sorted_words(words), pad_rows, n_chunks


def _count_chunked(pool, starts, k1, min_count, chunk, device):
    """Chunked count on `device`: kernel 1 per chunk, compaction by
    validity, sentinel padding to a power of two, sort, kernel 2.
    Returns numpy (keys, counts, rare)."""
    n = num_windows(starts, k1)
    words, pad_rows, n_chunks = _chunked_sorted_words(
        pool, starts, k1, chunk, device)
    head, counts = kernels.count_sorted_runs(
        [kmerops.i32_bits(c) for c in words], pad_rows)
    keep = head & (counts >= min_count)
    if pad_rows:
        # the sentinel group is dropped when only padding fills it
        # (an all-T key equals the sentinel only when k1 % 16 == 0)
        is_sentinel = torch.ones_like(head)
        for c in words:
            is_sentinel &= c == kmerops.M32
        keep &= ~(is_sentinel & (counts == 0))
    keep &= counts > 0
    rare = head & (counts > 0) & (counts < min_count)
    skeys = torch.stack(words, dim=1)
    out_keys = kmerops.to_numpy(skeys[keep])
    out_counts = np.minimum(counts[keep].cpu().numpy(),
                            KMAX_MUL).astype(np.int32)
    get_logger().info(
        "count (chunked): %d chunks of %d bases, %d windows padded to %d "
        "rows -> %d distinct canonical %d-mers, %d solid (>=%d)",
        n_chunks, chunk, n, n + pad_rows, int(head.sum()), k1,
        len(out_keys), min_count)
    return out_keys, out_counts, kmerops.to_numpy(skeys[rare])


def _count_host_u64(pool, starts, k1, min_count, chunk):
    """CPU branch for k1 <= 32: canonical keys as one u64 each (invalid
    windows masked to the u64 maximum), numpy sort, run-length diff."""
    w = kmerops.words_per_kmer(k1)
    n = num_windows(starts, k1)
    u_chunks = []
    n_inv = 0
    for _, sub, vm in _chunks(pool, starts, k1, chunk):
        cols = kernels.canonical_all_kmers(_device_words(sub, "cpu"), k1)
        pm = kernels.phase_grouped_mask(vm)
        c = cols.numpy().view(np.uint32)
        u = c[0].astype(np.uint64) << np.uint64(32)
        if w == 2:
            u |= c[1].astype(np.uint64)
        u[~pm] = np.uint64(0xFFFFFFFFFFFFFFFF)
        n_inv += int(len(pm) - pm.sum())
        u_chunks.append(u)
    u = np.concatenate(u_chunks)
    del u_chunks
    u.sort()
    u = u[: len(u) - n_inv]  # sentinels sort to the tail
    assert len(u) == n, (len(u), n)
    head = np.empty(len(u), dtype=bool)
    head[0] = True
    np.not_equal(u[1:], u[:-1], out=head[1:])
    idx = np.flatnonzero(head)
    counts = np.diff(np.append(idx, len(u))).astype(np.int32)
    distinct = u[idx]
    keep = counts >= min_count

    def u64_to_keys(d):
        ks = np.empty((len(d), w), np.uint32)
        ks[:, 0] = (d >> np.uint64(32)).astype(np.uint32)
        if w == 2:
            ks[:, 1] = (d & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return ks

    out_keys = u64_to_keys(distinct[keep])
    out_counts = np.minimum(counts[keep], KMAX_MUL).astype(np.int32)
    get_logger().debug(
        "count (host u64): %d windows -> %d distinct, %d solid",
        n, len(idx), len(out_keys))
    return out_keys, out_counts, u64_to_keys(distinct[~keep])


def count_canonical_kmers(
    flat_codes,
    starts: np.ndarray,
    k1: int,
    min_count: int,
    batch_windows: int = 1 << 22,
    return_rare: bool = False,
    device="cuda",
) -> tuple[np.ndarray, ...]:
    """Count all canonical k1-mers of the sequence pool on `device`.

    Returns (keys (E, W) uint32 sorted, counts (E,) int32) with counts
    >= min_count, clipped to KMAX_MUL. With return_rare=True, also the
    (R, W) NON-solid distinct keys (count < min_count), the basis of
    mercy's candidate-read filter."""
    device = resolve_device(device)
    pool = as_pool(flat_codes)
    w = kmerops.words_per_kmer(k1)
    n_bases = int(starts[-1])

    def ret(keys, counts, rare):
        return (keys, counts, rare) if return_rare else (keys, counts)

    empty = (np.zeros((0, w), dtype=np.uint32),
             np.zeros(0, dtype=np.int32),
             np.zeros((0, w), dtype=np.uint32))
    if n_bases - k1 + 1 <= 0:
        return ret(*empty)
    n = num_windows(starts, k1)
    if n == 0:
        return ret(*empty)
    chunk = max(1 << 16, (batch_windows + 15) & ~15)

    if device.type == "cuda" and n_bases <= chunk:
        out = _count_fused(pool, starts, k1, min_count, device)
        if out is not None:
            return ret(*out)
    if device.type == "cpu" and k1 <= 32:
        return ret(*_count_host_u64(pool, starts, k1, min_count, chunk))
    return ret(*_count_chunked(pool, starts, k1, min_count, chunk, device))
