"""Bytes the count's two kernels must move, from their shapes (each
input read once, each output written once), and the card's peak rate
(copied from chip_smoke.py's byte bounds).

Kernel 1 (canonical_all_kmers) reads a pool of p 4-byte words and
writes W words for each of q_padded * 16 base offsets, where W =
ceil(k / 16) and q_padded is the p - W window starts rounded up to a
block of 2048. Kernel 2 (count_sorted_runs) reads n rows of key columns
and writes a 1-byte head flag and a 4-byte count a row.
"""

from __future__ import annotations

# NVIDIA H100 SXM, HBM3 (data sheet), bytes a second
HBM_BYTES_PER_S = 3.35e12
BLOCK_Q = 2048


def words_per_kmer(k: int) -> int:
    return (k + 15) // 16


def k1_bytes(p: int, k: int) -> int:
    w = words_per_kmer(k)
    q_pad = -(-(p - w) // BLOCK_Q) * BLOCK_Q
    return p * 4 + w * 4 * q_pad * 16


def k2_bytes(n: int, row_key_bytes: int) -> int:
    return n * row_key_bytes + 5 * n


def roofline_pct(run, wrapper: str, kernel: str, bytes_of) -> float | None:
    """Percent of the byte bound that the window's launches of one
    kernel reach: the bytes of every call over the peak rate, divided
    by the kernel's device time. None where the window launched it not
    at all. Raises where the profiler's launches, the calls recorded
    and the program's launch counter disagree."""
    t = run.trace
    if not t or "kernels" not in t:
        return None
    calls = t["calls"][wrapper]
    times = [d for name, ds in t["kernels"].items() if kernel in name
             for d in ds]
    launches = t["launches"][wrapper]
    if not (len(times) == len(calls) == launches):
        raise RuntimeError(
            f"{wrapper}: {len(times)} device events, {len(calls)} calls, "
            f"launch counter {launches}")
    if not calls:
        return None
    need = sum(bytes_of(*c) for c in calls)
    return 100.0 * need / HBM_BYTES_PER_S / sum(times)
