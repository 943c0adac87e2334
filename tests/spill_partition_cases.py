"""Inputs and the host oracle shared by tests/test_torch_spill_partition.py
(CPU) and tests/test_torch_spill_partition_gpu.py (the card), which
hold the spill's device partition (`bucketed._spill_pool`,
`bucketed._spill_edges`) to the host route it replaced. Imports neither
JAX nor megahit_tpu.

The oracle makes each chunk's rows on the host (a pool's keys extracted,
downloaded and masked there, or a chunk of an EdgeSource's keys;
`np_revcomp`; the multiplicity word from `np.searchsorted` or the edge's
count) and appends each bucket's rows, picked by a boolean mask in their
chunk order, to that bucket's bytes."""

import os

import numpy as np

from megahit_tpu_torch.core import kmerops
from megahit_tpu_torch.core.packing import pack_many
from megahit_tpu_torch.graph import bucketed
from megahit_tpu_torch.graph.counter import _chunks, as_pool

K1S = (22, 32, 48)
LAYOUTS = ("unit", "counted")
# the sources of a spill: a pool in either layout, or edges
SOURCES = LAYOUTS + ("edges",)
# the spill's smallest chunk (bucketed._chunk_rows: 2^16 windows or
# edges)
CHUNK = 1 << 16


def pool_source(layout: str, n_seqs: int, rng,
                read_len: int | None = None) -> bucketed.PoolSource:
    """Reads of `read_len` bases, or of 10 to 199 (some shorter than
    every k1 here); in the counted layout each read's multiplicity
    differs from its neighbours', up to 2^31 - 1."""
    lengths = (np.full(n_seqs, read_len) if read_len
               else rng.integers(10, 200, size=n_seqs))
    flat, starts = pack_many(
        [rng.integers(0, 4, size=int(n)).astype(np.uint8)
         for n in lengths])
    if layout == "unit":
        mults = np.ones(n_seqs, np.int32)
    else:
        mults = rng.integers(1, 2**31 - 1, size=n_seqs).astype(np.int32)
    return bucketed.PoolSource(flat, starts, mults)


def edge_source(k: int, n: int, rng) -> bucketed.EdgeSource:
    """n random keys of length k with counts up to 2^32 - 1."""
    w = kmerops.words_per_kmer(k)
    keys = kmerops.mask_tail(
        rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
        k)
    counts = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return bucketed.EdgeSource(keys, counts)


def _rows(fwd: np.ndarray, mult: np.ndarray | None, k: int) -> np.ndarray:
    """A chunk's host rows: the keys, then their reverse complements,
    each with its multiplicity word where `mult` is given."""
    n, w = fwd.shape
    rows = np.empty((2 * n, w + (mult is not None)), np.uint32)
    rows[:n, :w] = fwd
    rows[n:, :w] = bucketed.np_revcomp(fwd, k)
    if mult is not None:
        rows[:n, w] = mult
        rows[n:, w] = mult
    return rows


def _append(files: dict[int, bytes], counts: np.ndarray,
            rows: np.ndarray) -> None:
    b8 = rows[:, 0] >> np.uint32(24)
    for b in range(bucketed.N_BUCKETS):
        part = rows[b8 == b]
        if len(part):
            files[b] = files.get(b, b"") + part.tobytes()
            counts[b] += len(part)


def host_spill(src, k: int, chunk: int, unit: bool = False
               ) -> tuple[dict[int, bytes], np.ndarray]:
    """The host route's spill files (bucket -> bytes) and counts, of a
    PoolSource (in the unit layout or not) or of an EdgeSource."""
    files: dict[int, bytes] = {}
    counts = np.zeros(bucketed.N_BUCKETS, np.int64)
    if isinstance(src, bucketed.EdgeSource):
        for s in range(0, len(src.keys), chunk):
            _append(files, counts, _rows(src.keys[s:s + chunk],
                                         src.counts[s:s + chunk], k))
        return files, counts
    mults = np.asarray(src.mults, dtype=np.int32)
    for lo, words, vm in _chunks(as_pool(src.flat_codes), src.starts, k,
                                 chunk):
        fwd = kmerops.to_numpy(kmerops.extract_all_kmers(
            kmerops.to_torch(words, "cpu"), k))[vm]
        mm = None
        if not unit:
            posv = np.flatnonzero(vm) + lo
            mm = mults[np.searchsorted(src.starts, posv, side="right") - 1]
        _append(files, counts, _rows(fwd, mm, k))
    return files, counts


def spill_files(spill: bucketed.SpillSet) -> dict[int, bytes]:
    """A spill set's non-empty files, bucket -> bytes."""
    spill._close_fhs()
    out = {}
    for b, path in enumerate(spill.paths):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as fh:
                out[b] = fh.read()
    return out
