"""Solid edge sets for mercy's node table, made with numpy and the
port's packing only (no JAX), so that the CPU parity test and the
card's test build the same tables.

Each case maps (k1, rng) to sorted distinct canonical (k1)-mers, (N, W)
uint32, as the count returns its solid keys. k1 = 32 is k = 31: the
node's 62 bits reach next to the sign bit of the u64 value."""

import numpy as np

from megahit_tpu_torch.core import kmerops, packing

K1S = (12, 22, 32)


def _solid(windows: list[np.ndarray], k1: int) -> np.ndarray:
    """Base arrays of length k1 -> the sorted distinct canonical keys."""
    w = kmerops.words_per_kmer(k1)
    if not windows:
        return np.zeros((0, w), dtype=np.uint32)
    keys = np.stack([packing.pack_codes(b) for b in windows])
    canon, _ = kmerops.canonical_kmers(keys, k1)
    return np.unique(canon, axis=0)


def random_set(k1, rng):
    """Unrelated random edges: nodes shared only by chance."""
    return _solid(list(rng.integers(0, 4, (3000, k1), dtype=np.uint8)), k1)


def palindromes(k1, rng):
    """Edges equal to their own reverse complement, with random edges
    around them: both strands give the same prefix and suffix."""
    halves = rng.integers(0, 4, (200, k1 // 2), dtype=np.uint8)
    pal = [np.concatenate([h, packing.revcomp_codes(h)]) for h in halves]
    return _solid(pal + list(rng.integers(0, 4, (200, k1), dtype=np.uint8)),
                  k1)


def shared_nodes(k1, rng):
    """Every window of a few random sequences: each inner node is the
    suffix of one edge and the prefix of the next (flag 3)."""
    seqs = [rng.integers(0, 4, 400, dtype=np.uint8) for _ in range(4)]
    return _solid([s[i:i + k1] for s in seqs
                   for i in range(len(s) - k1 + 1)], k1)


def single_key(k1, rng):
    return _solid([rng.integers(0, 4, k1, dtype=np.uint8)], k1)


def empty(k1, rng):
    return _solid([], k1)


CASES = {f.__name__: f for f in (random_set, palindromes, shared_nodes,
                                 single_key, empty)}
