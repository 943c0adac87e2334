"""Solid edge sets for mercy's node table, made with numpy and the
port's packing only (no JAX), so that the CPU parity test and the
card's test build the same tables.

Each case maps (k1, rng) to sorted distinct canonical (k1)-mers, (N, W)
uint32, as the count returns its solid keys. k1 = 32 is k = 31: the
node's 62 bits reach next to the sign bit of the u64 value.

`host_u64` turns the port's device table into megahit_tpu's host form;
`mercy_reads` and `read_end_reads` are read pools for whole scans."""

import numpy as np
import torch

from megahit_tpu_torch.core import kmerops, packing

K1S = (12, 22, 32)


def host_u64(table: torch.Tensor, flags: torch.Tensor):
    """The node table `_node_sets` keeps on its device (int64 keys in
    pack_sort_keys form, uint8 flags) as host u64 values ((word0 << 32)
    | word1, ascending) and uint8 flags: flip the top bit back."""
    assert table.dtype == torch.int64 and flags.dtype == torch.uint8
    u64 = (table ^ -(1 << 63)).cpu().numpy().view(np.uint64)
    return u64, flags.cpu().numpy()


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


def mercy_reads(rng, genome_len: int = 12000, n_reads: int = 900):
    """(flat codes, starts) of reads of 20 to 150 bases drawn from one
    random genome at about 6x, with 1% substitutions: solid runs break
    at rare windows (mercy gaps), some reads are shorter than k1 + 1,
    and the pool (about 77 kbp) spans two chunks of 2^16 bases."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    reads = []
    for _ in range(n_reads):
        n = int(rng.integers(20, 151))
        s = int(rng.integers(0, genome_len - n))
        r = genome[s:s + n].copy()
        err = rng.random(n) < 0.01
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
        reads.append(r.astype(np.uint8))
    return packing.pack_many(reads)


def read_end_reads(k1: int):
    """Two gaps that only the read-end rules decide. A: a read runs from
    a solid region into the first node of another, so its gap ends at
    its last node (the last full k-window, whose edge window ends at the
    read's end). B: a read of exactly k1 bases bridges two solid regions
    (in-only node, then out-only node) and, shorter than k1 + 1, donates
    nothing."""
    k = k1 - 1
    rng = np.random.default_rng(k1 + 7)
    a = rng.integers(0, 4, 400, dtype=np.uint8)
    b = rng.integers(0, 4, 300, dtype=np.uint8)
    reads = [a[0:150], a[0:150], a[250:400], a[250:400], a[100:250 + k],
             b[0:150], b[0:150], b[151 - k:300], b[151 - k:300],
             b[150 - k:151]]
    return packing.pack_many(reads)
