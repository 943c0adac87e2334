"""megahit_tpu_torch.graph.counter against megahit_tpu.graph.counter.

The same seeded read pools go through megahit_tpu's count (JAX on the
CPU backend) and through each branch of the port's count on the CPU:
the single-shot branch (the one CUDA takes for a pool that fits one
batch), the chunked branch (several chunks) and the host u64 branch.
(keys, counts, rare) must be exactly equal."""

import numpy as np
import pytest

from megahit_tpu.graph import counter as jc
from megahit_tpu.io import lib as jlib
from megahit_tpu_torch import convert
from megahit_tpu_torch.core import packing
from megahit_tpu_torch.graph import counter as tc

import torch_test_env  # noqa: F401


def _pool(seed, n_reads, genome_len=3000, err=0.01):
    """Reads of 30-140 bp from both strands of a random genome, with
    substitution errors, a few reads shorter than k and one all-T read
    (its canonical form is all-A)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    reads = []
    for _ in range(n_reads):
        ln = int(rng.integers(30, 141))
        s = int(rng.integers(0, genome_len - ln))
        r = genome[s:s + ln].copy()
        flip = rng.random(ln) < err
        r[flip] = (r[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        if rng.random() < 0.5:
            r = packing.revcomp_codes(r)
        reads.append(r.astype(np.uint8))
    reads += [np.zeros(7, np.uint8), np.full(60, 3, np.uint8)]
    return packing.pack_many(reads)


def _assert_same(got, want):
    assert len(got) == len(want) == 3
    for g, w_, name in zip(got, want, ("keys", "counts", "rare")):
        assert g.dtype == w_.dtype, name
        np.testing.assert_array_equal(g, w_, name)


@pytest.fixture(scope="module")
def pools():
    return {"small": _pool(1, 400), "chunked": _pool(2, 2000)}


@pytest.mark.parametrize("k1", [22, 32, 42])
@pytest.mark.parametrize("min_count", [1, 2])
def test_count_branches_match_jax(pools, k1, min_count):
    flat, starts = pools["small"]
    want = jc.count_canonical_kmers(flat, starts, k1, min_count,
                                    return_rare=True)
    assert len(want[0]) > 0
    pool = tc.as_pool(flat)
    # the branch CUDA takes for a single batch, here on CPU tensors
    _assert_same(tc._count_fused(pool, starts, k1, min_count, "cpu"), want)
    # the public entry on the CPU: host u64 for k1 <= 32, else chunked
    _assert_same(tc.count_canonical_kmers(
        flat, starts, k1, min_count, return_rare=True, device="cpu"), want)
    # the chunked branch (one chunk here)
    _assert_same(tc._count_chunked(pool, starts, k1, min_count, 1 << 16,
                                   "cpu"), want)


@pytest.mark.parametrize("k1", [22, 42])
def test_count_many_chunks_match_jax(pools, k1):
    flat, starts = pools["chunked"]
    assert int(starts[-1]) > 2 * (1 << 16)  # at least three chunks
    want = jc.count_canonical_kmers(flat, starts, k1, 2, return_rare=True,
                                    batch_windows=1 << 16)
    pool = tc.as_pool(flat)
    _assert_same(tc._count_chunked(pool, starts, k1, 2, 1 << 16, "cpu"),
                 want)
    _assert_same(tc.count_canonical_kmers(
        flat, starts, k1, 2, return_rare=True, batch_windows=1 << 16,
        device="cpu"), want)


def test_count_from_converted_lib(pools):
    """megahit_tpu's packed pool, converted, counts the same: the port
    packs bases exactly as megahit_tpu does."""
    flat, starts = pools["small"]
    jpool = jlib.PackedPool.from_codes(flat)
    words = jpool.window_padded(0, jpool.n_words)
    lib = convert.sequence_lib(words, jpool.n_bases, starts,
                               [(0, len(starts) - 1, False)])
    np.testing.assert_array_equal(lib.flat_codes, flat)
    np.testing.assert_array_equal(
        tc.as_pool(flat).window_padded(0, jpool.n_words), words)
    pool = convert.packed_pool(words, jpool.n_bases)
    want = jc.count_canonical_kmers(jpool, starts, 22, 2, return_rare=True)
    for p in (pool, lib.pool):
        _assert_same(tc.count_canonical_kmers(
            p, lib.starts, 22, 2, return_rare=True, device="cpu"), want)


def test_fused_capacity_overflow_returns_none(pools):
    """More distinct keys than the single shot's capacity: the fused
    branch reports it, and the caller counts in chunks instead."""
    flat, starts = pools["small"]
    pool = tc.as_pool(flat)
    assert tc._count_fused(pool, starts, 22, 2, "cpu", cap=16) is None


@pytest.mark.parametrize("k1", [22, 42])
def test_kmax_mul_clip(k1):
    """A k-mer seen more than 65535 times is clipped to KMAX_MUL in
    every branch, as in megahit_tpu."""
    rng = np.random.default_rng(k1)
    reads = [np.zeros(70_000 + k1, np.uint8)]  # 70001 all-A windows
    reads += [rng.integers(0, 4, 90).astype(np.uint8) for _ in range(50)]
    flat, starts = packing.pack_many(reads)
    want = jc.count_canonical_kmers(flat, starts, k1, 2, return_rare=True)
    assert want[1].max() == tc.KMAX_MUL
    pool = tc.as_pool(flat)
    _assert_same(tc._count_fused(pool, starts, k1, 2, "cpu"), want)
    _assert_same(tc._count_chunked(pool, starts, k1, 2, 1 << 16, "cpu"),
                 want)
    _assert_same(tc.count_canonical_kmers(
        flat, starts, k1, 2, return_rare=True, device="cpu"), want)


def test_count_empty_and_short_pools():
    flat, starts = packing.pack_many([np.zeros(10, np.uint8)])
    for out in (jc.count_canonical_kmers(flat, starts, 22, 2,
                                         return_rare=True),
                tc.count_canonical_kmers(flat, starts, 22, 2,
                                         return_rare=True, device="cpu")):
        assert [a.shape for a in out] == [(0, 2), (0,), (0, 2)]


def test_count_default_device_is_cuda(pools):
    """Without device="cpu" the count runs on CUDA; on a box without a
    card that raises instead of carrying on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    flat, starts = pools["small"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.count_canonical_kmers(flat, starts, 22, 2)
