"""Mercy's node lookup on the job's device
(`megahit_tpu_torch.graph.mercy._node_flags` over `_node_keys`) against
a plain np.searchsorted over the host u64 form of the same table, and
whole scans of several chunks against megahit_tpu's find_mercy_edges on
both paths (dense, and candidate reads from the rare keys), here on
device="cpu". The card's counterpart: tests/test_torch_mercy_table_gpu.py."""

import numpy as np
import pytest
import torch

from megahit_tpu.graph import mercy as jm
from megahit_tpu_torch.core import kmerops
from megahit_tpu_torch.graph import counter as tc
from megahit_tpu_torch.graph import mercy as tm

import torch_test_env  # noqa: F401
from mercy_table_cases import host_u64, mercy_reads, read_end_reads

M32 = np.uint64(0xFFFFFFFF)


def _kmers(rng, n, k, top_base=None):
    """(n, W) random k-mers (tail masked), first base fixed if given."""
    w = kmerops.words_per_kmer(k)
    words = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64)
    words = words.astype(np.uint32)
    if top_base is not None:
        words[:, 0] = (words[:, 0] & 0x3FFFFFFF) | (top_base << 30)
    return kmerops.mask_tail(words, k)


def _table(rng, k, n, top_base=None):
    """A node table as `_node_sets` keeps it: ascending distinct int64
    node keys and flags 1 to 3."""
    keys = tm._node_keys(torch.from_numpy(
        _kmers(rng, n, k, top_base).astype(np.int64)))
    table = torch.unique(keys)
    flags = torch.from_numpy(rng.integers(1, 4, len(table), dtype=np.uint8))
    return table, flags


@pytest.mark.parametrize("k1", [22, 32])
@pytest.mark.parametrize("case", ["present_and_absent", "above_last",
                                  "below_first", "empty_table"])
def test_node_flags_match_host_searchsorted(case, k1):
    k = k1 - 1
    rng = np.random.default_rng(k1)
    n = 0 if case == "empty_table" else 3000
    # the table's first bases span 1 to 2 where queries pass its ends
    top = {"above_last": 1, "below_first": 2}.get(case)
    table, flags = _table(rng, k, n, top)
    words = _kmers(rng, 2000, k, {"above_last": 3, "below_first": 0}.get(
        case))
    if n:  # a third of the queries are rows of the table, both ends too
        pick = rng.integers(0, len(table), 1000)
        pick[:2] = 0, len(table) - 1
        rows = host_u64(table, flags)[0][pick]
        both = np.stack([rows >> np.uint64(32), rows & M32], 1)
        words = np.concatenate(
            [words, both[:, :words.shape[1]].astype(np.uint32)])
    got = tm._node_flags(table, flags, tm._node_keys(
        torch.from_numpy(words.astype(np.int64)))).numpy()

    u64, f = host_u64(table, flags)
    q = kmerops.keys_to_u64(words, 32)
    want = np.zeros(len(q), dtype=np.uint8)
    if len(u64):
        i = np.minimum(np.searchsorted(u64, q), len(u64) - 1)
        want = np.where(u64[i] == q, f[i], 0).astype(np.uint8)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    hits = int((want > 0).sum())
    assert {"present_and_absent": 1000 <= hits < len(q),
            "above_last": hits == 1000 and q.max() > u64.max(),
            "below_first": hits == 1000 and q.min() < u64.min(),
            "empty_table": len(u64) == 0 and hits == 0}[case]


@pytest.mark.parametrize("k1", [22, 32])
def test_chunked_scans_match_jax(k1):
    flat, starts = mercy_reads(np.random.default_rng(k1))
    keys, _, rare = tc.count_canonical_kmers(flat, starts, k1, 2,
                                             return_rare=True, device="cpu")
    got = {}
    for path, rk in (("dense", None), ("candidates", rare)):
        want = jm.find_mercy_edges(flat, starts, keys, k1, 1 << 16,
                                   rare_keys=rk)
        got[path] = tm.find_mercy_edges(flat, starts, keys, k1, 1 << 16,
                                        rare_keys=rk, device="cpu")
        np.testing.assert_array_equal(got[path], want)
    np.testing.assert_array_equal(got["dense"], got["candidates"])
    assert int(starts[-1]) > 1 << 16 and len(got["dense"]) > 0
    assert (np.diff(starts) < k1 + 1).any()


@pytest.mark.parametrize("k1", [22, 32])
def test_read_end_rules_match_jax(k1):
    flat, starts = read_end_reads(k1)
    keys, _, rare = tc.count_canonical_kmers(flat, starts, k1, 2,
                                             return_rare=True, device="cpu")
    for rk in (None, rare):
        want = jm.find_mercy_edges(flat, starts, keys, k1, rare_keys=rk)
        got = tm.find_mercy_edges(flat, starts, keys, k1, rare_keys=rk,
                                  device="cpu")
        np.testing.assert_array_equal(got, want)
    assert len(want) == 100 + k1 - 1  # A's gap windows; B's read gives none
