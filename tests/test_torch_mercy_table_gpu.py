"""Mercy's k <= 31 node table built on the card against the same build
on the CPU, which tests/test_torch_mercy_table.py holds to megahit_tpu:
table and flags equal in dtype, order and value; and whole scans
(find_mercy_edges, dense and over candidate reads, with the node
lookups on the card) against the CPU's, which
tests/test_torch_mercy_lookup.py holds to megahit_tpu. Marked `gpu`;
skips without a CUDA device.

This file imports neither JAX nor megahit_tpu:

    python -m pytest --noconftest -m gpu tests/test_torch_mercy_table_gpu.py
"""

import numpy as np
import pytest
import torch

from megahit_tpu_torch.graph import counter, mercy

from mercy_table_cases import (CASES, K1S, host_u64, mercy_reads,
                               read_end_reads)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("case", CASES)
def test_node_table_on_card_matches_cpu(case, k1):
    keys = CASES[case](k1, np.random.default_rng(k1))
    want_table, want_flags = host_u64(*mercy._node_sets(keys, k1, "cpu"))
    table, flags = mercy._node_sets(keys, k1, "cuda")
    assert table.is_cuda and flags.is_cuda
    table, flags = host_u64(table, flags)
    assert table.dtype == want_table.dtype == np.uint64
    assert flags.dtype == want_flags.dtype == np.uint8
    np.testing.assert_array_equal(table, want_table)
    np.testing.assert_array_equal(flags, want_flags)


@pytest.mark.parametrize("k1", [22, 32])
@pytest.mark.parametrize("pool", ["mercy_reads", "read_ends"])
def test_find_mercy_edges_on_card_matches_cpu(pool, k1):
    flat, starts = (mercy_reads(np.random.default_rng(k1))
                    if pool == "mercy_reads" else read_end_reads(k1))
    keys, _, rare = counter.count_canonical_kmers(
        flat, starts, k1, 2, return_rare=True, device="cpu")
    for rk in (None, rare):
        want = mercy.find_mercy_edges(flat, starts, keys, k1, 1 << 16,
                                      rare_keys=rk, device="cpu")
        got = mercy.find_mercy_edges(flat, starts, keys, k1, 1 << 16,
                                     rare_keys=rk, device="cuda")
        np.testing.assert_array_equal(got, want)
        assert len(want) > 0
