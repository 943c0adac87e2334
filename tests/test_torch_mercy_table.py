"""Mercy's k <= 31 node table, built with torch ops on the job's device
(`megahit_tpu_torch.graph.mercy._node_sets`), against megahit_tpu's
host build (`megahit_tpu.graph.mercy._node_sets_u64`): the table, taken
to host u64, and its flags equal in dtype, order and value, here on
device="cpu".
The same cases on the card: tests/test_torch_mercy_table_gpu.py."""

import numpy as np
import pytest

from megahit_tpu.graph import mercy as jm
from megahit_tpu_torch.core import kmerops
from megahit_tpu_torch.graph import mercy as tm

import torch_test_env  # noqa: F401
from mercy_table_cases import CASES, K1S, host_u64


@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("case", CASES)
def test_node_table_matches_jax(case, k1):
    keys = CASES[case](k1, np.random.default_rng(k1))
    want_table, want_flags = jm._node_sets_u64(keys, k1)
    table, flags = host_u64(*tm._node_sets(keys, k1, "cpu"))
    assert table.dtype == want_table.dtype == np.uint64
    assert flags.dtype == want_flags.dtype == np.uint8
    np.testing.assert_array_equal(table, want_table)
    np.testing.assert_array_equal(flags, want_flags)
    # each case holds what it is named for
    n_pal = int(kmerops.lex_eq(kmerops.revcomp_kmers(keys, k1), keys).sum())
    assert {
        "random_set": len(keys) > 2900 and len(table) > 10000,
        "palindromes": n_pal >= 100,
        "shared_nodes": (flags == 3).sum() > 1000,
        "single_key": len(keys) == 1 and 1 <= len(table) <= 4,
        "empty": len(table) == 0,
    }[case]
