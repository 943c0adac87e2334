"""Mercy's k <= 31 node table built on the card against the same build
on the CPU, which tests/test_torch_mercy_table.py holds to megahit_tpu:
table and flags equal in dtype, order and value. Marked `gpu`; skips
without a CUDA device.

This file imports neither JAX nor megahit_tpu:

    python -m pytest --noconftest -m gpu tests/test_torch_mercy_table_gpu.py
"""

import numpy as np
import pytest
import torch

from megahit_tpu_torch.graph import mercy

from mercy_table_cases import CASES, K1S

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("case", CASES)
def test_node_table_on_card_matches_cpu(case, k1):
    keys = CASES[case](k1, np.random.default_rng(k1))
    want_table, want_flags = mercy._node_sets(keys, k1, "cpu")
    table, flags = mercy._node_sets(keys, k1, "cuda")
    assert table.dtype == want_table.dtype == np.uint64
    assert flags.dtype == want_flags.dtype == np.uint8
    np.testing.assert_array_equal(table, want_table)
    np.testing.assert_array_equal(flags, want_flags)
