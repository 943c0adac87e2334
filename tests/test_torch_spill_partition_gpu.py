"""The spill's rows put in bucket order on the card against the host
route it replaced (tests/spill_partition_cases.py), as
tests/test_torch_spill_partition.py holds the same code on the CPU: for
a pool in either layout and for an EdgeSource, the 256 spill files
byte-identical, the bucket counts equal. And the
chunk's device working set: a 2^22-window chunk of 150-base reads
allocates at most 64 B a window, the budget of
`Pipeline._batch_windows`. Marked `gpu`; skips without a CUDA device.

This file imports neither JAX nor megahit_tpu:

    python -m pytest --noconftest -m gpu tests/test_torch_spill_partition_gpu.py
"""

import numpy as np
import pytest
import torch

from megahit_tpu_torch.core import kmerops
from megahit_tpu_torch.graph import bucketed

from spill_partition_cases import (CHUNK, K1S, SOURCES, edge_source,
                                   host_spill, pool_source, spill_files)

pytestmark = pytest.mark.gpu

# the device bytes a window that Pipeline._batch_windows budgets
WINDOW_BYTES = 64


@pytest.fixture(autouse=True)
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _spill_set(tmp_path, k1, source):
    return bucketed.SpillSet(str(tmp_path), "edges",
                             kmerops.words_per_kmer(k1)
                             + (source != "unit"))


@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("source", SOURCES)
def test_spill_files_on_card_match_host_route(source, k1, tmp_path):
    rng = np.random.default_rng(k1)
    unit = source == "unit"
    spill = _spill_set(tmp_path, k1, source)
    if source == "edges":
        src = edge_source(k1, 3 * CHUNK - 5, rng)
        total = bucketed._spill_edges(spill, src, k1, CHUNK, "cuda")
    else:
        src = pool_source(source, 2000, rng)
        total = bucketed._spill_pool(spill, src, k1, CHUNK, "cuda",
                                     unit=unit)
    want, want_counts = host_spill(src, k1, CHUNK, unit)
    got = spill_files(spill)
    assert sorted(got) == sorted(want)
    for b in want:
        assert got[b] == want[b], b
    np.testing.assert_array_equal(spill.counts, want_counts)
    assert total == want_counts.sum() > 0


@pytest.mark.parametrize("k1, layout", [(22, "unit"), (32, "counted")])
def test_chunk_peak_device_memory(k1, layout, tmp_path):
    windows = 1 << 22
    src = pool_source(layout, 30000, np.random.default_rng(7),
                      read_len=150)
    assert int(src.starts[-1]) > windows  # a whole first chunk
    spill = _spill_set(tmp_path, k1, layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    total = bucketed._spill_pool(spill, src, k1, windows, "cuda",
                                 unit=layout == "unit")
    peak = torch.cuda.max_memory_allocated() - base
    print(f"k1={k1} {layout}: peak {peak} B over {windows} windows, "
          f"{peak / windows:.2f} B a window; {total} rows")
    assert total == spill.counts.sum() > windows
    assert peak <= WINDOW_BYTES * windows
