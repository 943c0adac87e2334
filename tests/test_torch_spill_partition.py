"""The spill's rows put in bucket order on the device
(megahit_tpu_torch/graph/bucketed.py, `_spill_pool` and `_spill_edges`)
against the host route it replaced (tests/spill_partition_cases.py):
over three or more chunks, at k1 = 22, 32 and 48, for a pool in the
unit layout and in the counted one and for an EdgeSource, the 256 spill
files are byte-identical and the bucket counts equal, with one
`spill.extract` span a chunk."""

import numpy as np
import pytest

from megahit_tpu_torch.core import kmerops
from megahit_tpu_torch.graph import bucketed
from megahit_tpu_torch.utils.timers import PhaseTimer

import torch_test_env  # noqa: F401
from spill_partition_cases import (CHUNK, K1S, SOURCES, edge_source,
                                   host_spill, pool_source, spill_files)


@pytest.mark.parametrize("step", [bucketed._STEP, 4099])
@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("source", SOURCES)
def test_spill_files_match_host_route(source, k1, step, tmp_path,
                                      monkeypatch):
    """`step`: the rows of a step of the device partition; at 4099 a
    chunk's rows take many steps."""
    monkeypatch.setattr(bucketed, "_STEP", step)
    rng = np.random.default_rng(k1)
    unit = source == "unit"
    spill = bucketed.SpillSet(str(tmp_path), "edges",
                              kmerops.words_per_kmer(k1) + (not unit))
    t = PhaseTimer()
    with t.phase("spill"):
        if source == "edges":
            src = edge_source(k1, 3 * CHUNK - 5, rng)
            total = bucketed._spill_edges(spill, src, k1, CHUNK, "cpu")
        else:
            src = pool_source(source, 2000, rng)
            total = bucketed._spill_pool(spill, src, k1, CHUNK, "cpu",
                                         unit=unit)
    want, want_counts = host_spill(src, k1, CHUNK, unit)
    got = spill_files(spill)
    assert sorted(got) == sorted(want)
    for b in want:
        assert got[b] == want[b], b
    np.testing.assert_array_equal(spill.counts, want_counts)
    assert total == want_counts.sum() > 0
    assert sum(r.name == "spill.extract"
               for r in t.spans().records) >= 3
