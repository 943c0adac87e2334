"""The port's sharded SdBG files against megahit_tpu's.

megahit_tpu's five non-slow cases of tests/test_sharded_sdbg.py run on
the port (multi-shard round trip, validity, a bucket-range load, the
empty graph, build_sdbg_bucketed(shard_dir=)), and the two packages'
files cross: the same graph written by each package gives a
byte-identical manifest and bucket_counts.npy and equal shards (array
by array: the zip members carry timestamps), and each package loads
the other's shards to the same graph. Tolerance: exact equality."""

import json
import os

import numpy as np
import pytest

from megahit_tpu.graph import bucketed as jbk
from megahit_tpu.graph.sdbg import Sdbg as JSdbg
from megahit_tpu.graph.sdbg import sdbg_from_edges as j_from_edges
from megahit_tpu_torch.core import packing
from megahit_tpu_torch.graph import bucketed as bk
from megahit_tpu_torch.graph.counter import count_canonical_kmers
from megahit_tpu_torch.graph.sdbg import Sdbg, sdbg_from_edges

from torch_test_env import assert_same_files

K1 = 22


def _reads(n_bases: int, step: int, seed: int, rl: int = 100):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n_bases).astype(np.uint8)
    return packing.pack_many(
        [genome[s:s + rl] for s in range(0, n_bases - rl, step)])


def _edges(n_bases=20000, seed=77):
    flat, starts = _reads(n_bases, 3, seed)
    return count_canonical_kmers(flat, starts, K1, 1, device="cpu")


def _graph(n_bases=20000, seed=77):
    return sdbg_from_edges(*_edges(n_bases, seed), K1, device="cpu")


def _assert_equal_graphs(a, b):
    assert a.k == b.k and a.real == b.real
    np.testing.assert_array_equal(a.keys[:a.real], b.keys[:b.real])
    np.testing.assert_array_equal(a.mult[:a.real], b.mult[:b.real])
    np.testing.assert_array_equal(a.valid[:a.real], b.valid[:b.real])


def test_sharded_roundtrip_multi_shard(tmp_path):
    sdbg = _graph()
    d = str(tmp_path / "shards")
    sdbg.save_sharded(d, rows_per_shard=4096)  # force many shards
    with open(os.path.join(d, "sdbg_manifest.json")) as fh:
        man = json.load(fh)
    assert man["format"] == "sharded-v1" and man["n_real"] == sdbg.real
    assert len(man["shards"]) > 3
    # shard boundaries are bucket boundaries: consecutive shards never
    # share a bucket
    for s1, s2 in zip(man["shards"], man["shards"][1:]):
        assert s1["bucket_hi"] <= s2["bucket_lo"] + 1
        assert s2["row_start"] == s1["row_start"] + s1["rows"]
    z = np.load(os.path.join(d, man["shards"][0]["file"]))
    assert sorted(z.files) == ["keys", "mult", "valid"]
    assert z["keys"].dtype == np.uint32 and z["mult"].dtype == np.uint16
    back = Sdbg.load_sharded(d, device="cpu")
    _assert_equal_graphs(sdbg, back)
    # navigation rebuilds identically
    np.testing.assert_array_equal(sdbg.rc[:sdbg.real], back.rc[:back.real])
    assert back.device.type == "cpu"


def test_sharded_preserves_validity(tmp_path):
    sdbg = _graph(8000)
    kill = np.zeros(sdbg.size, dtype=bool)
    kill[np.arange(0, sdbg.real, 17)] = True
    sdbg.invalidate(kill)
    d = str(tmp_path / "shards")
    sdbg.save_sharded(d, rows_per_shard=2048)
    _assert_equal_graphs(sdbg, Sdbg.load_sharded(d, device="cpu"))


def test_sharded_bucket_range_load(tmp_path):
    """A bucket range reads only its shards and returns exactly the rows
    of those buckets."""
    sdbg = _graph()
    d = str(tmp_path / "shards")
    sdbg.save_sharded(d, rows_per_shard=4096)
    b16 = (sdbg.keys[:sdbg.real, 0] >> np.uint32(16)).astype(np.int64)
    lo_b, hi_b = 17000, 40000
    sel = (b16 >= lo_b) & (b16 < hi_b)
    keys, mult, valid, off = Sdbg.load_sharded_rows(d, lo_b, hi_b)
    np.testing.assert_array_equal(keys, sdbg.keys[:sdbg.real][sel])
    np.testing.assert_array_equal(mult, sdbg.mult[:sdbg.real][sel])
    np.testing.assert_array_equal(valid, sdbg.valid[:sdbg.real][sel])
    assert off == int(np.flatnonzero(sel)[0])
    # full cover through disjoint ranges reassembles the graph
    parts = [Sdbg.load_sharded_rows(d, lo, hi)
             for lo, hi in ((0, 20000), (20000, 45000), (45000, 65536))]
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in parts], axis=0),
        sdbg.keys[:sdbg.real])
    np.testing.assert_array_equal(
        np.concatenate([p[1] for p in parts]), sdbg.mult[:sdbg.real])


def test_empty_graph_roundtrip(tmp_path):
    sdbg = sdbg_from_edges(np.zeros((0, 2), np.uint32),
                           np.zeros(0, np.int32), K1, device="cpu")
    d = str(tmp_path / "shards")
    sdbg.save_sharded(d)
    back = Sdbg.load_sharded(d, device="cpu")
    assert back.real == 0 and back.k == K1
    jd = str(tmp_path / "jax")
    j_from_edges(np.zeros((0, 2), np.uint32), np.zeros(0, np.int32),
                 K1).save_sharded(jd)
    assert_same_files(jd, d)


def _builds(tmp_path, mode):
    """Both packages' build_sdbg_bucketed with shard_dir on the same
    sources: count mode from reads (min_count 1 and 2), max mode from an
    edge set."""
    flat, starts = _reads(30000, 4, 78, rl=90)
    if mode == "max":
        keys, counts = _edges(12000, 79)
        srcs = [lambda m: m.EdgeSource(keys, counts),
                lambda m: m.PoolSource(flat, starts,
                                       np.full(len(starts) - 1, 3, np.int32))]
        kw = dict(mult_mode="max")
    else:
        srcs = [lambda m: m.PoolSource(flat, starts,
                                       np.ones(len(starts) - 1, np.int32))]
        kw = dict(mult_mode="count", min_count=int(mode[-1]))
    out = {}
    for name, m, extra in (("jax", jbk, {}),
                           ("torch", bk, {"device": "cpu"})):
        d = str(tmp_path / f"shards_{name}")
        stats = m.BuildStats()
        out[name] = (m.build_sdbg_bucketed(
            [s(m) for s in srcs], K1, budget_rows=8192,
            spill_dir=str(tmp_path / f"spill_{name}"), shard_dir=d,
            stats=stats, **kw, **extra), d, stats)
    return out


@pytest.mark.parametrize("mode", ["count1", "count2", "max"])
def test_builder_writes_shards_during_build(tmp_path, mode):
    """build_sdbg_bucketed(shard_dir=...) streams each round's edges into
    the sharded writer; the shards reload to the same graph, and both
    packages' builders write the same files."""
    out = _builds(tmp_path, mode)
    sdbg, d, stats = out["torch"]
    assert stats.n_rounds > 1
    _assert_equal_graphs(sdbg, Sdbg.load_sharded(d, device="cpu"))
    jsdbg, jd, _ = out["jax"]
    _assert_equal_graphs(jsdbg, sdbg)
    assert_same_files(jd, d)


@pytest.mark.parametrize("rows_per_shard", [2048, 1 << 24])
def test_files_cross_packages(tmp_path, rows_per_shard):
    """The same graph saved by each package: identical manifest and
    bucket counts, equal shards; each package loads the other's."""
    keys, counts = _edges()
    tg = sdbg_from_edges(keys, counts, K1, device="cpu")
    jg = j_from_edges(keys, counts, K1)
    kill = np.zeros(tg.size, dtype=bool)
    kill[np.arange(0, tg.real, 13)] = True
    tg.invalidate(kill)
    jg.invalidate(kill)
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    tg.save_sharded(td, rows_per_shard=rows_per_shard)
    jg.save_sharded(jd, rows_per_shard=rows_per_shard)
    assert_same_files(jd, td)
    _assert_equal_graphs(jg, Sdbg.load_sharded(jd, device="cpu"))
    _assert_equal_graphs(tg, JSdbg.load_sharded(td))
    for lo, hi in ((0, 30000), (30000, 65536)):
        for a, b in zip(Sdbg.load_sharded_rows(jd, lo, hi),
                        JSdbg.load_sharded_rows(td, lo, hi)):
            np.testing.assert_array_equal(a, b)
