"""The port's mesh paths on one-process CPU meshes, Mesh(["cpu"] * n):
the bucketed builder's sample-sorted rounds (build_sdbg_bucketed(mesh=))
and the mesh-sharded cleaning engine (DeviceCleaner(mesh=)).

megahit_tpu's mesh programs are not run here (its own tests hold them
equal to its single-device ones): the port's sharded runs must equal
megahit_tpu's unsharded bucketed build (every Sdbg array, the shard
files) and the port's and megahit_tpu's unsharded cleaning engines
(records and stats). The cases are the ports of
tests/test_bucketed.py::test_bucketed_on_mesh,
tests/test_sharded_sdbg.py::test_mesh_built_10m_edge_roundtrip and
tests/test_device_cleaning.py's three mesh tests."""

import json
import os

import numpy as np
import pytest

from megahit_tpu.core import packing
from megahit_tpu.graph import bucketed as jbk
from megahit_tpu.graph.counter import count_canonical_kmers
from megahit_tpu.graph.sdbg import sdbg_from_edges as j_sdbg_from_edges
from megahit_tpu.pipeline import assemble as jasm
from megahit_tpu_torch.graph import assemble_device as tad
from megahit_tpu_torch.graph import bucketed as bk
from megahit_tpu_torch.graph import cleaning as tcl
from megahit_tpu_torch.graph.sdbg import Sdbg, sdbg_from_edges
from megahit_tpu_torch.graph.unitig import build_unitig_graph
from megahit_tpu_torch.parallel import multihost
from megahit_tpu_torch.parallel.multihost import Mesh
from megahit_tpu_torch.pipeline import assemble as tasm

from cleaning_cases import records
from torch_test_env import assert_same_files

RNG = np.random.default_rng(42)
SDBG_ARRAYS = ("keys", "mult", "valid", "run_start", "nxt_link", "rc")


def _assert_sdbg_equal(t, j):
    assert (t.k, t.real, t.size) == (j.k, j.real, j.size)
    for name in SDBG_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                      np.asarray(getattr(j, name)), name)


# ---------------------------------------------------------------------------
# bucketed builder
# ---------------------------------------------------------------------------


def _random_pool(n_seqs, length, rng):
    return packing.pack_many([rng.integers(0, 4, size=length).astype(
        np.uint8) for _ in range(n_seqs)])


@pytest.mark.parametrize("mode", ["max", "count"])
def test_bucketed_on_mesh(tmp_path, mode):
    """tests/test_bucketed.py::test_bucketed_on_mesh's input over an
    8-shard mesh: every round sample-sorted, the graph equal to
    megahit_tpu's unsharded bucketed build."""
    flat, starts = _random_pool(24, 150, np.random.default_rng(8))
    mults = np.ones(24, np.int32)
    kw = dict(mult_mode=mode, min_count=2) if mode == "count" else {}
    ref = jbk.build_sdbg_bucketed(
        [jbk.PoolSource(flat, starts, mults)], 22, budget_rows=2048,
        spill_dir=str(tmp_path / "spill_jax"), **kw)
    stats = bk.BuildStats()
    out = bk.build_sdbg_bucketed(
        [bk.PoolSource(flat, starts, mults)], 22, budget_rows=2048,
        spill_dir=str(tmp_path / "spill_mesh"), stats=stats, device="cpu",
        mesh=Mesh(["cpu"] * 8), **kw)
    assert stats.n_rounds > 1
    _assert_sdbg_equal(out, ref)


def test_bucketed_on_mesh_with_shard_dir(tmp_path):
    """The mesh build streaming to shard files: the files equal
    megahit_tpu's unsharded build's, and reload to the graph."""
    flat, starts = _random_pool(60, 120, np.random.default_rng(9))
    mults = np.ones(60, np.int32)
    jd, td = str(tmp_path / "shards_jax"), str(tmp_path / "shards_torch")
    ref = jbk.build_sdbg_bucketed(
        [jbk.PoolSource(flat, starts, mults)], 22, budget_rows=4096,
        spill_dir=str(tmp_path / "spill_jax"), shard_dir=jd,
        mult_mode="count", min_count=1)
    out = bk.build_sdbg_bucketed(
        [bk.PoolSource(flat, starts, mults)], 22, budget_rows=4096,
        spill_dir=str(tmp_path / "spill_mesh"), shard_dir=td,
        mult_mode="count", min_count=1, device="cpu",
        mesh=Mesh(["cpu"] * 4))
    _assert_sdbg_equal(out, ref)
    assert_same_files(jd, td)
    _assert_sdbg_equal(Sdbg.load_sharded(td, device="cpu"), ref)


@pytest.mark.slow
def test_mesh_built_10m_edge_roundtrip(tmp_path):
    """A >= 1e7-edge graph built over an 8-shard mesh into shard files
    reloads equal."""
    big = RNG.integers(0, 4, 6_000_000).astype(np.uint8)
    reads = [big[s:s + 100] for s in range(0, len(big) - 100, 50)]
    flat, starts = packing.pack_many(reads)
    d = str(tmp_path / "shards")
    sdbg = bk.build_sdbg_bucketed(
        [bk.PoolSource(flat, starts, np.ones(len(reads), np.int32))], 22,
        budget_rows=1 << 22, spill_dir=str(tmp_path / "spill"),
        shard_dir=d, min_count=1, mult_mode="count", device="cpu",
        mesh=Mesh(["cpu"] * 8))
    assert int(sdbg.valid.sum()) >= 10_000_000
    back = Sdbg.load_sharded(d, device="cpu")
    assert back.real == sdbg.real
    for name in ("keys", "mult", "valid"):
        np.testing.assert_array_equal(getattr(back, name)[:sdbg.real],
                                      getattr(sdbg, name)[:sdbg.real])
    with open(os.path.join(d, "sdbg_manifest.json")) as fh:
        assert len(json.load(fh)["shards"]) >= 1


# ---------------------------------------------------------------------------
# mesh-sharded cleaning engine
# ---------------------------------------------------------------------------


def _reads_from_genome(genome, n_reads, rl, err, rng):
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, len(genome) - rl))
        r = genome[s: s + rl].copy()
        if err:
            m = rng.random(rl) < err
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if rng.random() < 0.5:
            r = packing.revcomp_codes(r)
        reads.append(r)
    return reads


def _edges(reads, min_count):
    flat, starts = packing.pack_many(reads)
    return count_canonical_kmers(flat, starts, 22, min_count)


@pytest.fixture
def device_engine(monkeypatch):
    """Run the port's device engine on CPU tensors, and keep every
    engine assemble() builds."""
    monkeypatch.setattr(tad, "use_device_cleaning", lambda device: True)
    made = []

    class Recorded(tad.DeviceCleaner):
        def __init__(self, g, mesh=None):
            super().__init__(g, mesh=mesh)
            made.append(self)

    monkeypatch.setattr(tad, "DeviceCleaner", Recorded)
    return made


@pytest.mark.parametrize("err,prune,careful", [
    (0.0, 2, False),
    (0.01, 2, True),
    (0.02, 3, True),
])
def test_mesh_device_cleaning_matches_single(err, prune, careful,
                                             device_engine, monkeypatch):
    """The cases of tests/test_device_cleaning.py::
    test_mesh_device_cleaning_matches_single: the port's engine sharded
    over an 8-shard mesh (AssembleOptions.use_mesh) equals the port's
    unsharded engine and megahit_tpu's unsharded device engine, records
    and stats."""
    rng = np.random.default_rng(hash((err, prune, 5)) % (2**31))
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    genome[3000:3100] = genome[500:600]
    reads = _reads_from_genome(genome, 1500, 100, err, rng)
    keys, counts = _edges(reads, 1 if err == 0 else 2)
    kw = dict(prune_level=prune, careful_bubble=careful,
              min_standalone=200, output_standalone=True,
              merge_similar=0.95)

    monkeypatch.setenv("MEGAHIT_TPU_DEVICE_CLEAN", "1")
    want = jasm.assemble(j_sdbg_from_edges(keys, counts, 22),
                         jasm.AssembleOptions(**kw))
    monkeypatch.setattr(multihost, "global_shard_mesh",
                        lambda device: Mesh(["cpu"] * 8))
    out = []
    for use_mesh in (False, True):
        out.append(tasm.assemble(
            sdbg_from_edges(keys, counts, 22, device="cpu"),
            tasm.AssembleOptions(use_mesh=use_mesh, **kw)))
    assert [e.mesh is not None for e in device_engine] == [False, True]
    assert device_engine[1].mesh.size == 8
    single, mesh = out
    assert records(mesh) == records(single) == records(want)
    assert mesh.stats == single.stats == want.stats


def _graph(seed, n_bases, n_reads, err, min_count):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n_bases).astype(np.uint8)
    genome[n_bases // 2: n_bases // 2 + 100] = genome[400:500]
    keys, counts = _edges(
        _reads_from_genome(genome, n_reads, 100, err, rng), min_count)
    return sdbg_from_edges(keys, counts, 22, device="cpu")


def test_mesh_cleaner_actually_shards():
    """Every E-sized and Vc-sized tensor is held as the mesh's row
    blocks, block i on shard i, size / n rows each; a pass runs on the
    sharded state and equals the unsharded engine."""
    mesh = Mesh(["cpu"] * 8)
    eng = tad.DeviceCleaner(build_unitig_graph(_graph(11, 4000, 900, 0.0,
                                                      1)), mesh=mesh)
    ref = tad.DeviceCleaner(build_unitig_graph(_graph(11, 4000, 900, 0.0,
                                                      1)))
    assert eng.mesh is mesh and ref.mesh is None
    e, vc = eng.sdbg.size, eng.vc
    for held, rows in ((eng._static, e), (eng._state, None)):
        for name, blocks in vars(held).items():
            if not isinstance(blocks, list):
                continue
            n = rows if rows is not None else (
                e if name in ("valid", "vid", "nxt", "prv", "chain_start",
                              "edge_pos") else vc)
            assert len(blocks) == 8, name
            assert all(b.shape[0] == n // 8 for b in blocks), name
            assert all(b.device == d for b, d in zip(blocks, mesh.devices))
    assert eng.remove_tips(20) == ref.remove_tips(20)
    a, b = eng.to_host(), ref.to_host()
    for name in ("start", "end", "length", "total_depth", "vid", "alive",
                 "nxt", "prv"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      name)


def test_mesh_device_cleaning_two_device_mesh():
    """Pass by pass over a 2-shard mesh against the port's host cleaning
    (tests/test_device_cleaning.py::
    test_mesh_device_cleaning_two_device_mesh)."""
    g_host = build_unitig_graph(_graph(21, 6000, 1600, 0.01, 2))
    eng = tad.DeviceCleaner(build_unitig_graph(_graph(21, 6000, 1600, 0.01,
                                                      2)),
                            mesh=Mesh(["cpu"] * 2))
    assert eng.mesh is not None and eng.mesh.size == 2
    for max_tip in (20, 40):
        g_host, n_h = tcl.remove_tips(g_host, max_tip)
        assert n_h == eng.remove_tips(max_tip)
    g_host, n_h = tcl.disconnect_weak_links(g_host, 0.1)
    assert n_h == eng.disconnect_weak_links(0.1)
    g_host, n_h = tcl.pop_bubbles(g_host, 23, permanent=True)
    assert n_h == eng.pop_bubbles(23, permanent=True)
    gd = eng.to_host()

    def sig(g):
        a = g.alive
        return sorted(zip(g.length[a].tolist(), g.total_depth[a].tolist()))

    assert int(g_host.alive.sum()) == int(gd.alive.sum())
    assert sig(g_host) == sig(gd)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_mesh_eligibility(n):
    """megahit_tpu's rule: one shard, or a shard count that does not
    divide the (power-of-two) capacities, leaves the engine unsharded."""
    g = build_unitig_graph(_graph(11, 4000, 900, 0.0, 1))
    eng = tad.DeviceCleaner(g, mesh=Mesh(["cpu"] * n))
    assert eng.mesh is None
    assert not isinstance(eng._static.run_start, list)


def test_cli_has_mesh_and_lacks_only_platform():
    """A diff of the two CLI parsers finds only --platform missing from
    the port (its --device replaces it); --mesh sets use_mesh."""
    from megahit_tpu.__main__ import make_parser as jax_parser
    from megahit_tpu_torch.__main__ import make_parser as torch_parser

    def flags(p):
        return {s for a in p._actions for s in a.option_strings}

    assert flags(jax_parser()) - flags(torch_parser()) == {"--platform"}
    assert torch_parser().parse_args(["--mesh"]).use_mesh
    assert not torch_parser().parse_args([]).use_mesh
