"""The port's graph stages against megahit_tpu's: mercy, the SdBG, tip
removal, the unitig graph and each cleaning pass.

The same seeded reads go through both packages (megahit_tpu on the JAX
CPU backend, the port with device="cpu"). Every array must be exactly
equal. The unitig and cleaning checks start each step from megahit_tpu's
state, converted with megahit_tpu_torch.convert, so a difference is
pinned to the step that made it. The whole-graph torch passes that a
CUDA graph runs (tips, simple-path links, list ranking) are also run
here on CPU tensors and held to the same arrays."""

import numpy as np
import pytest

from megahit_tpu.graph import cleaning as jcl
from megahit_tpu.graph import counter as jc
from megahit_tpu.graph import mercy as jm
from megahit_tpu.graph import output as jout
from megahit_tpu.graph import sdbg as js
from megahit_tpu.graph import unitig as ju
from megahit_tpu_torch import convert
from megahit_tpu_torch.core import packing
from megahit_tpu_torch.graph import cleaning as tcl
from megahit_tpu_torch.graph import counter as tc
from megahit_tpu_torch.graph import mercy as tm
from megahit_tpu_torch.graph import output as tout
from megahit_tpu_torch.graph import sdbg as ts
from megahit_tpu_torch.graph import unitig as tu
from megahit_tpu_torch.utils import device as devices

import torch_test_env  # noqa: F401

SDBG_FIELDS = ("keys", "mult", "valid", "rc", "run_start", "nxt_link",
               "rvc")


def _revcomp(r):
    return packing.revcomp_codes(r)


def _graph_reads(seed):
    """Two haplotypes (SNPs make bubbles), reads with errors that are
    sometimes repeated (solid error k-mers make tips and bubbles), and
    a circular sequence (a loop)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 2500).astype(np.uint8)
    b = a.copy()
    snp = np.arange(200, 2300, 230)
    b[snp] = (b[snp] + 1) % 4
    reads = []
    for hap, cov in ((a, 14), (b, 5)):
        for _ in range(cov * len(hap) // 100):
            s = int(rng.integers(0, len(hap) - 100))
            r = hap[s:s + 100].copy()
            copies = 1
            if rng.random() < 0.25:
                p = int(rng.integers(0, 100))
                r[p] = (r[p] + int(rng.integers(1, 4))) % 4
                copies = 2 if rng.random() < 0.4 else 1
            for _ in range(copies):
                reads.append(_revcomp(r) if rng.random() < 0.5 else r)
    loop = rng.integers(0, 4, 300).astype(np.uint8)
    two = np.concatenate([loop, loop])
    for off in (0, 100, 200) * 3:
        reads.append(two[off:off + 280].copy())
    return packing.pack_many(reads)


def _assert_sdbg(t, j):
    assert (t.k, t.size, t.real) == (j.k, j.size, j.real)
    for f in SDBG_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(t, f)), np.asarray(getattr(j, f)), f)
    # ref_rank is cached at first use, so its values depend on which
    # rows were valid then; the order of the valid rows must agree
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(
        np.argsort(np.asarray(t.ref_rank)[v], kind="stable"),
        np.argsort(np.asarray(j.ref_rank)[v], kind="stable"), "ref_rank")


def _assert_unitig(t, j, loop_pos=True):
    """loop_pos=False: edge_pos on loop edges is left out. It is
    undefined there (megahit_tpu/graph/unitig.py documents it so, and no
    consumer reads it): the host walk numbers loop edges, the pointer
    doubling of the device branch does not."""
    assert t.k == j.k
    for f in convert.UNITIG_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        if f == "edge_pos" and not loop_pos:
            vid = np.asarray(j.vid)
            on_loop = (vid >= 0) & np.asarray(j.is_loop)[np.maximum(vid, 0)]
            a, b = a[~on_loop], b[~on_loop]
        np.testing.assert_array_equal(a, b, f)
    _assert_sdbg(t.sdbg, j.sdbg)


def _port_sdbg(j):
    """The port's Sdbg holding megahit_tpu's graph state."""
    return convert.sdbg(j.k, np.asarray(j.keys), np.asarray(j.mult),
                        np.array(j.valid), rc=np.asarray(j.rc),
                        real=j.real, device="cpu")


def _port_unitig(jg):
    return convert.unitig_graph(
        jg.k, _port_sdbg(jg.sdbg),
        {f: getattr(jg, f) for f in convert.UNITIG_FIELDS})


@pytest.fixture
def torch_graph_passes(monkeypatch):
    """Run the port's CUDA-side whole-graph torch passes on CPU
    tensors (the dispatch normally keeps a CPU graph on the host
    engine)."""
    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)


# ---------------------------------------------------------------------------
# mercy
# ---------------------------------------------------------------------------


def _mercy_tiles(rng):
    genome = rng.integers(0, 4, size=500).astype(np.uint8)
    reads = []
    tile_starts = list(range(0, 400, 50))
    for j, i in enumerate(tile_starts):
        reads.append(genome[i:i + 100].copy())
        if j != len(tile_starts) // 2:
            reads.append(genome[i:i + 100].copy())
    return reads


def _mercy_no_gap(rng):
    genome = rng.integers(0, 4, size=300).astype(np.uint8)
    return [genome[i:i + 100].copy() for i in range(0, 200, 2)
            for _ in range(2)]


def _mercy_islands(rng):
    genome = rng.integers(0, 4, size=800).astype(np.uint8)
    reads = [genome[s:s + 60].copy()
             for s in list(range(0, 240, 3)) + list(range(450, 740, 3))]
    reads.append(genome[260:480].copy())
    return reads


@pytest.mark.parametrize("case", [_mercy_tiles, _mercy_no_gap,
                                  _mercy_islands])
@pytest.mark.parametrize("k1", [22, 42])
def test_mercy_matches_jax(case, k1):
    reads = case(np.random.default_rng(11))
    flat, starts = packing.pack_many(reads)
    keys, _, rare = jc.count_canonical_kmers(flat, starts, k1, 2,
                                             return_rare=True)
    for rk in (None, rare):
        want = jm.find_mercy_edges(flat, starts, keys, k1, rare_keys=rk)
        got = tm.find_mercy_edges(flat, starts, keys, k1, rare_keys=rk,
                                  device="cpu")
        np.testing.assert_array_equal(got, want)
    # the bridging read of the islands starts too late for a gap at k1=42
    if case is _mercy_tiles or (case is _mercy_islands and k1 == 22):
        assert len(want) > 0


# ---------------------------------------------------------------------------
# SdBG, tips, unitigs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[22, 32, 42])
def graphs(request):
    """(k1, megahit_tpu Sdbg, port Sdbg) built from the same reads by
    each package's own count -> mercy -> sdbg_from_edges."""
    k1 = request.param
    flat, starts = _graph_reads(k1)
    jk, jcnt, jrare = jc.count_canonical_kmers(flat, starts, k1, 2,
                                               return_rare=True)
    jmer = jm.find_mercy_edges(flat, starts, jk, k1, rare_keys=jrare)
    tk, tcnt, trare = tc.count_canonical_kmers(flat, starts, k1, 2,
                                               return_rare=True,
                                               device="cpu")
    tmer = tm.find_mercy_edges(flat, starts, tk, k1, rare_keys=trare,
                               device="cpu")
    np.testing.assert_array_equal(tmer, jmer)
    keys = np.concatenate([jk, jmer])
    cnts = np.concatenate([jcnt, np.ones(len(jmer), np.int32)])
    tkeys = np.concatenate([tk, tmer])
    tcnts = np.concatenate([tcnt, np.ones(len(tmer), np.int32)])
    return (k1, js.sdbg_from_edges(keys, cnts, k1),
            ts.sdbg_from_edges(tkeys, tcnts, k1, device="cpu"))


def test_sdbg_from_edges_matches_jax(graphs):
    _, jg, tg = graphs
    _assert_sdbg(tg, jg)
    assert tcl.infer_min_depth(tg) == jcl.infer_min_depth(jg)


def test_neighbor_tables_match_jax(graphs):
    """rc pairing and the four candidate tables, through the dispatch
    (the u64 path at k1 <= 32) and the general sort-join."""
    k1, jg, _ = graphs
    keys = np.asarray(jg.keys)[:jg.real]
    for jf, tf in ((js._neighbor_tables, ts._neighbor_tables),
                   (js._neighbor_tables_impl, ts._neighbor_tables_impl)):
        for a, b in zip(tf(keys, k1), jf(keys, k1), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("engine", ["host", "torch"])
def test_remove_tips_sdbg_matches_jax(graphs, engine, request):
    k1, jg0, _ = graphs
    if engine == "torch":
        request.getfixturevalue("torch_graph_passes")
    jg = jg0.__copy__()
    tg = _port_sdbg(jg0)
    n_j = js.remove_tips_sdbg(jg, 2 * (k1 - 1))
    n_t = ts.remove_tips_sdbg(tg, 2 * (k1 - 1))
    assert n_t == n_j > 0
    _assert_sdbg(tg, jg)


@pytest.mark.parametrize("engine", ["host", "torch"])
def test_unitig_graph_matches_jax(graphs, engine, request):
    k1, jg0, _ = graphs
    if engine == "torch":
        request.getfixturevalue("torch_graph_passes")
    jg = jg0.__copy__()
    js.remove_tips_sdbg(jg, 2 * (k1 - 1))
    want = ju.build_unitig_graph(jg)
    got = tu.build_unitig_graph(_port_sdbg(jg))
    assert want.size > 10 and want.is_loop.any()
    _assert_unitig(got, want, loop_pos=engine == "host")


def test_cleaning_passes_match_jax(graphs):
    """Each pass of the assembly's cleaning loop, from the same state:
    the removal count, every unitig and SdBG array and the bubble
    records must agree. Starts before SdBG tip removal, so the unitig
    tip pass has work to do."""
    k1, jg0, _ = graphs
    k = k1 - 1
    max_tip = 2 * k
    min_depth = jcl.infer_min_depth(jg0)
    jug = ju.build_unitig_graph(jg0.__copy__())
    jrec, trec = [], []

    def steps(m, rec):
        return [
            ("remove_tips", lambda g: m.remove_tips(g, max_tip)),
            ("pop_bubbles", lambda g: m.pop_bubbles(
                g, k + 2, True, careful_threshold=0.2,
                bubble_records=rec)),
            ("pop_complex_bubbles", lambda g: m.pop_complex_bubbles(
                g, 20, 0.95, True, careful_threshold=0.2,
                bubble_records=rec)),
            ("disconnect_weak_links",
             lambda g: m.disconnect_weak_links(g, 0.1)),
            ("remove_local_low_depth", lambda g: m.remove_local_low_depth(
                g, min_depth, max_tip, 1000, 0.1, True)[:2]),
            ("remove_tips_again", lambda g: m.remove_tips(g, max_tip)),
            ("remove_low_depth", lambda g: m.remove_low_depth(
                g, min_depth)),
            ("iterate_local_low_depth",
             lambda g: m.iterate_local_low_depth(
                 g, min_depth, max_tip, 1000, 0.2, False)),
        ]

    removed = 0
    for (name, jstep), (_, tstep) in zip(steps(jcl, jrec),
                                         steps(tcl, trec)):
        tug = _port_unitig(jug)
        jug, n_j = jstep(jug)
        tug, n_t = tstep(tug)
        assert n_t == n_j, name
        removed += n_j
        _assert_unitig(tug, jug)
        assert trec == jrec, name
    assert removed > 0
    for change_only in (False, True):
        want = jout.output_contigs(jug, change_only=change_only,
                                   min_standalone=3 * k, want_final=True)
        got = tout.output_contigs(_port_unitig(jug),
                                  change_only=change_only,
                                  min_standalone=3 * k, want_final=True)
        for g_list, w_list in zip(got, want):
            assert [(c.k, c.cid, c.flag, c.multi, c.codes.tobytes())
                    for c in g_list] == \
                [(c.k, c.cid, c.flag, c.multi, c.codes.tobytes())
                 for c in w_list]


# ---------------------------------------------------------------------------
# on-disk artifacts: each package reads what the other wrote
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["compact", "nav"])
def test_sdbg_files_interoperate(graphs, fmt, tmp_path):
    k1, jg, tg = graphs
    jg = jg.__copy__()
    js.remove_tips_sdbg(jg, 2 * (k1 - 1))  # some rows invalid
    jg.save(str(tmp_path / "j.sdbg.npz"), fmt=fmt)
    got = ts.Sdbg.load(str(tmp_path / "j.sdbg.npz"), device="cpu")
    _assert_sdbg(got, js.Sdbg.load(str(tmp_path / "j.sdbg.npz")))
    got.save(str(tmp_path / "t.sdbg.npz"), fmt=fmt)
    _assert_sdbg(got, js.Sdbg.load(str(tmp_path / "t.sdbg.npz")))
