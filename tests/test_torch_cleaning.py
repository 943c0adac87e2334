"""The port's device cleaning engine (megahit_tpu_torch/graph/
assemble_device.py) against megahit_tpu's, on the CPU.

The engine normally runs only for a graph on the card; here
`utils.device.graph_on_card` is patched so that the card's route runs
on CPU tensors. The
same seeded reads go through megahit_tpu's count and graph build; the
port starts from that graph (megahit_tpu_torch.convert). Pass by pass,
the port's DeviceCleaner must equal megahit_tpu's DeviceCleaner on the
JAX CPU backend: each pass's count, its bubble records (their depths
at megahit_tpu's float32; the port keeps depths in float64, as the host
engines do) and every UnitigGraph array of to_host(). Whole assemble()
runs (the five cases of tests/test_device_cleaning.py) must give
megahit_tpu's records, with its device engine forced on, and the port's
host engine's. A careful bubble whose depths tie at float32 must give
the host engine's records exactly."""

import logging

import numpy as np
import pytest

from megahit_tpu.core import packing
from megahit_tpu.graph import assemble_device as jad
from megahit_tpu.graph import cleaning as jcl
from megahit_tpu.graph import sdbg as js
from megahit_tpu.graph import unitig as ju
from megahit_tpu.graph.counter import count_canonical_kmers
from megahit_tpu.pipeline import assemble as jasm
from megahit_tpu_torch import convert
from megahit_tpu_torch.core import packing as tpk
from megahit_tpu_torch.graph import assemble_device as tad
from megahit_tpu_torch.graph import cleaning as tcl
from megahit_tpu_torch.graph import unitig as tu
from megahit_tpu_torch.graph.counter import \
    count_canonical_kmers as tcount
from megahit_tpu_torch.graph.sdbg import sdbg_from_edges
from megahit_tpu_torch.pipeline import assemble as tasm
from megahit_tpu_torch.utils import device as devices

from cleaning_cases import CASES, CLEAN, engine_steps, records

import torch_test_env  # noqa: F401


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, megahit_tpu Sdbg factory, AssembleOptions kwargs)."""
    reads, min_count, opt = CASES[request.param]()
    flat, starts = packing.pack_many(reads)
    keys, counts = count_canonical_kmers(flat, starts, 22, min_count)

    def factory():
        return js.sdbg_from_edges(keys, counts, 22)

    return request.param, factory, opt


@pytest.fixture
def device_engine(monkeypatch):
    """Run the port's device engine on CPU tensors."""
    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)


def _port_sdbg(j):
    return convert.sdbg(j.k, np.asarray(j.keys), np.asarray(j.mult),
                        np.array(j.valid), rc=np.asarray(j.rc),
                        real=j.real, device="cpu")


def _assert_graphs_equal(t, j, step):
    for f in convert.UNITIG_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(t, f)), np.asarray(getattr(j, f)),
            f"{step}: {f}")
    np.testing.assert_array_equal(t.sdbg.valid, np.asarray(j.sdbg.valid),
                                  f"{step}: valid")


def test_passes_match_jax_device_cleaner(case):
    """Every pass of both packages' device engines from the same graph:
    the count, the records and every to_host() array (the error-free
    cases leave nothing to remove)."""
    name, factory, _ = case
    jg = factory()
    k = jg.k - 1
    js.remove_tips_sdbg(jg, 2 * k)
    tg = _port_sdbg(jg)
    min_depth = jcl.infer_min_depth(jg)
    jeng = jad.DeviceCleaner(ju.build_unitig_graph(jg))
    teng = tad.DeviceCleaner(tu.build_unitig_graph(tg))
    assert teng.vc == jeng.vc
    jrec, trec = [], []

    removed = 0
    for (step, jstep), (_, tstep) in zip(
            engine_steps(jeng, k, min_depth, jrec),
            engine_steps(teng, k, min_depth, trec)):
        n_j, n_t = jstep(), tstep()
        assert n_t == n_j, step
        removed += n_j[0] if isinstance(n_j, tuple) else n_j
        assert _at_float32(trec) == _at_float32(jrec), step
        _assert_graphs_equal(teng.to_host(), jeng.to_host(), step)
    assert removed > 0 or name in CLEAN


def _at_float32(recs):
    """Bubble records with their depths rounded to float32, the
    precision of megahit_tpu's device engine."""
    return [(seq, np.float32(depth)) for seq, depth in recs]


def _snp_bubble(a_counts, c_counts):
    """A graph of one SNP bubble at k1 = 22: 60-base flanks at
    multiplicity 50, the 22 edges of allele A at `a_counts` and those
    of allele C at `c_counts`."""
    rng = np.random.default_rng(3)
    left = rng.integers(0, 4, 60).astype(np.uint8)
    right = rng.integers(0, 4, 60).astype(np.uint8)
    seqs = [np.concatenate([left, [b], right]).astype(np.uint8)
            for b in (0, 1)]

    def edges(seq_list):
        flat, starts = tpk.pack_many(seq_list)
        keys, _ = tcount(flat, starts, 22, 1, device="cpu")
        return keys

    keys = edges(seqs)
    row = np.dtype((np.void, 4 * keys.shape[1]))
    void = np.ascontiguousarray(keys).view(row).ravel()
    in_a = np.isin(void, np.ascontiguousarray(edges(seqs[:1])).view(
        row).ravel())
    in_c = np.isin(void, np.ascontiguousarray(edges(seqs[1:])).view(
        row).ravel())
    counts = np.full(len(keys), 50, np.int32)
    for only, branch in ((in_a & ~in_c, a_counts), (in_c & ~in_a,
                                                     c_counts)):
        assert only.sum() == len(branch) == 22
        counts[only] = branch
    return keys, counts


@pytest.mark.parametrize("branch", ["tie_at_float32", "inexact_depth"])
def test_careful_bubble_records_match_host_engine(branch):
    """Allele C at depth 23/22 against allele A at 115/22: in float32
    the careful test ties (1.0454545 >= 0.2 x 5.2272725 = 1.0454545), in
    float64 it fails (1.0454545454545454 < 1.0454545454545456), so the
    host engine records nothing. At depths 30 and 133/22 both record
    C, and its depth must be the host engine's float64 value."""
    if branch == "tie_at_float32":
        keys, counts = _snp_bubble([10] + [5] * 21, [2] + [1] * 21)
    else:
        keys, counts = _snp_bubble([30] * 22, [7] + [6] * 21)
    recs = []
    for run in ("host", "device"):
        g = tu.build_unitig_graph(sdbg_from_edges(keys, counts, 22,
                                                  device="cpu"))
        rec = []
        if run == "host":
            g, n = tcl.pop_bubbles(g, 23, True, careful_threshold=0.2,
                                   bubble_records=rec)
        else:
            n = tad.DeviceCleaner(g).pop_bubbles(
                23, True, careful_threshold=0.2, bubble_records=rec)
        assert n == 1
        recs.append(rec)
    assert recs[1] == recs[0]
    assert len(recs[0]) == (0 if branch == "tie_at_float32" else 3)


def _port_assemble(factory, opt, caplog):
    with caplog.at_level(logging.INFO, logger="megahit_tpu_torch"):
        caplog.clear()
        res = tasm.assemble(_port_sdbg(factory()),
                            tasm.AssembleOptions(**opt))
        engine = "device" if "cleaning on device" in caplog.text else "host"
    return res, engine


@pytest.mark.parametrize("reference", ["jax_device_engine",
                                       "port_host_engine"])
def test_assemble_matches(case, reference, monkeypatch, caplog):
    """assemble() with the port's device engine gives the records of
    megahit_tpu's device engine and of the port's host engine."""
    _, factory, opt = case
    if reference == "jax_device_engine":
        monkeypatch.setenv("MEGAHIT_TPU_DEVICE_CLEAN", "1")
        want = jasm.assemble(factory(), jasm.AssembleOptions(**opt))
    else:
        want, engine = _port_assemble(factory, opt, caplog)
        assert engine == "host"
    monkeypatch.setattr(devices, "graph_on_card", lambda device: True)
    got, engine = _port_assemble(factory, opt, caplog)
    assert engine == "device"
    assert records(got) == records(want)
    assert got.stats == want.stats


def test_depth_guard_falls_back_to_host(case, device_engine, monkeypatch,
                                        caplog):
    """Valid multiplicities summing to 2^31 or more could overflow the
    engine's int32 depths: assemble() cleans on the host engine, with a
    warning, and gives the host engine's records."""
    _, factory, opt = case
    j = factory()
    mult = np.where(j.valid, np.int32(1 << 20), np.int32(0))
    assert int(mult.sum(dtype=np.int64)) >= 2 ** 31

    def big():
        return convert.sdbg(j.k, np.asarray(j.keys), mult,
                            np.array(j.valid), real=j.real, device="cpu")

    def no_device(g):
        raise AssertionError("the device engine must not run")

    monkeypatch.setattr(tad, "DeviceCleaner", no_device)
    with caplog.at_level(logging.INFO, logger="megahit_tpu_torch"):
        got = tasm.assemble(big(), tasm.AssembleOptions(**opt))
    assert "falling back to host cleaning" in caplog.text
    assert "cleaning on device" not in caplog.text
    monkeypatch.setattr(devices, "graph_on_card", lambda device: False)
    want = tasm.assemble(big(), tasm.AssembleOptions(**opt))
    assert records(got) == records(want)
