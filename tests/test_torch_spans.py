"""The port's span recorder (megahit_tpu_torch/utils/timers.py): spans
nest under their parents with one job id, counters sum, nothing is
recorded without a recorder or on a worker thread, spans share the
wall clock with torch.profiler's events, and a CPU run of the pipeline
returns the spans and counters inside mercy and cleaning, whose
children cover their parents, and inside the 1-pass build's spill and
rounds, whose children lie within theirs."""

import logging
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_test_env  # noqa: F401
from megahit_tpu_torch.__main__ import make_parser, options_from_args
from megahit_tpu_torch.core import packing
from megahit_tpu_torch.graph import bucketed, counter, mercy
from megahit_tpu_torch.pipeline.driver import Pipeline
from megahit_tpu_torch.utils.log import get_logger, setup_logging
from megahit_tpu_torch.utils.timers import PhaseTimer, count, span

ROOT = pathlib.Path(__file__).resolve().parents[1]

MERCY = "first_graph.mercy"
CLEAN = "assemble.k21.clean_output"
# the spans of a --k-list 21 job that the benchmark's metrics read
SPANS = ("job", "first_graph.count", "assemble.k21.graph_build",
         f"{MERCY}.node_table", f"{MERCY}.candidates", f"{MERCY}.flag_scan",
         f"{MERCY}.emit", f"{CLEAN}.sdbg_tips", f"{CLEAN}.unitig_build",
         f"{CLEAN}.cleaning_rounds", f"{CLEAN}.prune_output")
CHILDREN = {
    MERCY: ("node_table", "candidates", "flag_scan", "emit"),
    CLEAN: ("sdbg_tips", "unitig_build", "cleaning_rounds", "prune_output"),
}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def logged():
    """The port's logger at DEBUG, its records kept."""
    log = get_logger()
    level, handlers = log.level, list(log.handlers)
    h = _Records()
    log.handlers[:] = [h]
    log.setLevel(logging.DEBUG)
    try:
        yield h.records
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)


def test_spans_nest_and_counters_sum(logged):
    t = PhaseTimer()
    with t.phase("job"):
        with t.phase("stage"):
            with span("a") as a:
                count("n", 2)
                count("n", 3)
                with span("b"):
                    count("m", 1)
            with span("a"):
                count("n", 5)
    names = [r.name for r in t.records]
    assert names == ["stage.a.b", "stage.a", "stage.a", "stage", "job"]
    by = {r.name: r for r in t.records}
    assert by["stage.a.b"].parent == "stage.a"
    assert by["stage.a"].parent == "stage" and by["stage"].parent == "job"
    assert by["job"].parent is None
    assert {r.job for r in t.records} == {t.job}
    for r in t.records:
        if r.parent is not None:
            up = [p for p in t.records if p.name == r.parent
                  and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns]
            assert up, r.name
    assert a.counters == {"n": 5}
    spans = t.spans()
    assert spans.counters == {"stage.a": {"n": 10}, "stage.a.b": {"m": 1}}
    assert spans["stage.a"] == pytest.approx(
        sum(r.seconds for r in t.records if r.name == "stage.a"))
    assert spans.records is t.records
    phase = [r for r in logged if r.msg == "phase %s: %.3fs"]
    assert [r.args[0] for r in phase] == names
    for r, rec in zip(phase, t.records):
        assert r.levelno == logging.DEBUG and len(r.args) == 2
        assert r.args[1] == rec.seconds
        assert (r.start_ns, r.end_ns, r.parent, r.job) == (
            rec.start_ns, rec.end_ns, rec.parent, t.job)


def test_nothing_recorded_without_a_recorder(logged):
    with span("alone") as s:
        count("n", 1)
        time.sleep(0.001)
    assert s.seconds > 0 and s.counters == {} and s.parent is None
    assert logged == []


def test_nothing_recorded_on_a_worker_thread():
    def work(i):
        with span("w"):
            count("n", i)

    t = PhaseTimer()
    with t.phase("job"):
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(work, range(4)))
    assert [r.name for r in t.records] == ["job"]
    assert t.spans().counters == {}


def test_a_failed_span_leaves_no_record():
    t = PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("job"):
            with span("bad"):
                raise ValueError
    assert t.records == []
    with span("after"):
        count("n", 1)
    assert t.records == []


def test_spans_share_the_profilers_clock():
    """A torch op run inside a span under torch.profiler (CPU activity)
    has its event inside the span's [start_ns, end_ns]."""
    from torch.profiler import ProfilerActivity, profile

    t = PhaseTimer()
    x = torch.randn(1 << 18)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.01)
        with t.phase("op") as rec:
            (x * 2).sum()
        time.sleep(0.01)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() in ("aten::mul", "aten::sum")]
    assert ev
    for e in ev:
        assert rec.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= rec.end_ns


def _mercy_reads():
    """Two islands of tiled reads bridged by one long read: gaps at
    k1 = 22."""
    genome = np.random.default_rng(11).integers(0, 4, 800).astype(np.uint8)
    reads = [genome[s:s + 60].copy()
             for s in list(range(0, 240, 3)) + list(range(450, 740, 3))]
    reads.append(genome[260:480].copy())
    return packing.pack_many(reads)


@pytest.mark.parametrize("k1,rare,kids", [
    (22, "all", ("candidates", "node_table", "flag_scan", "emit")),
    (22, "none", ("candidates",)),
    (22, None, ("node_table", "flag_scan", "emit")),
    (42, None, ("node_table", "flag_scan", "emit")),
])
def test_mercy_spans_by_path(k1, rare, kids):
    """The children of mercy's span on each path, each one interval in
    order; no node table is built where no read is a candidate. The
    dense scan looks up every position of the pool."""
    flat, starts = _mercy_reads()
    keys, _, rare_keys = counter.count_canonical_kmers(
        flat, starts, k1, 2, return_rare=True, device="cpu")
    if rare == "none":
        rare_keys = rare_keys[:0]
    t = PhaseTimer()
    with t.phase("m"):
        edges = mercy.find_mercy_edges(
            flat, starts, keys, k1, rare_keys=rare_keys if rare else None,
            device="cpu")
    assert [r.name for r in t.records] == [f"m.{c}" for c in kids] + ["m"]
    assert all(a.end_ns <= b.start_ns
               for a, b in zip(t.records, t.records[1:-1]))
    assert (len(edges) > 0) == (rare != "none" and k1 == 22)
    lookups = t.spans().counters.get("m.flag_scan", {}).get("lookups", 0)
    if rare is None:
        assert lookups == int(starts[-1])
    elif rare == "all":
        assert 0 < lookups < int(starts[-1])


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    d = tmp_path_factory.mktemp("community")
    subprocess.run([sys.executable, str(ROOT / "scripts/make_community.py"),
                    str(d), "--genomes", "4", "--min-bp", "20000",
                    "--max-bp", "60000", "--min-cov", "3", "--max-cov", "30",
                    "--seed", "42"], check=True, capture_output=True,
                   timeout=120)
    return ["-1", str(d / "reads_1.fa"), "-2", str(d / "reads_2.fa")]


def _run(args, out):
    """Pipeline.run() as the CLI would run it, with the port's DEBUG log
    records kept: (spans, records)."""
    opt = options_from_args(make_parser().parse_args(
        args + ["--device", "cpu", "-t", "2", "-o", str(out)]))
    opt.validate()
    out.mkdir()
    setup_logging(str(out / "log"))
    h = _Records()
    get_logger().addHandler(h)
    try:
        spans = Pipeline(opt).run()
    finally:
        for x in list(get_logger().handlers):
            get_logger().removeHandler(x)
            x.close()
    return spans, h.records


@pytest.fixture(scope="module")
def k21_job(community, tmp_path_factory):
    return _run(community + ["--k-list", "21"],
                tmp_path_factory.mktemp("k21") / "out")


def test_every_returned_span_was_logged(k21_job):
    spans, records = k21_job
    logged = {r.args[0] for r in records
              if r.msg == "phase %s: %.3fs" and len(r.args) == 2}
    assert set(spans) <= logged
    assert {"job", "stage_build_lib", "stage_first_graph",
            "stage_assemble", "stage_merge_final"} <= set(spans)


def test_k21_job_spans_and_counters(k21_job):
    spans, _ = k21_job
    assert set(SPANS) <= set(spans)
    # the one counter of the in-core route: what mercy_lookups_m reads
    assert list(spans.counters) == [f"{MERCY}.flag_scan"]
    assert list(spans.counters[f"{MERCY}.flag_scan"]) == ["lookups"]
    assert spans.counters[f"{MERCY}.flag_scan"]["lookups"] > 0
    job = [r for r in spans.records if r.name == "job"]
    assert len(job) == 1 and job[0] is spans.records[-1]
    for r in spans.records:
        assert r.job == job[0].job
        if r.name != "job":
            up = [p for p in spans.records if p.name == r.parent
                  and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns]
            assert up, r.name


@pytest.mark.parametrize("parent", list(CHILDREN))
def test_children_cover_their_parent(k21_job, parent):
    """The children of mercy and of clean_output are one interval each
    and together cover at least 90% of their parent."""
    spans, _ = k21_job
    kids = [f"{parent}.{c}" for c in CHILDREN[parent]]
    assert all(sum(r.name == c for r in spans.records) == 1 for c in kids)
    covered = sum(spans[c] for c in kids)
    assert 0.9 * spans[parent] <= covered <= spans[parent]


def test_out_of_core_rounds_are_spans(community, tmp_path):
    """The 1-pass build's spill and rounds: spans under the build's span
    with rows and bytes, every spilled row read back in one round."""
    spans, records = _run(community + ["--k-list", "21", "--kmin-1pass",
                                       "-m", "12000000"], tmp_path / "out")
    build = "first_graph.1pass_build"
    rounds = [r for r in spans.records if r.name == f"{build}.round"]
    sorts = [r for r in spans.records if r.name == f"{build}.round.sort"]
    assert len(rounds) >= 8 and len(sorts) == len(rounds)
    spill = spans.counters[f"{build}.spill"]
    read = spans.counters[f"{build}.round"]
    assert spill["rows"] == read["rows"] > 0
    assert spill["spill_bytes"] == read["spill_bytes"] > 0
    assert sum(r.counters["rows"] for r in rounds) == read["rows"]
    lines = [r.getMessage() for r in records
             if r.getMessage().startswith("bucketed round ")]
    assert len(lines) == len(rounds)
    assert f"{MERCY}.flag_scan" in spans  # the dense path, no candidates
    assert f"{MERCY}.candidates" not in spans


def test_spill_and_round_children(community, tmp_path, monkeypatch):
    """The children of the 1-pass build's spill (one `extract` a chunk,
    `write_wait`) and of each round (one `read_wait` and one `dedup`
    beside its `sort`): each under its parent, inside its parent's
    interval, and together no longer than it."""
    chunks = []
    orig = bucketed._chunks

    def spy(*args):
        for chunk in orig(*args):
            chunks.append(chunk[0])
            yield chunk

    monkeypatch.setattr(bucketed, "_chunks", spy)
    spans, _ = _run(community + ["--k-list", "21", "--kmin-1pass",
                                 "-m", "12000000"], tmp_path / "out")
    build = "first_graph.1pass_build"

    def kids_of(parent, names):
        """parent's records' children named `names`, by parent."""
        out = []
        for up in [r for r in spans.records if r.name == parent]:
            kids = [r for r in spans.records
                    if r.parent == parent and r.name in names
                    and up.start_ns <= r.start_ns and r.end_ns <= up.end_ns]
            assert sum(k.seconds for k in kids) <= up.seconds
            assert all(a.end_ns <= b.start_ns
                       for a, b in zip(kids, kids[1:]))
            out.append([k.name.rsplit(".", 1)[1] for k in kids])
        return out

    spill = f"{build}.spill"
    (spill_kids,) = kids_of(spill, {f"{spill}.extract",
                                    f"{spill}.write_wait"})
    assert len(chunks) >= 2
    assert spill_kids.count("extract") == len(chunks)
    assert spill_kids.count("write_wait") == len(chunks)
    rnd = f"{build}.round"
    rounds = kids_of(rnd, {f"{rnd}.{c}" for c in
                           ("read_wait", "sort", "dedup")})
    assert len(rounds) >= 8
    assert all(r == ["read_wait", "sort", "dedup"] for r in rounds)

