"""The cell kmin-1pass.k21 (MEGAHIT's --kmin-1pass: the out-of-core k_min
build and mercy's dense scan) through the harness on the CPU at the
harness tests' SMALL size: a sound run comes out correct, a round's
edges left out come out not correct, and a traced run reads every
metric of the 1-pass build."""

from types import SimpleNamespace

import pytest

import harness
from megahit_tpu_torch.graph import bucketed
from test_bench_harness import SMALL, run
from traffic import community

CELL = "kmin-1pass.k21"
# the metrics this configuration adds (BENCHMARK.json, layer
# "out-of-core build")
BUILD_METRICS = ("build_1pass_s", "spill_s", "spill_extract_s",
                 "spill_write_wait_s", "round_read_wait_s", "round_sort_s",
                 "round_dedup_s", "spill_gib")


def small_cell(per_layer_sources=()):
    """kmin-1pass.k21 at the SMALL size, reporting its per-layer metrics
    of the given sources."""
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    cell = harness.load_cell(CELL, bench)
    cell.config.update(SMALL, shape_seed=None)
    cell.traffic.update(genome_scale=1)
    cell.per_layer = [m for m in cell.per_layer
                      if m["source"] in per_layer_sources]
    return cell


def test_config_is_the_1pass_route():
    cell = small_cell()
    assert cell.config["flags"] == ["--kmin-1pass"]
    default = harness.load_json(
        f"{harness.HERE}/configs/megahit-default.json")
    assert cell.config["reference"] == default["reference"]
    assert cell.config["control"] == default["control"]


def test_sound_run_is_correct():
    cell = small_cell()
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert set(r["checks"]) == {"jobs_failed"} | set(cell.traffic["checks"])
    for name in ("graph_edges_differ", "jobs_differ", "edges_foreign",
                 "depths_differ"):
        assert r["checks"][name]["value"] == 0, name


def test_a_round_left_out(monkeypatch):
    """The rounds are cut to 2^20 rows, and the round that holds bucket
    128 returns no edges."""
    monkeypatch.setenv("MEGAHIT_TPU_TORCH_ROUND_CAP_ROWS", str(1 << 20))
    orig = bucketed._round_edges
    dropped = []

    def drop(srows, w, *args):
        edges, mult = orig(srows, w, *args)
        first, last = srows[0, 0] >> 24, srows[-1, 0] >> 24
        if first <= 128 <= last:
            dropped.append(len(edges))
            return edges[:0], mult[:0]
        return edges, mult

    monkeypatch.setattr(bucketed, "_round_edges", drop)
    r = run(small_cell())
    assert dropped and min(dropped) > 0
    assert not r["correct"]
    assert r["checks"]["graph_edges_differ"]["value"] > 0


def test_traced_run_reads_the_build():
    cell = small_cell(("program_span", "program_counter"))
    assert set(BUILD_METRICS) <= {m["name"] for m in cell.per_layer}
    r = run(cell, trace=True)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == {x["name"] for x in cell.per_layer}
    for name in BUILD_METRICS:
        assert isinstance(m[name], float) and m[name] > 0, name
    assert m["spill_extract_s"] + m["spill_write_wait_s"] <= m["spill_s"]
    assert (m["spill_s"] + m["round_read_wait_s"] + m["round_sort_s"]
            + m["round_dedup_s"]) <= m["build_1pass_s"]
    # every window of every read spilled on both strands, 2 words a row
    # at k1 = 22; the dense scan looks up every base of the pool
    reads = community.simulate(
        5, **harness.sample_args(cell.config, cell.traffic))["r1"]
    n, length = 2 * reads.shape[0], reads.shape[1]
    assert m["spill_gib"] * 2 ** 30 == 2 * n * (length - 21) * 8
    assert m["mercy_lookups_m"] * 1e6 == pytest.approx(n * length)


class _Spans(dict):
    """A job's spans with (empty) counters, as `Pipeline.run()` returns."""
    counters: dict = {}


def test_readers_on_other_routes():
    """A job of another route reads 0 (nothing spent in the build); a
    1-pass job of a program without a span or counter reads None."""
    other = SimpleNamespace(jobs=[{"spans": _Spans({"job": 1.0})}])
    onepass = SimpleNamespace(jobs=[{"spans": _Spans(
        {"job": 2.0, "first_graph.1pass_build": 1.0,
         "first_graph.1pass_build.spill": 0.5})}])
    for name in BUILD_METRICS:
        read = harness.load_reader(name)
        assert read(other) == 0.0, name
        if name not in ("build_1pass_s", "spill_s"):
            assert read(onepass) is None, name
    assert harness.load_reader("spill_s")(onepass) == 0.5
    plain = SimpleNamespace(jobs=[{"spans": {
        "job": 2.0, "first_graph.1pass_build": 1.0}}])
    assert harness.load_reader("spill_gib")(plain) is None
    for name in BUILD_METRICS:
        assert harness.load_reader(name)(SimpleNamespace(jobs=[])) is None

