"""The metrics that read the spans and counters inside mercy and
cleaning, on the CPU at the harness tests' SMALL size."""

from types import SimpleNamespace

import harness
from test_bench_harness import run, small_cell


def test_traced_run_reads_mercy_lookups():
    cell = small_cell()
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    cell.per_layer = [m for m in bench["per_layer"] if m["source"] in
                      ("program_span", "program_counter")]
    r = run(cell, trace=True)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["mercy_lookups_m"] > 0
    children = ("mercy_table_s", "mercy_candidates_s", "mercy_flag_scan_s",
                "mercy_emit_s")
    assert sum(m[c] for c in children) <= m["mercy_s"]
    cleaning = ("sdbg_tips_s", "unitig_build_s", "cleaning_rounds_s",
                "prune_output_s")
    assert sum(m[c] for c in cleaning) <= m["assemble_s"]
    assert r["correct"]


def test_lookups_read_nothing_without_counters():
    """A program whose run() returns a plain mapping of seconds (no
    counters) reads no mercy_lookups_m, and raises nothing."""
    read = harness.load_reader("mercy_lookups_m")
    assert read(SimpleNamespace(jobs=[{"spans": {"job": 1.0}}])) is None
