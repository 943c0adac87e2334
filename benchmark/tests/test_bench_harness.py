"""The harness's run on the CPU at a small size: a sound run comes out
correct, and a run with the timed path broken underneath comes out not
correct, once for each fault a cell can have. The look for a card is
run.py's and is skipped here."""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

import check
import control
import harness

# a sample on which bubbles of errors show at k = 21 past the limit
# (genomes at 6 to 14x, one at 10x or more for the recall) in seconds a
# job
SMALL = dict(genomes=3, min_bp=200000, max_bp=250000, min_cov=6.0,
             max_cov=14.0)
# the first graph at min_count 1 (the 1-pass route, no mercy); its
# singleton branches are not held to uncleaned_ends, whose readings are
# those of min_count 2
MIN_COUNT_1 = {"flags": ["--min-count", "1"],
               "reference": {"k_min": 21, "min_count": 1, "mercy": False}}


def small_cell(flags=(), route=None):
    """default.k21 at the SMALL size, with `flags` added to the job's
    and the configuration's keys in `route` replaced."""
    cfg = harness.load_json(f"{harness.HERE}/configs/megahit-default.json")
    cfg.update(SMALL, shape_seed=None, **(route or {}))
    traffic = harness.load_json(f"{harness.HERE}/traffic/k21.json")
    traffic.update(genome_scale=1, flags=traffic["flags"] + list(flags))
    if route is MIN_COUNT_1:
        del traffic["checks"]["uncleaned_ends"]
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    return SimpleNamespace(
        name="small", chips=1, config=cfg, traffic=traffic,
        end_to_end=bench["end_to_end"],
        per_layer=[m for m in bench["per_layer"]
                   if m["source"] == "program_span"])


def run(cell, seed=5, trace=False):
    return harness.run_cell(cell, seed, 0.01, trace, "cpu",
                            time.monotonic())


@pytest.mark.parametrize("route", [None, MIN_COUNT_1],
                         ids=["count", "1pass"])
def test_sound_run_is_correct(route):
    cell = small_cell(route=route)
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"read_bases_per_s", "peak_device_gib",
                                 "setup_s"}
    assert set(r["checks"]) == {"jobs_failed"} | set(cell.traffic["checks"])


@pytest.mark.parametrize("fault", sorted(set(control.FLAG_FAULTS)
                                         - control.UNCAUGHT))
def test_a_cleaning_step_left_out(fault):
    """The program run with its own option that skips a step of
    cleaning: contigs end at the bubbles it leaves."""
    r = run(small_cell(control.FLAG_FAULTS[fault]))
    assert not r["correct"]
    c = r["checks"]["uncleaned_ends"]
    assert c["value"] > c["limit"]


def test_control_and_faults_read_not_correct():
    """control.py's readings at the SMALL size: the sound job correct,
    the control and every fault that the cell catches not."""
    cell = small_cell()
    with tempfile.TemporaryDirectory() as work:
        got = control.readings(cell, 5, "cpu", work)
    assert set(got) == {"sound", "control", "half_reads"} | set(
        control.FLAG_FAULTS) | set(control.ANSWER_FAULTS)
    for what, checks in got.items():
        if what not in control.UNCAUGHT:
            assert check.passed(checks) == (what == "sound"), (what, checks)


def test_traced_run_reads_spans():
    cell = small_cell()
    r = run(cell, trace=True)
    m = r["metrics"]
    assert m["count_s"]["value"] > 0 and m["mercy_s"]["value"] > 0
    assert set(m) == {x["name"] for x in cell.per_layer}
    assert r["correct"]


def test_half_the_reads_left_out(monkeypatch):
    """The program sees only the first half of each read file."""
    from megahit_tpu_torch.pipeline import driver

    orig = driver.build_lib

    def half(pe1, pe2, pe12, se):
        cut = []
        for p in pe1 + pe2:
            lines = open(p).read().splitlines(True)
            q = p + ".half"
            open(q, "w").writelines(lines[: len(lines) // 4 * 2])
            cut.append(q)
        n = len(pe1)
        return orig(cut[:n], cut[n:], pe12, se)

    monkeypatch.setattr(driver, "build_lib", half)
    r = run(small_cell())
    assert not r["correct"]
    assert r["checks"]["graph_edges_differ"]["value"] > 0


def test_a_base_altered_where_contigs_are_written(monkeypatch):
    """One base in the middle of the longest contig is changed as the
    final contigs are written."""
    from megahit_tpu_torch.pipeline import driver

    orig = driver.write_contigs

    def altered(path, contigs):
        if path.endswith("final.contigs.fa") and "intermediate" not in path:
            contigs = copy.deepcopy(contigs)
            c = max(contigs, key=lambda c: c.length)
            c.codes[c.length // 2] = (c.codes[c.length // 2] + 1) % 4
        return orig(path, contigs)

    monkeypatch.setattr(driver, "write_contigs", altered)
    r = run(small_cell())
    assert not r["correct"]
    assert r["checks"]["edges_foreign"]["value"] >= 22
    assert r["checks"]["depths_differ"]["value"] >= 1


def test_half_the_contigs_left_out(monkeypatch):
    from megahit_tpu_torch.pipeline import driver

    orig = driver.write_contigs

    def dropped(path, contigs):
        if path.endswith("final.contigs.fa") and "intermediate" not in path:
            contigs = sorted(contigs, key=lambda c: -c.length)[1::2]
        return orig(path, contigs)

    monkeypatch.setattr(driver, "write_contigs", dropped)
    r = run(small_cell())
    assert not r["correct"]
    assert r["checks"]["recall_gap"]["value"] > r["checks"]["recall_gap"][
        "limit"]


def test_a_job_that_returns_its_state_unchanged(monkeypatch):
    """Pipeline.run returns at once, doing nothing."""
    from megahit_tpu_torch.pipeline import driver

    monkeypatch.setattr(driver.Pipeline, "run", lambda self: {})
    with pytest.raises(RuntimeError):
        run(small_cell())  # the warm job of set-up fails the run


def test_no_jax_after_a_run(tmp_path):
    """A whole run in a fresh interpreter leaves no jax, jaxlib, flax or
    megahit_tpu module loaded (top-level names compared whole)."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{harness.HERE!r}, {harness.ROOT!r}, "
        f"{os.path.dirname(__file__)!r}]\n"
        "import harness, test_bench_harness as t\n"
        "r = t.run(t.small_cell())\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(), "
        "'megahit_tpu_torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == [] and port


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "megahit_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
    assert np.array([0]).size == 1
