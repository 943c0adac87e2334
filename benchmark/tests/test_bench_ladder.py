"""The ladder's reference (reference/ladder.py) against the port on the
CPU, and the ladder's checks on a whole run of the harness: a sound
ladder reads 0 on every exact check, and each planted fault reads not
correct."""

import copy
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

import check
import harness
import judge
from reference import ladder

# a sample (0.99 Mbp of reads at seed 5) whose ladder runs all 8 rungs,
# with local contigs at each, in seconds a job
SMALL = dict(genomes=10, min_bp=8000, max_bp=15000, min_cov=3.0,
             max_cov=20.0)
# a sample whose ladder stops early (at k=79 on seed 5)
EARLY = dict(genomes=6, min_bp=15000, max_bp=25000, min_cov=2.0,
             max_cov=10.0)
EXACT = ("graph_edges_differ", "jobs_differ", "rungs_differ",
         "rung_edges_differ", "rung_edges_foreign", "rung_depths_differ",
         "final_merge_differ")


def genome_reads(seed, g_len=20000, n=3000, read_len=150):
    """A random genome and reads of it on both strands with 0.3%
    substitutions."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, g_len).astype(np.uint8)
    starts = rng.integers(0, g_len - read_len, n)
    reads = np.stack([g[s:s + read_len] for s in starts])
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip][:, ::-1]
    err = rng.random(reads.shape) < 0.003
    reads[err] = (reads[err] + 1) % 4
    return rng, g, reads


def tiled_contigs(rng, g, k, step, n_cuts=80):
    """Contigs that tile the genome and overlap by k bases, as a rung's
    unitigs do, some on the other strand, some loops or standalone, a
    few with a gap, and two that share a flank with another."""
    cuts = np.sort(rng.choice(np.arange(k + 2, len(g) - k - 2), n_cuts,
                              replace=False))
    cuts = np.concatenate([[0], cuts, [len(g) - k]])
    contigs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        gap = int(rng.integers(0, 3)) if rng.random() < 0.2 else 0
        c = g[a + gap:b + k].copy()
        if len(c) < k + 1:
            continue
        if rng.random() < 0.5:
            c = 3 - c[::-1]
        contigs.append((c, int(rng.choice([0, 0, 0, 1, 2]))))
    contigs.append((contigs[1][0][:k + 3].copy(), 0))
    other = contigs[2][0][:k + step + 5].copy()
    other[k + 2] = (other[k + 2] + 1) % 4
    contigs.append((other, 0))
    return contigs


@pytest.mark.parametrize("k,step", [(21, 8), (29, 10), (39, 20), (59, 12),
                                    (99, 20), (119, 8), (127, 12), (31, 8),
                                    (33, 10), (21, 10)])
def test_iterate_edges_matches_the_port(k, step):
    """ladder.iterate_edges against graph/iterate.py's flank index and
    scan, edge for edge: (k+1)-mers of one word and of several, and
    (k + step + 1)-mers up to 140 bases."""
    from megahit_tpu_torch.core import packing
    from megahit_tpu_torch.graph import iterate as it

    rng, g, reads = genome_reads(k * 100 + step)
    contigs = tiled_contigs(rng, g, k, step)
    kept = [c for c, flag in contigs if not flag & 3]
    index = it.build_flank_index(kept, [1.0] * len(kept), k, step)
    flat, starts = packing.pack_many(list(reads))
    keys, counts = it.find_next_kmers(flat, starts, index, device="cpu")
    ref_keys, ref_counts = ladder.iterate_edges(ladder.Reads(reads), contigs,
                                                k, step)
    assert len(ref_keys) > 50
    assert ladder.edges_differ(ref_keys, ref_counts,
                               judge.words_to_rows(keys, k + step + 1),
                               counts.astype(np.int64)) == 0


@pytest.mark.parametrize("at,n_edges", [(14, 0), (18, 8)])
def test_iterate_edges_scan_is_greedy(at, n_edges):
    """A read position inside a looked-up flank's matched extension is
    not looked up again. Flank a at 10 marks 10 .. 17 (7 bases of
    extension); a long contig c starting at 14 would mark 14 .. 21, a
    run of 12 that emits 4 edges, but 14 is inside a's jump; from 18 it
    is looked up, and 10 .. 25 emit 8. The port agrees."""
    from megahit_tpu_torch.core import packing
    from megahit_tpu_torch.graph import iterate as it

    k, step = 21, 8
    read = np.random.default_rng(3).integers(0, 4, 150).astype(np.uint8)
    a = read[10:10 + k + step].copy()
    c = read[at:at + k + 1 + 40].copy()
    keys, _ = ladder.iterate_edges(ladder.Reads(read[None, :]),
                                   [(a, 0), (c, 0)], k, step)
    assert len(keys) == n_edges
    index = it.build_flank_index([a, c], [1.0, 1.0], k, step)
    flat, starts = packing.pack_many([read])
    port, _ = it.find_next_kmers(flat, starts, index, device="cpu")
    assert len(port) == n_edges


@pytest.mark.parametrize("k_from,k", [(21, 29), (29, 39), (99, 119),
                                      (119, 141)])
def test_rung_graph_matches_the_union(tmp_path, k_from, k):
    """ladder.rung_graph against the port's union of a rung's inputs
    (Pipeline._build_sdbg_for_k over files it wrote: contigs with
    loops, bubbles, additional and local contigs, an edge file)."""
    from megahit_tpu_torch.io.contig_io import ContigRecord, write_contigs
    from megahit_tpu_torch.pipeline.driver import Pipeline
    from megahit_tpu_torch.pipeline.options import Options

    opt = Options(out_dir=str(tmp_path), k_list=[k_from, k], device="cpu",
                  pe1=["-"], pe2=["-"])
    opt.validate()
    pipe = Pipeline(opt)
    rng, g, reads = genome_reads(k)
    contigs = tiled_contigs(rng, g, k_from, k - k_from)
    records = {name: [] for name in ("contigs", "bubble_seq", "addi",
                                     "local")}
    for i, (c, flag) in enumerate(contigs):
        name = ("contigs", "contigs", "bubble_seq", "addi", "local")[i % 5]
        multi = float(rng.integers(1, 4000)) / 100
        records[name].append(ContigRecord(c, k_from, i, flag, multi))
    records["contigs"].append(ContigRecord(g[:k // 2], k_from, 99, 2, 9.5))
    for name, recs in records.items():
        write_contigs(pipe.contig_prefix(k_from) + f".{name}.fa", recs)
    edges, counts = ladder.iterate_edges(
        ladder.Reads(reads), [(c, f) for c, f in contigs], k_from,
        k - k_from)
    words = np.zeros((len(edges), -(-(k + 1) // 16)), np.uint32)
    for j in range(words.shape[1]):
        words[:, j] = (edges[:, j // 2] >> np.uint64(32 * (1 - j % 2))) \
            & np.uint64(0xFFFFFFFF)
    np.savez(pipe.graph_prefix(k) + ".edges.npz", keys=words,
             counts=np.zeros(len(edges), np.int32))
    sdbg = pipe._build_sdbg_for_k(k)
    rows = judge.words_to_rows(sdbg.keys[sdbg.valid], k + 1)
    prog_keys, prog_mult = ladder.unique_max(
        ladder.canonical(rows, ladder.revcomp_rows(rows, k + 1)),
        sdbg.mult[sdbg.valid])

    files = {name: [(c, judge.header_flag(h), float(judge.header_multi(h)))
                    for h, c in judge.read_contigs(
                        pipe.contig_prefix(k_from) + f".{name}.fa")]
             for name in records}
    keys, mult = ladder.rung_graph(files, (edges, counts), k_from, k)
    assert len(keys) > 1000 and mult.max() > 1
    assert ladder.edges_differ(keys, mult, prog_keys, prog_mult) == 0


def test_rows_compared_whole_where_hashes_collide(monkeypatch):
    """With every row hashed alike, grouping and lookup still compare
    rows whole."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4, (300, 3)).astype(np.uint64)
    vals = rng.integers(0, 100, 300)
    want = {}
    for r, v in zip(map(tuple, rows), vals):
        want[r] = max(want.get(r, -1), int(v))
    monkeypatch.setattr(ladder, "_hash",
                        lambda r: np.zeros(len(r), np.uint64))
    keys, mx = ladder.unique_max(rows, vals)
    assert {tuple(r): int(v) for r, v in zip(keys, mx)} == want
    assert len(keys) == len(want)
    i = ladder.RowSet(keys).find(rows)
    assert (keys[i] == rows).all()
    assert (ladder.RowSet(keys[1:]).find(keys[:1]) == -1).all()


def test_rows_pack_windows_and_strands():
    """pack, window_rows and revcomp_rows agree with each other and
    with the bases, at lengths on both sides of a word."""
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 4, 500).astype(np.uint8)
    for k1 in (16, 22, 32, 33, 64, 65, 142):
        pos = np.arange(0, len(seq) - k1 + 1, 7)
        fwd, rc = ladder.window_rows(seq, k1, pos)
        win = np.stack([seq[p:p + k1] for p in pos])
        assert (fwd == ladder.pack(win)).all()
        assert (rc == ladder.pack(3 - win[:, ::-1])).all()
        assert (ladder.revcomp_rows(fwd, k1) == rc).all()
        assert (ladder.unpack(fwd, k1) == win).all()
        can = ladder.canonical(fwd, rc)
        for f, r, c in zip(win, 3 - win[:, ::-1], ladder.unpack(can, k1)):
            assert list(c) == min(list(f), list(r))


def test_edge_words_read_at_every_length():
    """judge.words_to_rows reads the program's uint32 words as the
    reference's rows."""
    from megahit_tpu_torch.core import packing

    rng = np.random.default_rng(2)
    for k1 in (22, 32, 33, 48, 64, 96, 142):
        c = rng.integers(0, 4, (20, k1)).astype(np.uint8)
        words = np.stack([packing.pack_codes(x) for x in c])
        words = words[:, :-(-k1 // 16)]
        assert (judge.words_to_rows(words, k1) == ladder.pack(c)).all()


# ---------------------------------------------------------------- runs

# the ladder's own per-layer metrics (readers metrics/local_s.py and
# metrics/iterate_s.py), which BENCHMARK.json lists once a ladder cell
# is in it
LADDER_METRICS = [
    {"name": "local_s", "unit": "s", "better": "lower",
     "source": "program_span", "layer": "local assembly",
     "moves": "read_bases_per_s"},
    {"name": "iterate_s", "unit": "s", "better": "lower",
     "source": "program_span", "layer": "iterate",
     "moves": "read_bases_per_s"}]


def ladder_cell():
    """The ladder at the configuration's size: megahit-default under
    the traffic ladder.json, on one chip."""
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    return SimpleNamespace(
        name="ladder", chips=1,
        config=harness.load_json(
            f"{harness.HERE}/configs/megahit-default.json"),
        traffic=harness.load_json(f"{harness.HERE}/traffic/ladder.json"),
        end_to_end=bench["end_to_end"],
        per_layer=LADDER_METRICS + [
            m for m in bench["per_layer"] if m["source"] == "program_span"
            and "default.k21" in m["workloads"]])


def small_ladder(flags=(), size=SMALL):
    """The ladder at a small size, with `flags` added to the job's."""
    cell = ladder_cell()
    cell.config.update(size, shape_seed=None)
    cell.traffic.update(flags=cell.traffic["flags"] + list(flags))
    return cell


def run(cell, seed=5, trace=False):
    return harness.run_cell(cell, seed, 0.01, trace, "cpu",
                            time.monotonic())


def test_sound_ladder_is_exact():
    """A sound ladder keeps all 8 rungs and reads 0 on every exact
    check; the traced run reports local_s and iterate_s."""
    cell = small_ladder()
    r = run(cell, trace=True)
    assert r["correct"], r["checks"]
    assert {n: r["checks"][n]["value"] for n in EXACT} == dict.fromkeys(
        EXACT, 0)
    assert set(r["checks"]) == {"jobs_failed"} | set(cell.traffic["checks"])
    m = r["metrics"]
    assert m["local_s"]["value"] > 0 and m["iterate_s"]["value"] > 0
    assert set(m) == {x["name"] for x in cell.per_layer}


def test_control_and_faults_read_not_correct():
    """control.py's readings of the ladder at the SMALL size: the sound
    job correct; the control, half the reads and the answers altered
    not; the cleaning faults, which no number of the ladder is held
    to, are only read."""
    import control

    cell = small_ladder()
    with tempfile.TemporaryDirectory() as work:
        got = control.readings(cell, 5, "cpu", work)
    skip = control.uncaught(cell.traffic["checks"])
    assert skip == set(control.FLAG_FAULTS)
    for what, checks in got.items():
        if what not in skip:
            assert check.passed(checks) == (what == "sound"), (what, checks)


def test_a_job_keeps_every_rung(tmp_path):
    """run_job keeps each rung's edge file and contig files, in k
    order, and the k_min rung's edges are the job's graph."""
    cell = small_ladder()
    s = harness.community.write_sample(
        str(tmp_path / "s"), 5, **harness.sample_args(cell.config,
                                                      cell.traffic))
    job = harness.run_job(["-t", "2", "-1", s["path1"], "-2", s["path2"]],
                          str(tmp_path / "out"), str(tmp_path / "keep"),
                          harness.SpanLog(), "cpu")
    assert list(job["rungs"]) == [21, 29, 39, 59, 79, 99, 119, 141]
    assert job["rungs"][21]["edges"] == job["graph"]
    for k, files in job["rungs"].items():
        want = {"edges", "contigs", "final.contigs", "addi", "bubble_seq"}
        assert set(files) == want | ({"local"} if k < 141 else set())
    assert not (tmp_path / "out").exists()


def test_a_ladder_that_stops_early():
    """Early termination: the rungs that ran keep their files, the rung
    where the ladder stopped keeps only the edges iterate wrote for it,
    and the run is exact."""
    cell = small_ladder(size=EARLY)
    jobs = []
    orig = harness.run_job

    def keep(*args):
        jobs.append(orig(*args))
        return jobs[-1]

    harness.run_job = keep
    try:
        r = run(cell)
    finally:
        harness.run_job = orig
    rungs = jobs[-1]["rungs"]
    assert list(rungs) == [21, 29, 39, 59, 79, 99]
    assert set(rungs[99]) == {"edges"}
    assert r["correct"], r["checks"]


def test_one_k_jobs_read_as_before(tmp_path):
    """A --k-list 21 job keeps one rung, and its checks read the same
    with the rungs as without them (as run_job returned them before)."""
    cell = harness.load_cell("default.k21")
    cfg = dict(cell.config, **SMALL, shape_seed=None)
    s = harness.community.write_sample(
        str(tmp_path / "s"), 5, **harness.sample_args(cfg, {}))
    job = harness.run_job(
        ["--k-list", "21", "-t", "2", "-1", s["path1"], "-2", s["path2"]],
        str(tmp_path / "out"), str(tmp_path / "keep"), harness.SpanLog(),
        "cpu")
    assert list(job["rungs"]) == [21]
    assert set(job["rungs"][21]) == {"edges", "contigs", "final.contigs",
                                     "addi", "bubble_seq"}
    limits = cell.traffic["checks"]
    before = {k: v for k, v in job.items() if k != "rungs"}
    ref = check.reference_graph(s, cfg)
    assert check.judge_jobs(s, cfg, limits, [job], 0, 5, ref) == \
        check.judge_jobs(s, cfg, limits, [before], 0, 5, ref)


def test_half_of_one_rungs_iterate_edges_dropped(monkeypatch):
    from megahit_tpu_torch.pipeline import driver

    orig = driver.it.find_next_kmers

    def half(flat, starts, index, **kwargs):
        keys, counts = orig(flat, starts, index, **kwargs)
        if index.k == 39:  # the k=59 rung's edges
            keys, counts = keys[::2], counts[::2]
        return keys, counts

    monkeypatch.setattr(driver.it, "find_next_kmers", half)
    r = run(small_ladder())
    assert not r["correct"]
    assert r["checks"]["rung_edges_differ"]["value"] > 0


def test_a_base_altered_in_a_rungs_contigs(monkeypatch):
    """One base in the middle of the longest contig of the k=39 rung's
    contigs.fa is changed as it is written."""
    from megahit_tpu_torch.pipeline import driver

    orig = driver.write_contigs

    def altered(path, contigs):
        if path.endswith("k39.contigs.fa"):
            contigs = copy.deepcopy(contigs)
            c = max(contigs, key=lambda c: c.length)
            c.codes[c.length // 2] = (c.codes[c.length // 2] + 1) % 4
        return orig(path, contigs)

    monkeypatch.setattr(driver, "write_contigs", altered)
    r = run(small_ladder())
    assert not r["correct"]
    assert r["checks"]["rung_edges_foreign"]["value"] >= 40
    assert r["checks"]["rung_depths_differ"]["value"] >= 1


def test_multis_rounded_through_float32(monkeypatch):
    """PR 11's kind of fault: from k=29 on, every contig's depth passes
    through float32 on its way out. It changes a printed multi only
    now and then: at the cell's own size in 4 of 492 and 1 of 360
    contigs past k_min on two seeds of eight (4100000001, 4100000002)
    and in none on the other six, and in none of the SMALL sample's
    328. So it runs at the cell's size on a seed where it shows."""
    from megahit_tpu_torch.pipeline import assemble

    orig = assemble.output_contigs

    def f32(graph, *args, **kwargs):
        out = orig(graph, *args, **kwargs)
        for recs in out:
            for c in recs:
                if c.k >= 29:
                    c.multi = float(np.float32(c.multi))
        return out

    monkeypatch.setattr(assemble, "output_contigs", f32)
    r = run(ladder_cell(), seed=4100000001)
    assert not r["correct"]
    assert r["checks"]["rung_depths_differ"]["value"] > 0


@pytest.mark.parametrize("which", ["a_rungs_final_contigs", "last_rung"])
def test_a_rung_left_out_of_the_merge(monkeypatch, which):
    """The final merge leaves out one rung's final.contigs.fa (with
    --no-local, so that rungs write final contigs: under the cell's
    own settings every rung's final.contigs.fa is empty), or takes the
    rung before the last one's contigs."""
    from megahit_tpu_torch.pipeline import driver

    orig_merge, orig_read = driver.Pipeline.stage_merge_final, \
        driver.read_contigs
    state = {"merging": False, "dropped": None}

    def merge(self, final_k):
        state["merging"], state["dropped"] = True, None
        try:
            if which == "last_rung":
                final_k = self.opt.k_list[self.opt.k_list.index(final_k) - 1]
            return orig_merge(self, final_k)
        finally:
            state["merging"] = False

    def read(path, *args, **kwargs):
        out = orig_read(path, *args, **kwargs)
        if which == "a_rungs_final_contigs" and state["merging"] and out \
                and path.endswith(".final.contigs.fa") \
                and state["dropped"] in (None, path):
            state["dropped"] = path
            return []
        return out

    monkeypatch.setattr(driver.Pipeline, "stage_merge_final", merge)
    monkeypatch.setattr(driver, "read_contigs", read)
    flags = ["--no-local"] if which == "a_rungs_final_contigs" else []
    r = run(small_ladder(flags))
    assert not r["correct"]
    assert r["checks"]["final_merge_differ"]["value"] == 1
    if which == "a_rungs_final_contigs":
        assert state["dropped"] is not None


def test_no_local_ladder_is_exact():
    """The same checks on a ladder without local assembly, whose rungs
    write final contigs: a sound run reads 0."""
    r = run(small_ladder(["--no-local"]))
    assert r["correct"], r["checks"]
