"""What decides `correct`: the window's jobs judged against the plain
reference (reference/), worked out again from the reads the benchmark
generated.

The numbers compared are those the cell's traffic names under "checks",
each with its limit; a run is correct when every number is at or under
its limit. Besides them, always: jobs_failed, the jobs of the window
that raised or wrote no k_min graph or contigs (limit 0). Each named
number is read by checks/<name>.py from one job, drawn from the seed
(`JobView`).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
from functools import cached_property
from types import SimpleNamespace

import numpy as np

import judge
from reference import first_graph as ref
from reference import ladder

HERE = os.path.dirname(os.path.abspath(__file__))


def _hash_file(h, path: str) -> None:
    """Adds a file to the digest h: an .npz array by array, any other
    file byte for byte."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            for name in sorted(z.files):
                h.update(name.encode())
                h.update(np.ascontiguousarray(z[name]).tobytes())
    else:
        with open(path, "rb") as fh:
            h.update(fh.read())


def digest(graph_path: str, contigs_path: str) -> str:
    h = hashlib.sha256()
    _hash_file(h, graph_path)
    _hash_file(h, contigs_path)
    return h.hexdigest()


def rungs_digest(rungs: dict) -> str:
    """One digest of a job's kept rung files ({K: {name: path}})."""
    h = hashlib.sha256()
    for k, files in rungs.items():
        for name in sorted(files):
            h.update(f"k{k}.{name}".encode())
            _hash_file(h, files[name])
    return h.hexdigest()


def reference_graph(sample: dict, config: dict, min_count=None,
                    mercy=None):
    """The reference's k_min graph of the sample under the
    configuration (or under the given min_count and mercy)."""
    reads = ref.codes(np.concatenate([sample["r1"], sample["r2"]]))
    k1 = config["reference"]["k_min"] + 1
    return ref.first_graph(
        reads, k1,
        config["reference"]["min_count"] if min_count is None else min_count,
        config["reference"]["mercy"] if mercy is None else mercy)


class JobView:
    """One judged job and what the checks read of it: `graph` (the
    program's k_min graph: canonical keys, multiplicities), `contigs`
    (codes) and `multis` (each header's multi as printed), `reference`
    (the reference's k_min graph: keys, multiplicities, every distinct
    read edge), `digests` of every job and `pick`, the judged one.
    Of a ladder: `rungs` (the judged job's kept files, {K: {name:
    path}}), `rung_records` (its contig files parsed, {K: {name:
    [(header, codes)]}}) and `ladder` (the reference's rungs, worked
    out from the reads and each previous rung's contig files)."""

    def __init__(self, sample, config, jobs, pick, reference=None):
        self.sample, self.config, self.jobs, self.pick = \
            sample, config, jobs, pick
        self.k1 = config["reference"]["k_min"] + 1
        self.job = jobs[pick]
        self._rung_edges = {}
        if reference is not None:
            self.__dict__["reference"] = reference

    @cached_property
    def reference(self):
        return reference_graph(self.sample, self.config)

    @cached_property
    def graph(self):
        return judge.load_graph(self.job["graph"], self.k1)

    @cached_property
    def _records(self):
        return judge.read_contigs(self.job["contigs"])

    @property
    def contigs(self):
        return [c for _, c in self._records]

    @property
    def multis(self):
        return [judge.header_multi(h) for h, _ in self._records]

    @cached_property
    def digests(self):
        return [digest(j["graph"], j["contigs"]) for j in self.jobs]

    @cached_property
    def rung_digests(self):
        return [rungs_digest(j["rungs"]) for j in self.jobs]

    @cached_property
    def rungs(self) -> dict:
        return self.job["rungs"]

    @cached_property
    def rung_records(self) -> dict:
        return {k: {name: judge.read_contigs(path)
                    for name, path in files.items() if name != "edges"}
                for k, files in self.rungs.items()}

    @cached_property
    def reads(self) -> ladder.Reads:
        return ladder.Reads(ref.codes(np.concatenate([self.sample["r1"],
                                                      self.sample["r2"]])))

    def rung_edges(self, k: int, name: str):
        """The (k+1)-mers of rung k's contig file `name` against the
        reference's graph of the rung (ladder.contig_edges)."""
        key = k, name
        if key not in self._rung_edges:
            self._rung_edges[key] = ladder.contig_edges(
                [c for _, c in self.rung_records[k].get(name, ())],
                self.ladder[k].graph, k + 1)
        return self._rung_edges[key]

    @cached_property
    def ladder(self) -> dict:
        """{K: the reference's rung K}: `iterate` (its edges: rows,
        counts; None at k_min), `graph` (a RowSet of its canonical
        edges) and `mult` (their multiplicities). A rung's inputs are
        the judged job's files of the rung before it; a rung that
        wrote no contigs (where early termination stopped the ladder)
        has no graph."""
        out, prev = {}, None
        for k, records in self.rung_records.items():
            rung = SimpleNamespace(k1=k + 1, iterate=None, graph=None,
                                   mult=None)
            if prev is None:
                keys, mult, _ = self.reference
                rows = (keys << np.uint64(2 * (ladder.WORD - rung.k1)))
                rung.graph, rung.mult = ladder.RowSet(rows[:, None]), mult
            else:
                kp, files = prev
                rung.iterate = ladder.iterate_edges(
                    self.reads,
                    [(c, judge.header_flag(h))
                     for name in ("contigs", "bubble_seq")
                     for h, c in files.get(name, ())],
                    kp, k - kp)
                if "contigs" in records:
                    keys, rung.mult = ladder.rung_graph(
                        {name: [(c, judge.header_flag(h),
                                 float(judge.header_multi(h)))
                                for h, c in recs]
                         for name, recs in files.items()},
                        rung.iterate, kp, k)
                    rung.graph = ladder.RowSet(keys)
            out[k] = rung
            prev = k, records
        return out


def load_check(name: str):
    path = os.path.join(HERE, "checks", name + ".py")
    spec = importlib.util.spec_from_file_location(f"check_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge_jobs(sample: dict, config: dict, limits: dict, jobs: list[dict],
               n_failed: int, seed: int, reference=None) -> dict:
    """The numbers compared, each {"value", "limit"}. limits: the
    traffic's "checks" ({name: limit}); jobs: the window's finished
    jobs, each {"graph": path, "contigs": path}; reference: the
    reference's k_min graph of the sample, where already worked out."""
    out = {"jobs_failed": {"value": n_failed, "limit": 0}}
    if not jobs:
        out["jobs_failed"]["value"] = max(n_failed, 1)
        return out
    pick = int(np.random.default_rng(seed).integers(len(jobs)))
    view = JobView(sample, config, jobs, pick, reference)
    for name, limit in limits.items():
        out[name] = {"value": load_check(name)(view), "limit": limit}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def control_reading(sample: dict, config: dict, reference=None) -> int:
    """graph_edges_differ of the control: the reference put in the
    program's place with the guarantee the configuration's control
    names broken (config["control"]: its min_count and mercy)."""
    keys, mult, _ = reference or reference_graph(sample, config)
    ck, cm, _ = reference_graph(sample, config, **config["control"])
    return ref.edges_differ(keys, mult, ck, cm)
