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

import numpy as np

import judge
from reference import first_graph as ref

HERE = os.path.dirname(os.path.abspath(__file__))


def digest(graph_path: str, contigs_path: str) -> str:
    h = hashlib.sha256()
    with np.load(graph_path) as z:
        for name in sorted(z.files):
            h.update(name.encode())
            h.update(np.ascontiguousarray(z[name]).tobytes())
    with open(contigs_path, "rb") as fh:
        h.update(fh.read())
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
    read edge), `digests` of every job and `pick`, the judged one."""

    def __init__(self, sample, config, jobs, pick, reference=None):
        self.sample, self.config, self.jobs, self.pick = \
            sample, config, jobs, pick
        self.k1 = config["reference"]["k_min"] + 1
        self.job = jobs[pick]
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
