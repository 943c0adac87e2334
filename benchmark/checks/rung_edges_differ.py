"""rung_edges_differ: edges of the judged job's edge file of every rung
past k_min that are missing, extra or of another count than those that
the reference's iterate seeds from the reads and the job's files of the
rung before (exact)."""

import numpy as np

import judge
from reference import ladder


def read(job):
    n = 0
    for k, rung in job.ladder.items():
        if rung.iterate is None:
            continue
        path = job.rungs[k].get("edges")
        prog = judge.load_edges(path, rung.k1) if path else (
            np.zeros((0, ladder.n_words(rung.k1)), np.uint64),
            np.zeros(0, np.int64))
        n += ladder.edges_differ(*rung.iterate, *prog)
    return n
