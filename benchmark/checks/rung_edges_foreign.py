"""rung_edges_foreign: (k+1)-mers of the judged job's contigs,
final contigs and additional contigs of every rung that are not edges
of the reference's graph of that rung (the k_min graph at k_min; past
it, the union of the job's files of the rung before and the reference's
iterate edges)."""

import numpy as np

FILES = ("contigs", "final.contigs", "addi")


def read(job):
    return sum(int(np.count_nonzero(job.rung_edges(k, name)[1] < 0))
               for k, rung in job.ladder.items() if rung.graph is not None
               for name in FILES)
