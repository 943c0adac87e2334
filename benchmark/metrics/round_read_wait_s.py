"""round_read_wait_s: mean seconds a job waits for the prefetched spill
reads of its rounds, the spans `first_graph.1pass_build.round.read_wait`
summed over rounds."""

from metrics.onepass import build_span


def read(run):
    return build_span(run, ".round.read_wait")
