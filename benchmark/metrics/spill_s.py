"""spill_s: mean seconds a job spends spilling the window rows to the
prefix buckets, the span `first_graph.1pass_build.spill`."""

from metrics.onepass import build_span


def read(run):
    return build_span(run, ".spill")
