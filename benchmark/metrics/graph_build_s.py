"""graph_build_s: mean seconds a job spends in the span(s) `assemble.k*.graph_build`."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "assemble.k*.graph_build")
