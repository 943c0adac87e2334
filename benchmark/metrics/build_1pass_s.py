"""build_1pass_s: mean seconds a job spends in the 1-pass k_min build,
the span `first_graph.1pass_build` (spill, rounds and the graph)."""

from metrics.onepass import build_span


def read(run):
    return build_span(run)
