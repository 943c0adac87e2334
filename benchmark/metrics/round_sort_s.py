"""round_sort_s: mean seconds a job spends sorting its rounds, the spans
`first_graph.1pass_build.round.sort` summed over rounds."""

from metrics.onepass import build_span


def read(run):
    return build_span(run, ".round.sort")
