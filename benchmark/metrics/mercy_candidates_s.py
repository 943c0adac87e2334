"""mercy_candidates_s: mean seconds a job spends in the span(s) `first_graph.mercy.candidates`."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "first_graph.mercy.candidates")
