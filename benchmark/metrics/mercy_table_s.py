"""mercy_table_s: mean seconds a job spends in the span(s) `first_graph.mercy.node_table`."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "first_graph.mercy.node_table")
