"""local_s: mean seconds a job spends in local assembly (the span
`stage_local`, one a rung but the last, summed within a job)."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "stage_local")
