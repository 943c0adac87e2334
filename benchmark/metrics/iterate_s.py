"""iterate_s: mean seconds a job spends seeding the next rung's edges
from the reads (the span `stage_iterate`, one a rung but the last,
summed within a job)."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "stage_iterate")
