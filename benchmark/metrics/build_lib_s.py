"""build_lib_s: mean seconds a job spends in the span(s) `stage_build_lib`."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "stage_build_lib")
