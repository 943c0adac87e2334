"""unitig_build_s: mean seconds a job spends in the span(s) `assemble.k*.clean_output.unitig_build`."""

from metrics.spans import mean_span


def read(run):
    return mean_span(run, "assemble.k*.clean_output.unitig_build")
