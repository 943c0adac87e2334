"""spill_write_wait_s: mean seconds a job's main thread waits on the
spill's writer thread, the spans `first_graph.1pass_build.spill.write_wait`."""

from metrics.onepass import build_span


def read(run):
    return build_span(run, ".spill.write_wait")
