"""spill_extract_s: mean seconds a job spends extracting its chunks
(on the device, the download, reverse complements and row fill), the
spans `first_graph.1pass_build.spill.extract`, one a chunk."""

from metrics.onepass import build_span


def read(run):
    return build_span(run, ".spill.extract")
