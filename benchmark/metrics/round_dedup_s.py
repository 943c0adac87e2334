"""round_dedup_s: mean seconds a job spends deduplicating its sorted rounds
(group counts, palindromes, the min_count filter), the spans
`first_graph.1pass_build.round.dedup` summed over rounds."""

from metrics.onepass import build_span


def read(run):
    return build_span(run, ".round.dedup")
