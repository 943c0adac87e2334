"""mercy_lookups_m: mean node-flag lookups a job makes in mercy's flag
scan (the `lookups` counter of the span `first_graph.mercy.flag_scan`,
from the spans' `counters`), in millions. None where no job carries
the counter, as with a program that keeps no counters."""


def read(run):
    per_job, seen = [], False
    for job in run.jobs:
        counters = getattr(job["spans"], "counters", None) or {}
        n = counters.get("first_graph.mercy.flag_scan", {}).get("lookups")
        seen |= n is not None
        per_job.append(n or 0)
    return sum(per_job) / len(per_job) / 1e6 if seen else None
