"""spill_gib: mean GiB a job spills to the prefix buckets, the counter
`spill_bytes` of the span `first_graph.1pass_build.spill`. 0 where no
job ran the 1-pass build (metrics/onepass.py); None where none carries
the counter, as with a program that keeps no counters."""

from metrics.onepass import BUILD, other_route


def read(run):
    per_job, seen = [], False
    for job in run.jobs:
        counters = getattr(job["spans"], "counters", None) or {}
        n = counters.get(BUILD + ".spill", {}).get("spill_bytes")
        seen |= n is not None
        per_job.append(n or 0)
    if not seen:
        return 0.0 if other_route(run) else None
    return sum(per_job) / len(per_job) / 2 ** 30
