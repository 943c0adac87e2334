"""Per-job means of the program's spans (the seconds `Pipeline.run()`
returns for each named stage and sub-stage)."""

from __future__ import annotations

from fnmatch import fnmatchcase


def mean_span(run, pattern: str) -> float | None:
    """Mean over the window's jobs of the seconds of the spans whose
    names match `pattern` (summed within a job); None where no job has
    such a span."""
    per_job, seen = [], False
    for job in run.jobs:
        hits = [dt for name, dt in job["spans"].items()
                if fnmatchcase(name, pattern)]
        seen |= bool(hits)
        per_job.append(sum(hits))
    return sum(per_job) / len(per_job) if seen else None
