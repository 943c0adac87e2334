"""Per-job means of the 1-pass k_min build's spans: the span
`first_graph.1pass_build` and the spans under it, never the out-of-core
spans of a later rung (`assemble.k<K>.graph_build.spill`).

A job that took another route spent nothing in the build, so where no
job of the window has `first_graph.1pass_build` the readings are 0;
where jobs ran the build but none has the span asked for (a program
without it) they are None."""

from __future__ import annotations

from metrics.spans import mean_span

BUILD = "first_graph.1pass_build"


def other_route(run) -> bool:
    """The window has jobs and none ran the 1-pass build."""
    return bool(run.jobs) and mean_span(run, BUILD) is None


def build_span(run, suffix: str = "") -> float | None:
    """Mean seconds a job spends in the span(s) BUILD + suffix, summed
    within a job (one a round for a round's spans)."""
    v = mean_span(run, BUILD + suffix)
    return 0.0 if v is None and other_route(run) else v
