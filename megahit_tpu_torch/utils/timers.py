"""The port's span recorder (reference src/utils/utils.h:115-160: the
per-phase xinfo timer lines and AutoMaxRssRecorder).

A PhaseTimer records the spans of one job (one `Pipeline.run()`): each
span's name, its start and end on `time.time_ns()` (the wall clock on
which torch.profiler places device events), the span that opened it,
the job's id, and the counters bumped inside it. `PhaseTimer.phase`
opens a span under a name of its own; library code opens child spans
with `span(name)`, named "<parent>.<name>", and bumps counters with
`count(name, n)`, both through a context variable that holds the open
span, so neither needs the recorder passed down. With no span open (the
stage CLI, unit tests) neither records anything. A worker thread of a
pool starts in an empty context, so it sees no open span: spans and
counters belong to the calling thread.

At each span's end the recorder logs "phase <name>: <seconds>" at DEBUG,
with the span's start_ns, end_ns, parent and job on the record.
"""

from __future__ import annotations

import resource
import time
import uuid
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

from .log import get_logger


@dataclass
class SpanRecord:
    name: str
    start_ns: int
    end_ns: int = 0
    parent: str | None = None
    job: str | None = None
    counters: dict[str, int] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Spans(dict):
    """A job's spans: name -> seconds summed over the job, with
    `records` (every SpanRecord, in the order they closed) and
    `counters` (span name -> counter name -> sum over the job)."""

    def __init__(self, records: list[SpanRecord]):
        super().__init__()
        self.records = records
        self.counters: dict[str, dict[str, int]] = {}
        for rec in records:
            self[rec.name] = self.get(rec.name, 0.0) + rec.seconds
            if rec.counters:
                total = self.counters.setdefault(rec.name, {})
                for c, n in rec.counters.items():
                    total[c] = total.get(c, 0) + n


# the open span and the recorder that records it, on this thread
_OPEN: ContextVar[tuple[PhaseTimer, SpanRecord] | None] = ContextVar(
    "megahit_tpu_torch_open_span", default=None)


class PhaseTimer:
    """The spans of one job; logs like the reference's per-phase xinfo
    timer lines."""

    def __init__(self):
        self.job = uuid.uuid4().hex[:12]
        self.records: list[SpanRecord] = []

    @contextmanager
    def phase(self, name: str):
        """A span named `name`, a child of the open span. Yields its
        record, whose `seconds` hold once the block has ended. A block
        that raises leaves no record."""
        up = _OPEN.get()
        rec = SpanRecord(name, time.time_ns(),
                         parent=up[1].name if up else None, job=self.job)
        token = _OPEN.set((self, rec))
        try:
            yield rec
        finally:
            rec.end_ns = time.time_ns()
            _OPEN.reset(token)
        self.records.append(rec)
        get_logger().debug(
            "phase %s: %.3fs", name, rec.seconds,
            extra={"start_ns": rec.start_ns, "end_ns": rec.end_ns,
                   "parent": rec.parent, "job": self.job})

    def spans(self) -> Spans:
        return Spans(self.records)


@contextmanager
def _unrecorded(name: str):
    rec = SpanRecord(name, time.time_ns())
    try:
        yield rec
    finally:
        rec.end_ns = time.time_ns()


def span(name: str):
    """A child span of the open span, named "<open span>.<name>". With
    no span open it records nothing; the record it yields still holds
    the block's seconds."""
    up = _OPEN.get()
    if up is None:
        return _unrecorded(name)
    timer, parent = up
    return timer.phase(f"{parent.name}.{name}")


def count(name: str, n: int) -> None:
    """Adds n to the open span's counter `name`; nothing with no span
    open."""
    up = _OPEN.get()
    if up is not None:
        c = up[1].counters
        c[name] = c.get(name, 0) + int(n)


def max_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
