"""Wall-clock phase timers (reference src/utils/utils.h:115-160:
SimpleTimer + AutoMaxRssRecorder)."""

from __future__ import annotations

import resource
import time
from contextlib import contextmanager

from .log import get_logger


class SimpleTimer:
    def __init__(self):
        self._t0 = time.monotonic()
        self.elapsed = 0.0

    def reset(self):
        self._t0 = time.monotonic()
        self.elapsed = 0.0

    def stop(self):
        self.elapsed = time.monotonic() - self._t0
        return self.elapsed


class PhaseTimer:
    """Collects named phase durations; logs like the reference's per-phase
    xinfo timer lines."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        yield
        dt = time.monotonic() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        get_logger().debug("phase %s: %.3fs", name, dt)


def max_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
