"""The device trace of a window: torch.profiler over the card's
activity only, reduced to busy time (the union of device intervals),
device time by operation, and the longest idle gaps labelled by the
program's span that held the host; and a record of the count kernels'
launches with their shapes, for the kernels' byte counts."""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class DeviceTrace:
    """Context manager: profiles the card's activity between enter and
    exit. reduce() turns it into the window's device numbers."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list[tuple[str, int, int]]:
        """(name, start ns, end ns) of every device activity."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
        return out

    def reduce(self, spans: list[tuple[str, int, int]]) -> dict:
        return reduce_events(self.events(), self.t0_ns, self.t1_ns, spans)


def union_intervals(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """Merged [start, end) intervals clipped to [lo, hi)."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def label(spans: list[tuple[str, int, int]], t: int) -> str:
    """The innermost (shortest) span that holds time t."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "harness"


def reduce_events(events, t0: int, t1: int, spans) -> dict:
    """busy_s, window_s, device time by operation name, the kernel
    durations by name and the longest idle gaps, from (name, start ns,
    end ns) device events inside the window [t0, t1)."""
    busy = union_intervals([(s, e) for _, s, e in events], t0, t1)
    by_name: dict[str, list[float]] = defaultdict(list)
    for name, s, e in events:
        by_name[name].append((e - s) / 1e9)
    gaps = []
    prev = t0
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            gaps.append((s - prev, label(spans, (prev + s) // 2)))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    ops = sorted(((n, sum(d)) for n, d in by_name.items()),
                 key=lambda x: -x[1])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": dict(by_name),
        "device_ops": [[n[:120], t] for n, t in ops[:10]],
        "idle_gaps": [[lab, g / 1e9] for g, lab in gaps[:10]],
    }


class LaunchRecorder:
    """Records each call of the count's two kernel wrappers with the
    shapes its bytes follow from (kernel 1: the pool's words and k;
    kernel 2: the rows and the bytes of a row's key columns), and the
    wrappers' launch counters across the window. The wrappers bump their
    counter through the module's name, so the recording function carries
    the counter while it stands in for the wrapper."""

    NAMES = ("canonical_all_kmers", "count_sorted_runs")

    def __init__(self, kernels_module):
        self.mod = kernels_module
        self.calls: dict[str, list[tuple]] = {n: [] for n in self.NAMES}
        self.launches: dict[str, int] = {}

    def _wrap(self, name, orig):
        calls = self.calls[name]

        def recorded(*args, **kwargs):
            if name == "canonical_all_kmers":
                packed, k = args[0], args[1]
                calls.append((int(packed.shape[0]), int(k)))
            else:
                cols = list(args[0])
                calls.append((int(cols[0].shape[0]),
                              sum(c.element_size() for c in cols)))
            return orig(*args, **kwargs)

        recorded.launches = orig.launches
        return recorded

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.NAMES}
        self.start = {n: f.launches for n, f in self.orig.items()}
        for n, f in self.orig.items():
            setattr(self.mod, n, self._wrap(n, f))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            f.launches = getattr(self.mod, n).launches
            setattr(self.mod, n, f)
            self.launches[n] = f.launches - self.start[n]
        return False
