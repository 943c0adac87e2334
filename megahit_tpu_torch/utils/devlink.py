"""Host<->device link characterization for adaptive dispatch.

The graph-cleaning passes are latency-bound: dozens of small device
passes whose operands and results are tiny, where the per-pass round
trip dominates. On a card on the host's own PCIe/NVLink (~0.01-0.1 ms)
the device engine wins; behind a remote or tunneled link (hundreds of
ms a round trip) the same pass pattern pays seconds per pass and the
host engine wins. Measure once per process and dispatch accordingly -
the throughput-bound stages (count/sort/finalize) are NOT routed by
this: their operands are large enough that bandwidth, not latency,
decides, and they stay on the card.

MEGAHIT_TPU_TORCH_LINK_MS=<float> overrides the measurement (tests and
benchmarks pin it to get deterministic routing). Counterpart of
megahit_tpu/utils/devlink.py.
"""

from __future__ import annotations

import os
import time

_cached_ms: float | None = None


def link_latency_ms() -> float:
    """Measured min round trip of a tiny op on the default CUDA device
    plus its `.item()` readback (cached per process; a warm-up call
    first, so CUDA context creation is not timed). 0.0 without a
    card."""
    global _cached_ms
    env = os.environ.get("MEGAHIT_TPU_TORCH_LINK_MS")
    if env:
        return float(env)
    if _cached_ms is None:
        import torch

        if not torch.cuda.is_available():
            _cached_ms = 0.0
        else:
            x = torch.zeros(8, dtype=torch.int32, device="cuda")
            (x + 1)[0].item()  # context, first launch and transfer
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                (x + 1)[0].item()
                best = min(best, time.perf_counter() - t0)
            _cached_ms = best * 1000.0
    return _cached_ms


def latency_bound_link(threshold_ms: float = 20.0) -> bool:
    """True when the per-pass round trip is so high that chatty device
    passes lose to the host engine (remote/tunneled devices)."""
    return link_latency_ms() > threshold_ms
