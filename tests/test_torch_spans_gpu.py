"""The span recorder against the card's trace: a kernel launched and
synchronized inside a span has its device event inside that span, on
the clock the benchmark labels idle gaps by. Marked `gpu`; skips
without a CUDA device.

This file imports neither JAX nor megahit_tpu:

    python -m pytest --noconftest -m gpu tests/test_torch_spans_gpu.py
"""

import time

import pytest
import torch

from megahit_tpu_torch.utils.timers import PhaseTimer, span

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_device_event_inside_its_span():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1 << 24, device="cuda")
    (x * 2).sum()  # warm: the kernels load before the trace
    torch.cuda.synchronize()
    t = PhaseTimer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with t.phase("job"):
            time.sleep(0.01)
            with span("kernel") as rec:
                y = x * 3
                torch.cuda.synchronize()
            time.sleep(0.01)
    del y
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler saw no device event"
    for e in kernels:
        assert rec.start_ns <= e.start_ns(), (e.name(), rec.start_ns,
                                              e.start_ns())
        assert e.start_ns() + e.duration_ns() <= rec.end_ns, e.name()
    assert rec.name == "job.kernel"
