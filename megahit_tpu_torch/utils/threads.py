"""Host thread budget (reference -t/--num-cpu-threads,
src/megahit:555-560: default = all logical CPUs).

The device passes run on the torch device; this budget caps the
HOST-side thread pools (sorted-membership searches, mercy scans), which
are genuinely CPU-bound.
"""

from __future__ import annotations

import os

_num_threads = 0  # 0 = auto (all logical CPUs)


def set_num_threads(n: int) -> None:
    global _num_threads
    _num_threads = max(0, int(n))


def num_threads() -> int:
    if _num_threads > 0:
        return _num_threads
    return os.cpu_count() or 1
