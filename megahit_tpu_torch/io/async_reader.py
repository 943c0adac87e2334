"""Asynchronous double-buffered sequence reading.

Reference: AsyncSequenceReader (src/sequence/io/async_sequence_reader.h:
14-75) - a std::async-prefetched batch pipeline that overlaps input
parsing with compute. Here: a background thread parses+packs the next
file (native C++ parser) while the caller consumes the current pool -
the host-side input pipeline that feeds device steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np

from .fastx import read_fastx_flat


class AsyncFastxReader:
    """Iterate (flat_codes, starts) pools over many files with one
    file of read-ahead."""

    def __init__(self, paths: Iterable[str], do_trim_n: bool = True,
                 prefetch: int = 1):
        self._paths = list(paths)
        self._trim = do_trim_n
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for p in self._paths:
                self._q.put(("ok", p, read_fastx_flat(p, self._trim)))
        except Exception as e:  # surface in the consumer thread
            self._q.put(("err", None, e))
        self._q.put(("done", None, None))

    def __iter__(self) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
        while True:
            kind, path, payload = self._q.get()
            if kind == "done":
                return
            if kind == "err":
                raise payload
            flat, starts = payload
            yield path, flat, starts
