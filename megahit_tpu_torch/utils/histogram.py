"""Histogram statistics (reference src/utils/histgram.h:27-238).

Vectorized over numpy value arrays instead of the reference's
concurrent insert API - every consumer here owns its data already.
Copy of megahit_tpu/utils/histogram.py (the port imports nothing of
megahit_tpu).
"""

from __future__ import annotations

import numpy as np


class Histogram:
    def __init__(self, values=None):
        self._v = np.asarray(values if values is not None else [],
                             dtype=np.float64)

    def insert_many(self, values) -> None:
        self._v = np.concatenate([self._v, np.asarray(values, np.float64)])

    @property
    def size(self) -> int:
        return len(self._v)

    def mean(self) -> float:
        """Reference mean() = sum() / size() where sum() returns the
        integral value_type (histgram.h:70-83): the division truncates.
        Every reference instantiation is integral, so we floor-divide
        whenever the stored values are whole numbers."""
        if not self.size:
            return 0.0
        if np.all(self._v == np.floor(self._v)):
            return float(int(self._v.sum()) // self.size)
        return float(self._v.mean())

    def sd(self) -> float:
        return float(self._v.std()) if self.size else 0.0

    def minimum(self) -> float:
        return float(self._v.min()) if self.size else 0.0

    def maximum(self) -> float:
        return float(self._v.max()) if self.size else 0.0

    def sum(self) -> float:
        return float(self._v.sum())

    def median(self) -> float:
        return float(np.median(self._v)) if self.size else 0.0

    def percentile(self, p: float) -> float:
        """Smallest value v with fraction(values <= v) >= p
        (reference Histgram::percentile)."""
        if not self.size:
            return 0.0
        s = np.sort(self._v)
        i = min(int(np.ceil(p * len(s))) , len(s) - 1)
        return float(s[max(i, 0)])

    def nx(self, x: float) -> float:
        """Nx statistic: largest v such that the sum of values >= v is
        at least x (N50 when x = total/2; reference Histgram::Nx)."""
        if not self.size:
            return 0.0
        s = np.sort(self._v)[::-1]
        cum = np.cumsum(s)
        i = int(np.searchsorted(cum, x))
        return float(s[min(i, len(s) - 1)])

    def trim(self, fraction: float) -> None:
        """Reference Trim (histgram.h:158-189): budget
        size*fraction/2 + 0.5 per tail, removing whole VALUE BINS from
        each end only while the bin fits the remaining budget."""
        if not self.size:
            return
        budget = int(len(self._v) * fraction / 2 + 0.5)
        vals, counts = np.unique(self._v, return_counts=True)
        lo = 0
        left = budget
        while lo < len(vals) and counts[lo] <= left:
            left -= counts[lo]
            lo += 1
        hi = len(vals)
        left = budget
        while hi > lo and counts[hi - 1] <= left:
            left -= counts[hi - 1]
            hi -= 1
        keep = (self._v >= vals[lo]) & (self._v <= vals[hi - 1]) \
            if hi > lo else np.zeros(len(self._v), dtype=bool)
        self._v = self._v[keep]

    def trim_low(self, threshold: float) -> None:
        self._v = self._v[self._v >= threshold]

    def first_local_minimum(self) -> float:
        """Reference FirstLocalMinimum (histgram.h:143-156)."""
        if not self.size:
            return 0.0
        vals, counts = np.unique(self._v, return_counts=True)
        min_i, rises = 0, 0
        for i in range(len(vals)):
            if counts[i] <= counts[min_i]:
                min_i, rises = i, 0
            else:
                rises += 1
                if rises >= 4:
                    break
        if vals[min_i] == vals[-1]:
            return 0.0
        return float(vals[min_i])
