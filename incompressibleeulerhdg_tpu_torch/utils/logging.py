"""Performance measurement tools: per-label wall clocks and a streaming mean.

The port's own copy of incompressibleeulerhdg_tpu/utils/logging.py (numpy
only).  Timers are host-side wall clocks; callers synchronise the device
inside the timed region (the solve loops call ``torch.cuda.synchronize``)
so asynchronous launches do not leak out of the measurement.
"""

import time
from collections import defaultdict
from contextlib import ContextDecorator

import numpy as np

__all__ = ["PerformanceLog", "log_summary", "Averager"]


class PerformanceLog(ContextDecorator):
    """Context manager / decorator accumulating wall-clock per label.

    Samples are stored process-wide so nested solver layers can report into
    one table, mirroring the observability the reference builds its per-label
    timing on.
    """

    data = defaultdict(list)

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        PerformanceLog.data[self.label].append(time.perf_counter() - self._t0)

    @classmethod
    def reset(cls):
        cls.data = defaultdict(list)


def log_summary(out=print):
    """Print per-label call counts and wall-clock statistics.

    Labels are sorted by total time, descending; emits nothing when no timer
    ran.  ``out`` is injectable for testing.
    """
    if not PerformanceLog.data:
        return
    rows = []
    for label, samples in PerformanceLog.data.items():
        t = np.asarray(samples)
        rows.append((label, t.size, float(t.sum()), float(t.mean()), float(t.std())))
    rows.sort(key=lambda r: r[2], reverse=True)

    width = max(len(r[0]) for r in rows)
    header = f"{'timer':<{width}s}  {'calls':>7s}  {'total[s]':>11s}  {'mean[s]':>11s}  {'std[s]':>11s}"
    out(header)
    out("=" * len(header))
    for label, ncall, total, avg, std in rows:
        out(f"{label:<{width}s}  {ncall:7d}  {total:11.4e}  {avg:11.4e}  {std:11.4e}")


class Averager:
    """Streaming mean of solver iteration counts (reference utils.py:11-46
    role; Welford-style single-pass update)."""

    def __init__(self):
        self.reset()

    @property
    def value(self):
        return self._mean

    @property
    def n_samples(self):
        return self._count

    def update(self, x):
        self._count += 1
        self._mean += (x - self._mean) / self._count

    def reset(self):
        self._count = 0
        self._mean = 0.0

    def __repr__(self):
        return f"{self.value} (averaged over {self.n_samples} samples)"
