"""Performance measurement tools: per-label wall clocks, the step's spans
and a streaming mean.

The port's own copy of incompressibleeulerhdg_tpu/utils/logging.py, with
the spans of the HDG IMEX step beside it.  ``PerformanceLog`` timers are
host-side wall clocks; callers synchronise the device inside the timed
region so asynchronous launches do not leak out of the measurement.

Spans (:func:`span`) name the regions of one step: the step, its phases,
the two solves, the Krylov loops' parts and every blocking device-to-host
read.  The stepper opens the step's spans with :func:`step_spans`, which
sets the one module flag that every span checks, in one of three states
(both of the first two may hold):

- ``torch.profiler`` recording: each span opens
  ``torch.profiler.record_function("iehdg." + name)``, so it sits in the
  trace on the clock of the CUDA activity and names the host's time there;
- ``IEHDG_PHASE_TIMING=1`` on one rank: each span appends its own host
  seconds to ``PerformanceLog.data[name]``, with no synchronise; a span
  given a ``device`` synchronises it at its start and end, so that its
  sample is the card's time for the work inside; a phase span (the
  callable that :func:`step_spans` yields) appends instead the interval
  since the previous phase ended, after the card has finished;
- otherwise a span costs one check of the flag: no clock, no allocation and
  no ``record_function``.
"""

import time
from collections import defaultdict
from contextlib import ContextDecorator, contextmanager

import numpy as np
import torch

__all__ = ["PerformanceLog", "log_summary", "Averager", "span", "step_spans"]

SPAN_PREFIX = "iehdg."  # a span's name in the profiler's trace
RECORD, TIME = 1, 2  # the flag's bits: the profiler records; IEHDG_PHASE_TIMING=1
_mode = 0  # set by step_spans for the length of one step


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


class _Off:
    """The span of the off state: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A span in the recording or timing state; a phase span (``phases``
    given) times from the previous phase's end, after a synchronise; a
    span with a CUDA ``sync`` device synchronises it at both ends when
    timed."""

    __slots__ = ("name", "mode", "phases", "sync", "rf", "t0")

    def __init__(self, name, mode, phases=None, sync=None):
        self.name, self.mode, self.phases, self.rf = name, mode, phases, None
        self.sync = sync if mode & TIME and sync is not None and sync.type == "cuda" else None

    def __enter__(self):
        if self.mode & RECORD:
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.mode & TIME:
            ph = self.phases
            if ph is None:
                if self.sync is not None:
                    torch.cuda.synchronize(self.sync)
                PerformanceLog.data[self.name].append(time.perf_counter() - self.t0)
            else:
                if ph.cuda:
                    torch.cuda.synchronize(ph.device)
                now = time.perf_counter()
                PerformanceLog.data[self.name].append(now - ph.t_last)
                ph.t_last = now
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name, device=None):
    """The span ``name`` of the running step (see the module docstring);
    timed, it synchronises ``device`` at its start and end where that is
    a CUDA device."""
    return _Span(name, _mode, sync=device) if _mode else _OFF


class _Phases:
    """The phase spans of one step: ``phases(label)`` is a span whose timed
    interval runs from the end of the previous phase (the step's start
    first) to the card's finishing this one, as the JAX package's phase
    marks do (hdg_imex.py:586-604)."""

    def __init__(self, device):
        self.device = torch.device(device) if device is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.t_last = time.perf_counter()

    def __call__(self, label):
        return _Span(label, _mode, self) if _mode else _OFF


@contextmanager
def step_spans(timing, device=None):
    """Set the span flag for one step and open its ``step`` span; yields
    the step's phase spans.  ``timing``: ``IEHDG_PHASE_TIMING=1`` on one
    rank; ``device``: the device a phase synchronises at its end.  The
    flag is off again when the step ends."""
    global _mode
    _mode = (RECORD if torch._C._autograd._profiler_enabled() else 0) | (TIME if timing else 0)
    try:
        with span("step"):
            yield _Phases(device)
    finally:
        _mode = 0


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
