"""Reading a torch.profiler chrome trace of the traced steps.

The trace holds device events (kernels, copies, fills) with the
correlation id of the host call that launched them, the host's CUDA
runtime and driver calls with the same id, and the host spans that
``torch.profiler.record_function`` opened.  The benchmark opens one span
around the traced steps (``WINDOW_SPAN``) and one around each launch of
a port kernel (``LAUNCH_SPAN`` + its index, see ``probe.py``).  A device
event belongs to launch i when the host call that launched it lies inside
that launch's span on the same thread; every other device event is
PyTorch's own.
"""

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "bench.window"
LAUNCH_SPAN = "bench.launch."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")

__all__ = ["TraceSummary", "summarise", "summarise_file", "WINDOW_SPAN", "LAUNCH_SPAN"]


@dataclass
class TraceSummary:
    """Seconds read from one traced window."""

    window_s: float  # the window span's length
    busy_s: float  # union of the device events inside the window
    launch_s: dict = field(default_factory=dict)  # port launch index -> device seconds
    other_s: float = 0.0  # device seconds of everything else
    device_ops: list = field(default_factory=list)  # [[name, seconds]], largest first
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]], largest first


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(spans):
    """Change points (time, name) of the innermost span of properly nested
    host spans (start, end, name); None where no span is open."""
    points = []
    stack = []
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end = stack.pop()[0]
            points.append((end, stack[-1][1] if stack else None))
        stack.append((b, name))
        points.append((a, name))
    while stack:
        end = stack.pop()[0]
        points.append((end, stack[-1][1] if stack else None))
    return sorted(points, key=lambda p: p[0])


def _short(name, width=96):
    return name if len(name) <= width else name[:width - 3] + "..."


def summarise(events, top=10):
    """A :class:`TraceSummary` of a chrome trace's ``traceEvents``, or None
    when the trace has no window span or no device event in it."""
    window = next((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == WINDOW_SPAN), None)
    if window is None:
        return None
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    tid = window.get("tid")

    launches = defaultdict(list)  # tid -> [(start, end, index)]
    host = []
    runtime = {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in HOST_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"].startswith(LAUNCH_SPAN):
            launches[e.get("tid")].append((a, b, int(e["name"][len(LAUNCH_SPAN):])))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            runtime[e["args"]["correlation"]] = (a, e.get("tid"))
        if e.get("tid") == tid and e is not window and w0 <= a < w1:
            host.append((a, min(b, w1), e["name"]))
    starts = {t: [s[0] for s in sorted(v)] for t, v in launches.items()}
    spans = {t: sorted(v) for t, v in launches.items()}

    def launch_of(corr):
        found = runtime.get(corr)
        if found is None or found[1] not in spans:
            return None
        ts, t = found
        i = bisect.bisect_right(starts[t], ts) - 1
        if i >= 0 and spans[t][i][0] <= ts <= spans[t][i][1]:
            return spans[t][i][2]
        return None

    summary = TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=0.0)
    busy = []
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        sec = (b - a) * 1e-6
        idx = launch_of(e.get("args", {}).get("correlation"))
        if idx is None:
            summary.other_s += sec
            by_name[_short(e["name"])] += sec
        else:
            summary.launch_s[idx] = summary.launch_s.get(idx, 0.0) + sec
            by_name["port: " + _short(e["name"])] += sec
    if not busy:
        return None
    merged = _union(busy)
    summary.busy_s = sum(b - a for a, b in merged) * 1e-6
    summary.device_ops = [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]]

    points = _innermost(host)
    times = [p[0] for p in points]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_right(times, a) - 1
        name = points[i][1] if i >= 0 else None
        gaps[name or "(Python between ops)"] += (b - a) * 1e-6
    summary.idle_gaps = [[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:top]]
    return summary


def summarise_file(path, top=10):
    with open(path) as f:
        return summarise(json.load(f)["traceEvents"], top)
