"""device_ms_per_step: milliseconds a step in which some operation ran on
the card (the union of the device events of the profiled steps, over
those steps).  The profiler slows the host, not the card, so this reads
the card's work a step undistorted; 1 - this / ``step_s`` is the untraced
idle share."""


def read(rec):
    t = rec.trace
    if t is None or not t.busy_s > 0 or not rec.trace_steps:
        return None
    return 1e3 * t.busy_s / rec.trace_steps
