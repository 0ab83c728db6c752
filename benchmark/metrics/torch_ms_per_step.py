"""torch_ms_per_step: device milliseconds a step of everything on the card
that is not a port kernel launch (PyTorch's kernels, copies and fills),
over the profiled steps."""


def read(rec):
    t = rec.trace
    if t is None or not t.other_s or not rec.trace_steps:
        return None
    return 1e3 * t.other_s / rec.trace_steps
