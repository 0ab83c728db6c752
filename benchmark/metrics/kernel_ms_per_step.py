"""kernel_ms_per_step: device milliseconds a step of the port's own CUDA
kernels (the device events launched inside a recorded port launch), over
the profiled steps."""


def read(rec):
    t = rec.trace
    if t is None or not t.launch_s or not rec.trace_steps:
        return None
    return 1e3 * sum(t.launch_s.values()) / rec.trace_steps
