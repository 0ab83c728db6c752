"""host_wait_ms_per_step: milliseconds a step the host waits in the
program's blocking device-to-host reads (the sum of its span ``host.read``,
which holds the read alone), over the traced run's phase-timed steps."""


def read(rec):
    samples = rec.phases.get("host.read")
    if not samples or not rec.phase_steps:
        return None
    return 1e3 * sum(samples) / rec.phase_steps
