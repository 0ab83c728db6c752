"""host_reads_per_step: the program's blocking device-to-host reads a step
(the samples of its span ``host.read``, one a read: a Hessenberg column, a
norm, a finiteness test), over the traced run's phase-timed steps."""


def read(rec):
    samples = rec.phases.get("host.read")
    if not samples or not rec.phase_steps:
        return None
    return len(samples) / rec.phase_steps
