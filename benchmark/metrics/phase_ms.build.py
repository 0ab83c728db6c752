"""phase_ms.build: milliseconds a step in the program's "star+build" phase
span (``IEHDG_PHASE_TIMING=1``: BDM projection, star fields and the stage's
tentative operator, K4 or K5 included), over the traced run's phase-timed
steps."""


def read(rec):
    samples = rec.phases.get("star+build")
    if not samples or not rec.phase_steps:
        return None
    return 1e3 * sum(samples) / rec.phase_steps
