"""phase_ms.sweep: milliseconds a step in the program's "sweep" phase span
(``IEHDG_PHASE_TIMING=1``: the Richardson sweeps, each a tentative and a
pressure solve), over the traced run's phase-timed steps."""


def read(rec):
    samples = rec.phases.get("sweep")
    if not samples or not rec.phase_steps:
        return None
    return 1e3 * sum(samples) / rec.phase_steps
