"""solve_ms.tentative: milliseconds a step in the program's tentative
solves (the span ``solve.tentative`` around each ``tentative_solve``, its
host seconds under ``IEHDG_PHASE_TIMING=1``, with no synchronise of its
own), over the traced run's phase-timed steps."""


def read(rec):
    samples = rec.phases.get("solve.tentative")
    if not samples or not rec.phase_steps:
        return None
    return 1e3 * sum(samples) / rec.phase_steps
