"""solve_ms.pressure: milliseconds a step in the program's pressure solves
(the span ``solve.pressure`` around each ``pressure_solve``: the sweeps',
the final solve and the reconstruction; its host seconds under
``IEHDG_PHASE_TIMING=1``, with no synchronise of its own), over the traced
run's phase-timed steps."""


def read(rec):
    samples = rec.phases.get("solve.pressure")
    if not samples or not rec.phase_steps:
        return None
    return 1e3 * sum(samples) / rec.phase_steps
