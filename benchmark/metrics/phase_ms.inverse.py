"""phase_ms.inverse: milliseconds a step in the program's span
``tentative_inverse`` (the tentative operator's block inversions, Dinv and
each colour's Sinv, and the Schur blocks between them; under
``IEHDG_PHASE_TIMING=1`` synchronised at both ends, so the card's time),
over the traced run's phase-timed steps."""


def read(rec):
    samples = rec.phases.get("tentative_inverse")
    if not samples or not rec.phase_steps:
        return None
    return 1e3 * sum(samples) / rec.phase_steps
