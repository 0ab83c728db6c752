"""precond_replay_share: the share of the Krylov loops' preconditioner
applications that ran as one replay of a CUDA graph (the samples of the
program's span ``krylov.replay`` over those of ``krylov.precond``), over
the traced run's phase-timed steps."""


def read(rec):
    precond = rec.phases.get("krylov.precond")
    replay = rec.phases.get("krylov.replay")
    if not precond or not replay or not rec.phase_steps:
        return None
    return len(replay) / len(precond)
