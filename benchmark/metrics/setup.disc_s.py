"""setup.disc_s: host seconds of ``HDGDiscretisation`` and the stepper's
construction in set-up, ended by a synchronise (the benchmark's span)."""


def read(rec):
    return rec.spans.get("disc")
