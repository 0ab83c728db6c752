"""tent_its_per_step: the program's tentative GMRES iterations a step (the
step's ``counts["tentative"]``, summed), over the traced run's window."""


def read(rec):
    if not rec.counts:
        return None
    return sum(sum(c["tentative"]) for c in rec.counts) / len(rec.counts)
