"""pres_its_per_step: the program's pressure GMRES iterations a step: the
sweeps' pressure solves, the final solve and the reconstruction (the step's
``counts``), over the traced run's window."""


def read(rec):
    if not rec.counts:
        return None
    return sum(sum(c["pressure"]) + c["final_pressure"] + c["reconstruction"]
               for c in rec.counts) / len(rec.counts)
