"""setup.mesh_s: host seconds of the program's ``unit_square_mesh`` in set-up
(the benchmark's span around the call)."""


def read(rec):
    return rec.spans.get("mesh")
