"""What a run's state and printed output say about it, for the problems
without an exact solution and for comparing two drivers.

- ``kinetic_energy``, ``divergence_norm`` and ``flow_diagnostics``: the
  checks of tests/test_integration_extra.py (the energy ratio E(T)/E(0) and
  the L2 norm of the divergence of the final velocity), computed on the
  device and in the dtype of the discretisation they are given;
- ``tracer_norm``: the L2 norm of a tracer field;
- ``averaged_counts``: the "average number of solver iterations" block that
  the HDG IMEX ``solve`` of either package prints, as a dict.
"""

import re

import torch

from ..ops import fields as F

__all__ = ["kinetic_energy", "divergence_norm", "flow_diagnostics", "tracer_norm",
           "averaged_counts"]


def kinetic_energy(geom, Q):
    """0.5 ||Q||^2 of a (2, d1, nc) velocity."""
    return 0.5 * float(F.l2_norm_sq(geom, geom.phi1, Q))


def divergence_norm(geom, Q):
    """L2 norm of the divergence of Q, mass-projected onto the pressure space."""
    divQ = F.mass_solve(geom, geom.m0inv, F.cell_integrate(geom, geom.phi0, F.cell_div(geom, Q)))
    return float(torch.sqrt(F.l2_norm_sq(geom, geom.phi0, divQ)))


def flow_diagnostics(disc, problem, Q):
    """(E(T)/E(0), divergence L2 norm) of a final velocity ``Q`` (a tensor or
    an array, moved to ``disc``'s device and dtype), E(0) from ``problem``'s
    initial velocity interpolated on ``disc``."""
    geom = disc.geom
    Q = torch.as_tensor(Q).to(device=geom.device, dtype=geom.dtype)
    Q0 = disc.interpolate_velocity(problem.initial_condition()[0])
    return kinetic_energy(geom, Q) / kinetic_energy(geom, Q0), divergence_norm(geom, Q)


def tracer_norm(disc, q):
    """L2 norm of a (d0, nc) tracer (a tensor or an array, moved to
    ``disc``'s device and dtype)."""
    geom = disc.geom
    q = torch.as_tensor(q).to(device=geom.device, dtype=geom.dtype)
    return float(torch.sqrt(F.l2_norm_sq(geom, geom.phi0, q)))


def averaged_counts(out):
    """name -> averaged iterations of the driver's "average number of solver
    iterations" block in the text ``out``."""
    return {m.group(1).strip(): float(m.group(2))
            for m in re.finditer(r"^\s+(\w[\w ]*\w)\s+its\s+:\s+(\S+)$", out, re.M)}
