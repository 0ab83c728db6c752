"""Taylor–Green on the unit square, the problem of the traffic mixes whose
``"problem"`` is ``"taylor_green"``.

The seed draws the decay rate kappa uniformly from the traffic's
``"kappa"`` range; mesh, degree, dt and precision never move with it.  The
program runs its own ``TaylorGreen`` on its ``unit_square_mesh``; the plain
reference (``benchmark/reference.py``) holds the state after the window to
the closed-form solution under exponential forcing.

A problem module gives the harness five functions, found by the problem's
name (``manifest.cell_spec``): ``check`` (refuse a configuration or traffic
value the module does not implement), ``parameters`` (what the seed
draws), ``mesh``, ``program_problem`` and ``errors`` (each number of the
plain reference that decides ``correct``).
"""

import numpy as np

from benchmark import reference

__all__ = ["check", "parameters", "mesh", "program_problem", "errors", "kappa_of"]

NUMBERS = ("velocity_l2", "pressure_l2", "trace_rms")


def check(config, traffic):
    """Raise ValueError on what the closed form does not cover."""
    if traffic.get("mesh") != "unit_square":
        raise ValueError(f"taylor_green runs on the unit square, not {traffic.get('mesh')!r}")
    if config.get("forcing") != "exponential":
        raise ValueError(f"the closed form is the exponential forcing's, not "
                         f"{config.get('forcing')!r}")
    lo, hi = traffic["kappa"]
    if not (0.0 < lo <= hi and int(traffic["nx"]) > 0 and float(traffic["dt"]) > 0.0):
        raise ValueError(f"bad taylor_green traffic: nx {traffic['nx']!r}, dt {traffic['dt']!r}, "
                         f"kappa {traffic['kappa']!r}")


def kappa_of(seed, kappa_range):
    """The Taylor–Green decay rate of ``seed``, uniform in ``kappa_range``."""
    lo, hi = kappa_range
    return float(lo + (hi - lo) * np.random.default_rng(seed % 2 ** 63).random())


def parameters(seed, traffic):
    return {"kappa": kappa_of(seed, traffic["kappa"])}


def mesh(traffic):
    from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh

    return unit_square_mesh(traffic["nx"])


def program_problem(disc, config, params):
    from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen

    return TaylorGreen(disc, forcing=config["forcing"], kappa=params["kappa"])


def errors(arrays, config, traffic, params, t):
    """The reference's distances of the state ``arrays``
    (``cell.state_arrays``) at time ``t``; a layout the reference cannot
    read raises ValueError."""
    Q, p, lam, cells, ends = arrays
    return reference.state_errors(Q, p, lam, cells, ends, traffic["nx"], config["degree"],
                                  params["kappa"], t)
