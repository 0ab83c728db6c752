"""Rank jobs of the distributed tests (tests/test_torch_slab_*.py): a scheme
run for a few steps on one rank of a slab-decomposed run, or on one device.

The jobs live in a module of their own, which imports nothing of JAX,
because the launcher pickles them by name into freshly spawned processes.
"""

import contextlib
import math

import torch

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import DoubleLayerShearFlow, TaylorGreen
from incompressibleeulerhdg_tpu_torch.timesteppers import dg_implicit, hdg_imex
from incompressibleeulerhdg_tpu_torch.timesteppers.dg_implicit import IncompressibleEulerDGImplicit
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_implicit import (
    IncompressibleEulerHDGImplicit,
)

# scheme -> (dt, steps); dg and monolithic at a capped outer FGMRES (see
# ``capped``): at the full cap of 100 each of their steps makes tens of
# thousands of gloo round trips on the CPU
SCHEMES = {
    "imex": (0.1, 2),
    "hdg_implicit": (0.1, 2),
    "monolithic": (0.1, 2),
    "dg_implicit": (0.01, 2),
    "imex_tracer": (0.1, 2),
    "imex_f32": (0.1, 2),  # the projection IMEX step in float32
}
CAP = 4  # outer FGMRES iterations of the capped schemes


@contextlib.contextmanager
def capped(maxiter):
    """The monolithic stage solve and DG's coupled FGMRES stop after
    ``maxiter`` outer iterations, one restart cycle (the same cap on every
    run compared)."""
    mono, fg = hdg_imex.monolithic_stage_solve, dg_implicit.fgmres
    cap = {"maxiter": maxiter, "restart": maxiter}
    hdg_imex.monolithic_stage_solve = lambda *a, **k: mono(*a, **{**k, **cap})
    dg_implicit.fgmres = lambda *a, **k: fg(*a, **{**k, **cap})
    try:
        yield
    finally:
        hdg_imex.monolithic_stage_solve, dg_implicit.fgmres = mono, fg


def make(scheme, problem, nx, comm=None, device="cpu"):
    """(stepper, problem, dt, steps) on the global tables, distributed over
    ``comm`` when given."""
    mesh = TM.periodic_square_mesh(nx, L=2 * math.pi) if problem == "shear" else \
        TM.unit_square_mesh(nx)
    disc = HDGDiscretisation(mesh, 1, torch.float32 if scheme.endswith("_f32") else torch.float64,
                             device="cpu" if comm else device)
    dt, steps = SCHEMES[scheme]
    if problem == "shear":
        dt = dt / 2
    if scheme == "hdg_implicit":
        stepper = IncompressibleEulerHDGImplicit(disc, dt)
    elif scheme == "dg_implicit":
        stepper = IncompressibleEulerDGImplicit(disc, dt)
    else:
        stepper = hdg_imex.IncompressibleEulerHDGIMEXSSP2_332(
            disc, dt, use_projection_method=scheme != "monolithic")
    prob = DoubleLayerShearFlow(disc) if problem == "shear" else TaylorGreen(disc)
    if comm is not None:
        stepper.distribute(comm, device)
    return stepper, prob, dt, steps


def tracer0(x, y):
    return torch.sin(2 * math.pi * x) * torch.sin(2 * math.pi * y)


def run_scheme(scheme, problem, nx, comm=None, device="cpu"):
    """States (Q, p[, tracer]) gathered after each step, each step's
    iteration counts and (distributed) collective counts."""
    stepper, prob, dt, steps = make(scheme, problem, nx, comm, device)
    f_rhs = prob.f_rhs()
    out = {"states": [], "counts": [], "collectives": []}
    imex = isinstance(stepper, hdg_imex.IncompressibleEulerHDGIMEX)
    with capped(CAP) if scheme in ("monolithic", "dg_implicit") else contextlib.nullcontext():
        if imex:
            state = stepper.initial_state(*prob.initial_condition())
            q = stepper.initial_tracer(tracer0) if scheme == "imex_tracer" else None
        else:
            state = stepper.initial_fields(*prob.initial_condition())
        for k in range(steps):
            if comm is not None:
                comm.reset_counts()
            if imex:
                Q_old = state[0][0]
                *state, counts = stepper.step(*state, k * dt, f_rhs)
                if q is not None:
                    q = stepper.tracer_step(q, [Q_old] + state[0][1:])
                Q, p = state[0][0], state[1][0]
            else:
                Q, p, counts = stepper.advance(*state, stepper.forcing(f_rhs(k * dt)))
                state = (Q, p)
                q = None
            if comm is not None:
                out["collectives"].append(dict(comm.counts))
            out["counts"].append({k_: v for k_, v in counts.items() if k_ != "max_relres"})
            out["states"].append(tuple(stepper.gather(f) for f in (Q, p, q) if f is not None))
    return out


def job(comm, device, runs):
    """Every (scheme, problem, nx) of ``runs`` on this rank; rank 0's
    results (the other ranks' collective counts only)."""
    res = {r: run_scheme(*r, comm=comm, device=device) for r in runs}
    if comm.rank:
        return {r: {"collectives": v["collectives"]} for r, v in res.items()}
    return res


def checkpoint_job(comm, device, path):
    """One distributed IMEX step with a checkpoint, then a resumed second
    step from it (a new stepper that reads the file): the final (Q, p)."""
    out = []
    for tfinal, kw in ((0.1, dict(checkpoint_every=1)), (0.2, dict(resume=True))):
        stepper, prob, dt, _ = make("imex", "taylorgreen", 8, comm, device)
        Q, p = stepper.solve(*prob.initial_condition(), None, prob.f_rhs(), tfinal,
                             checkpoint_path=path, **kw)
        out.append((Q, p))
    return out
