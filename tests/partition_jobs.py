"""Rank jobs of the partition tests (tests/test_torch_partition*.py): a case
run for a few steps on one rank of a partitioned run, or on one device, and
the per-rank checks of the ghost plans and the partitioned operators.

The jobs live in a module of their own, which imports nothing of JAX,
because the launcher pickles them by name into freshly spawned processes.
"""

import contextlib
import math

import numpy as np
import torch

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as P
from incompressibleeulerhdg_tpu_torch.linalg.condense import trace_matvec
from incompressibleeulerhdg_tpu_torch.linalg.gtmg import gtmg_apply
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import (
    DoubleLayerShearFlow,
    KelvinHelmholtz,
    TaylorGreen,
)
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields
from incompressibleeulerhdg_tpu_torch.ops.tracer import tracer_step
from incompressibleeulerhdg_tpu_torch.parallel.partition import Partition
from incompressibleeulerhdg_tpu_torch.timesteppers import conforming_implicit, dg_implicit, hdg_imex
from incompressibleeulerhdg_tpu_torch.timesteppers.conforming_implicit import (
    IncompressibleEulerConformingImplicit,
)
from incompressibleeulerhdg_tpu_torch.timesteppers.dg_implicit import IncompressibleEulerDGImplicit
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_implicit import (
    IncompressibleEulerHDGImplicit,
)

CAP = 4  # outer FGMRES iterations of the monolithic, DG and conforming-monolithic runs


@contextlib.contextmanager
def capped(maxiter):
    """The monolithic stage solve and the coupled FGMRES of DG and of the
    conforming scheme stop after ``maxiter`` outer iterations, one restart
    cycle (the same cap on every run compared): at their full cap each of
    their steps makes tens of thousands of gloo round trips on the CPU."""
    mono = hdg_imex.monolithic_stage_solve
    fg_dg, fg_cf = dg_implicit.fgmres, conforming_implicit.fgmres
    cap = {"maxiter": maxiter, "restart": maxiter}
    hdg_imex.monolithic_stage_solve = lambda *a, **k: mono(*a, **{**k, **cap})
    dg_implicit.fgmres = lambda *a, **k: fg_dg(*a, **{**k, **cap})
    conforming_implicit.fgmres = lambda *a, **k: fg_cf(*a, **{**k, **cap})
    try:
        yield
    finally:
        hdg_imex.monolithic_stage_solve = mono
        dg_implicit.fgmres, conforming_implicit.fgmres = fg_dg, fg_cf


def make_mesh(problem, size):
    if problem == "kelvinhelmholtz":
        return TM.unit_disk_mesh(size)
    if problem == "shear":
        return TM.periodic_square_mesh(size, L=2 * math.pi)
    return TM.unit_square_mesh(size)


def make(case, comm=None, device="cpu"):
    """(stepper, problem) of ``case`` = (problem, mesh size, scheme, dt,
    steps, tracer) on the global tables, distributed over ``comm`` when
    given (the tracer is routed as the driver routes it).  A scheme named
    ``..._f32`` runs in float32 ("imex_f32": the projection IMEX step)."""
    problem, size, scheme, dt, _, tracer = case
    disc = HDGDiscretisation(make_mesh(problem, size), 0 if scheme.startswith("conforming")
                             else 1, torch.float32 if scheme.endswith("_f32") else torch.float64,
                             device="cpu" if comm else device)
    if scheme == "hdg_implicit":
        stepper = IncompressibleEulerHDGImplicit(disc, dt)
    elif scheme == "dg_implicit":
        stepper = IncompressibleEulerDGImplicit(disc, dt)
    elif scheme.startswith("conforming"):
        stepper = IncompressibleEulerConformingImplicit(
            disc, dt, use_projection_method=scheme == "conforming")
    else:
        stepper = hdg_imex.IncompressibleEulerHDGIMEXSSP2_332(
            disc, dt, use_projection_method=scheme != "monolithic")
    prob = {"kelvinhelmholtz": KelvinHelmholtz, "shear": DoubleLayerShearFlow,
            "taylorgreen": TaylorGreen}[problem](disc)
    if comm is not None:
        stepper.distribute(comm, device, tracer=tracer)
    return stepper, prob


def tracer0(x, y):
    return torch.sin(2 * math.pi * x) * torch.sin(2 * math.pi * y)


def run_case(case, comm=None, device="cpu"):
    """States (Q, p[, tracer]) gathered after each step, each step's
    iteration counts and (distributed) collective counts."""
    stepper, prob = make(case, comm, device)
    dt, steps, tracer = case[3], case[4], case[5]
    f_rhs = prob.f_rhs()
    out = {"states": [], "counts": [], "collectives": []}
    imex = isinstance(stepper, hdg_imex.IncompressibleEulerHDGIMEX)
    facets = isinstance(stepper, IncompressibleEulerConformingImplicit)  # RT dofs
    with capped(CAP):
        if imex:
            state = stepper.initial_state(*prob.initial_condition())
        else:
            state = stepper.initial_fields(*prob.initial_condition())
        q = stepper.initial_tracer(tracer0) if tracer else None
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
                if q is not None:
                    q = tracer_step(stepper.geom, q, stepper.output_fields(*state)[0], dt,
                                    cg_space=stepper.tracer_cg_space())
                Q, p, counts = stepper.advance(*state, stepper.forcing(f_rhs(k * dt)))
                state = (Q, p)
            if comm is not None:
                out["collectives"].append(dict(comm.counts))
            out["counts"].append({k_: v for k_, v in counts.items() if k_ != "max_relres"})
            out["states"].append((stepper.gather(Q, facets=facets), stepper.gather(p)) +
                                 ((stepper.gather(q),) if q is not None else ()))
    return out


def job(comm, device, cases):
    """Every case of ``cases`` on this rank; rank 0's results (the other
    ranks' collective counts only)."""
    res = {c: run_case(c, comm=comm, device=device) for c in cases}
    if comm.rank:
        return {c: {"collectives": v["collectives"]} for c, v in res.items()}
    return res


def operator_job(comm, device, case, seed=5):
    """On one rank of a partition of ``case``'s mesh: the ghost entries of
    every plan after ``Comm.ghosts`` against the global arrays, and the
    rank's part of a trace matvec, a GTMG application, a tentative matvec
    and a symmetric colored sweep on seeded global inputs (the parent
    compares the gathered results with the global operators)."""
    stepper, _ = make(case)
    disc = stepper.disc
    mesh = disc.mesh
    dec = Partition(disc, stepper, comm.size, comm.rank, comm=comm, device=device)
    rng = np.random.default_rng(seed)
    nt = stepper._cs.nt
    nc, nf = mesh.n_cells, mesh.n_facets
    cell_g = torch.as_tensor(rng.standard_normal((3, nc)))
    facet_g = torch.as_tensor(rng.standard_normal((3, nf)))
    cm, fm = dec.cell_maps[comm.rank], dec.facet_maps[comm.rank]
    ghosts_ok = {}
    for name, plan, glob, own in (("cells", dec.cell_plan, cell_g, cm),
                                  ("facets", dec.facet_plan, facet_g, fm),
                                  ("star", dec.pc.part.star_plan, facet_g, fm)):
        if plan is None:
            continue
        ext = comm.ghosts(plan, glob[:, own])
        ghosts_ok[name] = (bool(torch.equal(ext[:, :plan.n_owned], glob[:, own])) and
                           bool(torch.equal(ext[:, plan.n_owned:],
                                            glob[:, torch.as_tensor(plan.ghost_ids)])))
    lam = torch.as_tensor(rng.standard_normal((nt, nf)))
    Q = torch.as_tensor(rng.standard_normal((2, disc.geom.d1, nc)))
    ub = torch.as_tensor(rng.standard_normal((2 * disc.geom.d1, nc)))
    geom = dec.geom
    star = star_fields(geom, dec.scatter_cell_field(Q))
    op = P.build_tentative_operator(geom, star, 0.01)
    ubl = dec.scatter_cell_field(ub)
    out = {
        "ghosts": ghosts_ok,
        "trace_matvec": dec.gather_facet_field(trace_matvec(geom, dec.cs, lam[:, fm])),
        "gtmg": dec.gather_facet_field(
            gtmg_apply(geom, dec.cs, dec.pc, lam[:, fm].reshape(-1)).reshape(nt, -1)),
        "tentative_matvec": dec.gather_cell_field(P._matvec_bl(geom, op, ubl)),
        "sweep": dec.gather_cell_field(P._colored_apply_bl(geom, op, ubl, symmetric=True)),
    }
    return out if comm.rank == 0 else None


def global_operators(case, seed=5):
    """The global (one-device) counterparts of :func:`operator_job`'s
    operator results on the same seeded inputs."""
    stepper, _ = make(case)
    disc = stepper.disc
    geom, mesh = disc.geom, disc.mesh
    rng = np.random.default_rng(seed)
    rng.standard_normal((3, mesh.n_cells))
    rng.standard_normal((3, mesh.n_facets))
    nt = stepper._cs.nt
    lam = torch.as_tensor(rng.standard_normal((nt, mesh.n_facets)))
    Q = torch.as_tensor(rng.standard_normal((2, geom.d1, mesh.n_cells)))
    ub = torch.as_tensor(rng.standard_normal((2 * geom.d1, mesh.n_cells)))
    op = P.build_tentative_operator(geom, star_fields(geom, Q), 0.01)
    if geom.shift is None:
        sweep = P._colored_apply_bl(geom, op, ub, symmetric=True)
    else:  # the fused sweep of the factored tables: the same patches, colours, order
        sweep = P._colored_apply_fused_bl(geom, op, ub)[0]
    return {
        "trace_matvec": trace_matvec(geom, stepper._cs, lam),
        "gtmg": gtmg_apply(geom, stepper._cs, stepper._gtmg, lam.reshape(-1)).reshape(nt, -1),
        "tentative_matvec": P._matvec_bl(geom, op, ub),
        "sweep": sweep,
    }
