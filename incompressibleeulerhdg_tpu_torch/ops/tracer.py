"""Passive tracer advection: upwind DG transport against a DG mass matrix.

Counterpart of incompressibleeulerhdg_tpu/ops/tracer.py.  The advection
form (explicit Euler within a step, the explicit tableau in IMEX):

    adv(chi, q, u) = int_dx q div(chi u)
                     - int_dS (chi+ - chi-) (un+ q+ - un- q-)
    un = (u.n + |u.n|) / 2 per side (upwind flux)

The advecting velocity is first projected onto vector CG(k+1)
(:func:`cg_project_velocity`), as every scheme of the JAX package does.
"""

import torch

from . import fields as F
from ..fem.cg import cg_gather, cg_project_dg

__all__ = ["tracer_advection_apply", "cg_project_velocity", "tracer_step"]


def tracer_advection_apply(geom, q, u):
    """Coefficients of adv(chi, q, u) in the DG(k) tracer test space.

    :arg q: tracer (d0, nc)
    :arg u: advecting velocity (2, d1, nc); the facet fluxes use each side's
        own trace
    """
    # volume: q (u . grad chi + chi div u)
    q_q = F.cell_values(geom.phi0, q)  # (nq, nc)
    u_q = F.cell_values(geom.phi1, u)  # (2, nq, nc)
    divu = F.cell_div(geom, u)  # (nq, nc)
    jinv = geom.jac_inv
    r = 0.0
    for b in (0, 1):
        ua_b = jinv[b, 0][None, :] * u_q[0] + jinv[b, 1][None, :] * u_q[1]
        r = r + torch.einsum("q,qi,qc->ic", geom.wq, geom.gphi0[:, :, b], q_q * ua_b)
    r = geom.det_jac * r
    r = r + F.cell_integrate(geom, geom.phi0, q_q * divu)

    # facet: -(chi+ - chi-)(un+ q+ - un- q-), interior facets only
    q0, q1 = F.facet_traces(geom, geom.tphi0, q)
    u0, u1 = F.facet_traces(geom, geom.tphi1, u)
    n = geom.normal
    un0 = u0[0] * n[0][None, :] + u0[1] * n[1][None, :]
    un1 = -(u1[0] * n[0][None, :] + u1[1] * n[1][None, :])  # the minus side's outward normal
    up0 = 0.5 * (un0 + torch.abs(un0))
    up1 = 0.5 * (un1 + torch.abs(un1))
    flux = (up0 * q0 - up1 * q1) * F.interior_mask(geom)
    return r + F.scatter_facets(geom, geom.tphi0, -flux, flux)


def cg_project_velocity(geom, cg_space, u):
    """Project a DG(k+1) velocity onto vector CG(k+1) and return it in the DG
    nodal layout (2, d1, nc): the CG(k+1) nodes are the DG(k+1) nodes (same
    lattice, same order), so the projection converts back by a gather and
    its facet traces are continuous."""
    x, _ = cg_project_dg(geom, cg_space, u)
    return cg_gather(cg_space, x)


def tracer_step(geom, q, u, dt, cg_space=None):
    """One explicit tracer step: solve M q_new = M q + dt adv(chi, q, u), with
    ``u`` CG-projected first when ``cg_space`` (degree k+1) is given."""
    if cg_space is not None:
        u = cg_project_velocity(geom, cg_space, u)
    b = F.mass_apply(geom, geom.m0, q) + dt * tracer_advection_apply(geom, q, u)
    return F.mass_solve(geom, geom.m0inv, b)
