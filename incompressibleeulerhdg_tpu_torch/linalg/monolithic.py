"""Monolithic coupled (u, p, lambda) stage solve.

Counterpart of incompressibleeulerhdg_tpu/linalg/monolithic.py
(``coupled_matvec``, ``monolithic_stage_solve``).  FGMRES runs on the
unsplit stage system with one approximate projection cycle as the
preconditioner:

    tentative solve   (M - c f_impl) dQ~ = r_u
    mixed-Poisson     rhs (-1/c) weak_div(psi, dQ~) + r_p rows, r_lam rows
    delta = (dQ~ + c du, dp, dlam)

The constant-pressure nullspace (0, 1_p, 1_lam) is deflated from the
right-hand side and every operator output.  The JAX package's host-composed
variant for 16 GB TPUs (``build_monolithic_phases``, ``host_fgmres``) is not
ported: the eager FGMRES here already keeps only the bases and one
preconditioner application on the device.
"""

import torch

from ..ops import fields as F
from ..ops.forms import f_impl_apply, gamma_apply, pressure_gradient_apply, weak_divergence_apply
from ..ops.structured import dist_axis
from .krylov import fgmres, pdot, pnorm
from .preconditioners import build_tentative_operator, tentative_operator_matvec
from .pressure import pressure_solve
from .tentative import tentative_solve

__all__ = ["coupled_matvec", "monolithic_stage_solve"]


def coupled_matvec(geom, star, Q, p, lam, c, alpha=1.0, upwind=True, tau=1.0):
    """Apply the monolithic stage operator from the weak forms:

    r_u   = M Q - c f_impl(Q, Q*) - c g(p, lam)
    (r_p, r_lam) = Gamma(Q, p, lam)
    """
    r_u = (F.mass_apply(geom, geom.m1, Q)
           - c * f_impl_apply(geom, star, Q, alpha, upwind)
           - c * pressure_gradient_apply(geom, p, lam))
    r_p, r_lam = gamma_apply(geom, Q, p, lam, tau)
    return r_u, r_p, r_lam


def monolithic_stage_solve(geom, cs, star, b_u, c, *, precond, alpha=1.0, upwind=True,
                           rtol=1.0e-11, inner_rtol=1.0e-6, x0=None, restart=20,
                           maxiter=100):
    """Solve the coupled stage system with ``b_u`` on the u-rows and 0 on the
    Gamma rows, from ``x0 = (Q, p, lam)`` (default 0).

    :arg precond: flat-vector trace preconditioner of the inner pressure
        solves (GTMG)
    :returns: (Q, p, lam, fgmres iters, fgmres iters)
    """
    dtype, dev = b_u.dtype, b_u.device
    nc, d1 = geom.n_cells, geom.d1
    d0, nf, nt = geom.d0, geom.n_facets, cs.nt
    nu = 2 * d1 * nc
    np_ = d0 * nc
    c = float(c)

    def flat(u, p, lam):
        return torch.cat([u.reshape(-1), p.reshape(-1), lam.reshape(-1)])

    def unflat(v):
        return (v[:nu].reshape(2, d1, nc), v[nu:nu + np_].reshape(d0, nc),
                v[nu + np_:].reshape(nt, nf))

    t_op = build_tentative_operator(geom, star, c, alpha, upwind)
    comm = dist_axis(geom)

    def matvec(v):
        u, p, lam = unflat(v)
        # u-rows through the assembled blocks (the same operator as the weak
        # form, far cheaper per Krylov iteration)
        r_u = tentative_operator_matvec(geom, t_op, u) - c * pressure_gradient_apply(geom, p, lam)
        r_p, r_lam = gamma_apply(geom, u, p, lam, cs.tau)
        # slab-local layouts: gamma_apply's mu-rows treat the dummy facet
        # positions as boundary facets; keep every dummy entry zero, or it
        # enters the summed inner products
        if geom.fvalid is not None:
            r_lam = r_lam * geom.fvalid
        if geom.cvalid is not None:
            r_u, r_p = r_u * geom.cvalid, r_p * geom.cvalid
        return flat(r_u, r_p, r_lam)

    def M(v):
        r_u, r_p, r_lam = unflat(v)
        dQt, _, _ = tentative_solve(geom, t_op, r_u, rtol=inner_rtol, maxiter=60)
        f_p = (-1.0 / c) * weak_divergence_apply(geom, dQt) + r_p
        du, dp, dlam, _, _ = pressure_solve(geom, cs, torch.zeros_like(r_u), f_p, r_lam,
                                            rtol=inner_rtol, maxiter=60, precond=precond)
        return flat(dQt + c * du, dp, dlam)

    # the (0, 1_p, 1_lam) null vector, without the dummy slots of a
    # slab-local layout, unit in the global norm
    ones_p = torch.ones((d0, nc), dtype=dtype, device=dev)
    ones_lam = torch.ones((nt, nf), dtype=dtype, device=dev)
    if geom.cvalid is not None:
        ones_p = ones_p * geom.cvalid
    if geom.fvalid is not None:
        ones_lam = ones_lam * geom.fvalid
    nullv = flat(torch.zeros((2, d1, nc), dtype=dtype, device=dev), ones_p, ones_lam)
    nullv = nullv / pnorm(nullv, comm)

    def project(v):
        return v - nullv * pdot(nullv, v, comm)

    b = flat(b_u, b_u.new_zeros((d0, nc)), b_u.new_zeros((nt, nf)))
    x, iters, _ = fgmres(matvec, b, M=M, x0=None if x0 is None else flat(*x0), rtol=rtol,
                         restart=restart, maxiter=maxiter, project=project, comm=comm)
    Q, p, lam = unflat(x)
    return Q, p, lam, iters, iters
