"""The HDG mixed-Poisson pressure solve: condense -> GMRES on traces -> recover.

Counterpart of incompressibleeulerhdg_tpu/linalg/pressure.py: static
condensation (linalg/condense.py), deflated left-preconditioned GMRES
(restart 30, at most 500 iterations by default) on the trace system, back
substitution.  On a distributed geometry the GMRES sums its inner products
over the ranks.  The solve runs under the span ``solve.pressure``
(utils/logging.py).
"""

from ..ops.structured import dist_axis
from ..utils.logging import span
from .condense import trace_matvec, condense_rhs, back_substitute
from .krylov import gmres, deflate_constant

__all__ = ["pressure_solve"]


def pressure_solve(geom, cs, f_u, f_p, f_lam, *, precond, rtol=1.0e-12, restart=30,
                   maxiter=500):
    """Solve the condensed HDG mixed-Poisson system for (u, p, lam).

    :arg f_u: u-row right-hand side (2, d1, nc)
    :arg f_p: psi-row right-hand side (d0, nc)
    :arg f_lam: mu-row right-hand side (nt, nf)
    :arg precond: flat-vector preconditioner of the trace system (GTMG)
    :returns: (u, p, lam, iteration count, final preconditioned relres)
    """
    nt = cs.nt

    def matvec(v):
        return trace_matvec(geom, cs, v.reshape(nt, -1)).reshape(-1)

    with span("solve.pressure"):
        g = condense_rhs(geom, cs, f_u, f_p, f_lam).reshape(-1)
        comm = dist_axis(geom)
        lam_flat, iters, relres = gmres(
            matvec, g, M=precond, rtol=rtol, restart=restart, maxiter=maxiter,
            project=deflate_constant(cs.nullvec.reshape(-1), comm), comm=comm,
        )
        lam = lam_flat.reshape(nt, -1)
        u, p = back_substitute(geom, cs, f_u, f_p, lam)
    return u, p, lam, iters, relres
