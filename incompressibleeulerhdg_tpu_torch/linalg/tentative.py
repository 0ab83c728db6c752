"""Tentative (advective) velocity solve.

Counterpart of incompressibleeulerhdg_tpu/linalg/tentative.py in its default
mode.  The operator is

    a(u, w) = (w, u) - c * f_impl(w, u, Q*),    c = a_ii * dt

On a structured mesh (square or periodic): right-preconditioned flexible
GMRES whose preconditioner is one symmetric multiplicative colored
facet-pair Schwarz sweep returning ``M v`` together with the exact ``A M v``
(one sweep + one matvec per Arnoldi step).  On the unit disk: left-
preconditioned GMRES with one symmetric colored sweep, a full matvec
between colours (the JAX package's selection, tentative.py:94-101).  Both
sweeps need every cell to carry an interior facet, which holds on every
mesh the port builds but the 1x1 square; they raise otherwise.

A partition-local geometry (parallel/partition.py) of a structured mesh
keeps the single device's method, right-preconditioned GMRES, with the
symmetric sweep of the dense tables (the same patches in the same colour
order; the fused sweep's incremental residuals are its exact ones) and one
explicit matvec for ``A M v``: the distributed solve is the single-device
solve up to the order of the sums, and takes its iterations.  (The JAX
package's GSPMD run takes the left-preconditioned branch there.)
"""

from ..ops.fields import mass_apply
from ..ops.forms import f_impl_apply
from ..ops.structured import dist_axis
from .krylov import gmres, gmres_right
from .preconditioners import _colored_apply_bl, _colored_apply_fused_bl, _matvec_bl

__all__ = ["tentative_matvec", "tentative_solve"]


def tentative_matvec(geom, star, u, c, alpha=1.0, upwind=True):
    """M - c * f_impl(., Q*) from the weak form (reference for the assembled
    operator)."""
    return mass_apply(geom, geom.m1, u) - c * f_impl_apply(geom, star, u, alpha, upwind)


def tentative_solve(geom, op, rhs, *, rtol=1.0e-10, restart=40, maxiter=200):
    """Solve (M - c f_impl) u = rhs with the stage's assembled
    :class:`TentativeOperator` ``op``.  Returns (u (2, d1, nc), iters, relres)."""
    shape = rhs.shape
    nu, nc = shape[0] * shape[1], shape[2]

    def matvec(v):
        return _matvec_bl(geom, op, v.reshape(nu, nc)).reshape(-1)

    comm = dist_axis(geom)
    if geom.shift is not None or (geom.part is not None and geom.part.structured):
        def opM(v):
            if geom.shift is None:
                z = _colored_apply_bl(geom, op, v.reshape(nu, nc), symmetric=True)
                return z.reshape(-1), _matvec_bl(geom, op, z).reshape(-1)
            z, Az = _colored_apply_fused_bl(geom, op, v.reshape(nu, nc))
            return z.reshape(-1), Az.reshape(-1)

        u, iters, relres = gmres_right(opM, matvec, rhs.reshape(-1), rtol=rtol,
                                       restart=restart, maxiter=maxiter, comm=comm)
        return u.reshape(shape), iters, relres

    def M(v):
        return _colored_apply_bl(geom, op, v.reshape(nu, nc), symmetric=True).reshape(-1)

    u, iters, relres = gmres(matvec, rhs.reshape(-1), M=M, rtol=rtol, restart=restart,
                             maxiter=maxiter, comm=comm)
    return u.reshape(shape), iters, relres
