"""Tentative (advective) velocity solve.

Counterpart of incompressibleeulerhdg_tpu/linalg/tentative.py.  The operator
is

    a(u, w) = (w, u) - c * f_impl(w, u, Q*),    c = a_ii * dt

The preconditioner, chosen as the JAX package chooses it (tentative.py:86-139):

- ``IEHDG_TENT_FUSED`` unset or ``1`` (read at every solve), on a
  structured mesh (square or periodic): right-preconditioned flexible GMRES
  whose preconditioner is ``sweeps`` multiplicative colored facet-pair
  Schwarz sweeps, each returning ``M v`` together with the exact ``A M v``
  (one sweep + one matvec per Arnoldi step; on one card each application
  replays CUDA graphs, ``krylov.graphed``, kept in ``op.graphs`` for the
  operator's lifetime).  On factored tables a sweep
  runs K3 once per colour it visits (``2 ncol - 1`` symmetric, ``ncol``
  forward only) and K2 once per other colour in each residual update, and
  the matvec runs K1 and K2; on dense tables (``IEHDG_FACT=0``) all of it is
  ``einsum``s.
- ``IEHDG_TENT_FUSED=2``: the same, but each sweep returns the free
  ``A M v = v - r`` of its incremental residual (tentative.py:94-103): the
  last colour's residual update runs like the others' and the matvec goes,
  one K1 and one K2 full-field launch fewer a sweep application.
- ``IEHDG_TENT_FUSED=0``, or the unit disk: left-preconditioned GMRES with
  ``sweeps`` colored sweeps, a full matvec between colours (K1 and K2 on
  factored tables) and, from the second sweep on, a residual correction.
- ``colored=False``: left-preconditioned GMRES with the additive facet-patch
  preconditioner (:func:`preconditioners.tentative_patch_apply`: on
  factored tables K3 once per colour and once on the boundary tail, every
  patch from the same residual).

``sweeps`` and ``symmetric`` are the stepper's ``IEHDG_TENT_SWEEPS`` and
``IEHDG_TENT_SYM`` (timesteppers/hdg_imex.py); the other callers keep one
symmetric sweep.  The sweeps need every cell to carry an interior facet,
which holds on every mesh the port builds but the 1x1 square; they raise
otherwise.

A partition-local geometry (parallel/partition.py) of a structured mesh
keeps the single device's method, right-preconditioned GMRES, with the
sweep of the dense tables (the same patches in the same colour order; the
fused sweep's incremental residuals are its exact ones) and one explicit
matvec for ``A M v``: the distributed solve is the single-device solve up
to the order of the sums, and takes its iterations.  (The JAX package's
GSPMD run takes the left-preconditioned branch there.)  Under
``IEHDG_TENT_FUSED=2`` that route stays as it is, its ``A M v`` exact:
the sweep of the dense tables carries no incremental residual whose
``v - r`` would be free, so mode 2 there is mode 1.
"""

import os

from ..ops.fields import mass_apply
from ..ops.forms import f_impl_apply
from ..ops.structured import dist_axis
from ..utils.logging import span
from .krylov import gmres, gmres_right, graphed
from .preconditioners import (_colored_apply_bl, _colored_apply_fused_bl, _matvec_bl,
                              _patch_apply_bl)

__all__ = ["tentative_matvec", "tentative_solve"]


def tentative_matvec(geom, star, u, c, alpha=1.0, upwind=True):
    """M - c * f_impl(., Q*) from the weak form (reference for the assembled
    operator)."""
    return mass_apply(geom, geom.m1, u) - c * f_impl_apply(geom, star, u, alpha, upwind)


def _fused_mode(fused=None):
    """``fused`` as a string, or ``IEHDG_TENT_FUSED`` (default "1")."""
    return os.environ.get("IEHDG_TENT_FUSED", "1") if fused is None else str(fused)


def tentative_solve(geom, op, rhs, *, rtol=1.0e-10, restart=40, maxiter=200, colored=True,
                    sweeps=1, symmetric=True, fused=None):
    """Solve (M - c f_impl) u = rhs with the stage's assembled
    :class:`TentativeOperator` ``op``.  Returns (u (2, d1, nc), iters, relres).

    :arg sweeps: multiplicative sweeps per preconditioner application
    :arg symmetric: sweep the colours forward, then back
    :arg colored: the multiplicative colored sweep (else the additive
        facet-patch preconditioner)
    :arg fused: override ``IEHDG_TENT_FUSED`` (0: the left-preconditioned
        composition, 1: the fused right-preconditioned GMRES, 2: the same
        with the sweep's free ``A z``)

    Runs under the span ``solve.tentative`` (utils/logging.py).
    """
    with span("solve.tentative"):
        shape = rhs.shape
        nu, nc = shape[0] * shape[1], shape[2]
        mode = _fused_mode(fused)

        def matvec(v):
            return _matvec_bl(geom, op, v.reshape(nu, nc)).reshape(-1)

        comm = dist_axis(geom)
        structured = geom.shift is not None or (geom.part is not None and geom.part.structured)
        if colored and structured and mode in ("1", "2"):
            def sweep(vb):
                if geom.shift is None:
                    z = _colored_apply_bl(geom, op, vb, symmetric=symmetric)
                    return z, _matvec_bl(geom, op, z)
                return _colored_apply_fused_bl(geom, op, vb, symmetric=symmetric,
                                               exact_Az=mode == "1")

            def opM(v):
                vb = v.reshape(nu, nc)
                z, Az = sweep(vb)
                for _ in range(sweeps - 1):
                    dz, Adz = sweep(vb - Az)
                    z, Az = z + dz, Az + Adz
                return z.reshape(-1), Az.reshape(-1)

            if comm is None:  # one card: no collective in the sweep
                kinds = ("tentative", sweeps, symmetric, mode, op.Sown is None, op.Dinv0.dtype)
                opM = graphed(opM, op.graphs, kinds)
            u, iters, relres = gmres_right(opM, matvec, rhs.reshape(-1), rtol=rtol,
                                           restart=restart, maxiter=maxiter, comm=comm)
            return u.reshape(shape), iters, relres

        if colored:
            def M(v):
                rb = v.reshape(nu, nc)
                z = _colored_apply_bl(geom, op, rb, symmetric=symmetric)
                for _ in range(sweeps - 1):
                    z = z + _colored_apply_bl(geom, op, rb - _matvec_bl(geom, op, z),
                                              symmetric=symmetric)
                return z.reshape(-1)
        else:
            def M(v):
                return _patch_apply_bl(geom, op, v.reshape(nu, nc)).reshape(-1)

        u, iters, relres = gmres(matvec, rhs.reshape(-1), M=M, rtol=rtol, restart=restart,
                                 maxiter=maxiter, comm=comm)
        return u.reshape(shape), iters, relres
