"""DG implicit solver: the [DG(k+1)]^2 x DG(k) coupled velocity-pressure system.

Counterpart of incompressibleeulerhdg_tpu/timesteppers/dg_implicit.py
(the loop, the tracer, the checkpoint and the slab-decomposed run are the
base class's).  Per timestep:

  1. Q* = project_bdm(Q); star fields; the tentative operator's blocks
     (M - dt f_impl(., Q*), built with the Gauss-Jordan kernel);
  2. FGMRES (restart 20, at most 100 iterations, rtol 10 rtol_pressure) on
     the coupled system

         [ M - dt f_impl   -dt g_DG ] [Q]   [M (Q + dt f)]
         [ dt weak_div        0     ] [p] = [     0      ]

     from the old (Q, p), with the constant-pressure null vector projected
     out, preconditioned by one projection cycle: a tentative solve (rtol
     1e-6, at most 60 iterations) and an HDG mixed-Poisson pressure solve
     (rtol 1e-6, at most 60), Q = dQ~ + dt du;
  3. p shifted to zero mean.

The momentum block is applied through the assembled blocks (the factored
kernels on structured meshes); the pressure coupling is
``ops.forms.pressure_gradient_dg_apply``.
"""

import torch

from .common import IncompressibleEuler
from ..ops import fields as F
from ..ops.forms import pressure_gradient_dg_apply, star_fields, weak_divergence_apply
from ..ops.projection import project_bdm
from ..linalg.condense import build_condensed_system
from ..linalg.gtmg import build_gtmg, gtmg_apply
from ..linalg.krylov import fgmres, pdot, pnorm
from ..ops.structured import dist_axis
from ..linalg.pressure import pressure_solve
from ..linalg.preconditioners import build_tentative_operator, tentative_operator_matvec
from ..linalg.tentative import tentative_solve

__all__ = ["IncompressibleEulerDGImplicit"]


class IncompressibleEulerDGImplicit(IncompressibleEuler):
    """Implicit DG scheme.

    :arg disc: HDGDiscretisation
    :arg dt: timestep size
    :arg flux: "upwind" or "centered"
    :arg callbacks: per-timestep callbacks
    """

    def __init__(self, disc, dt, flux="upwind", callbacks=None):
        super().__init__(disc, dt, label="DG Implicit", callbacks=callbacks)
        if flux not in ("upwind", "centered"):
            raise ValueError(f"flux must be 'upwind' or 'centered', got {flux!r}")
        self.flux = flux
        self.upwind = flux == "upwind"
        self.alpha = 1.0  # penalty parameter
        self._cs = build_condensed_system(disc, tau=1.0)
        self._gtmg = build_gtmg(disc, self._cs)

    def _precond(self, v):
        return gtmg_apply(self.geom, self._cs, self._gtmg, v)

    def _solve_coupled(self, t_op, b_u, Q0, p0):
        """FGMRES on the coupled (u, p) system from (Q0, p0); returns (Q, p,
        iterations)."""
        geom, dt = self.geom, self._dt
        nc, d1, d0 = geom.n_cells, geom.d1, geom.d0
        nu = 2 * d1 * nc

        def flat(u, p):
            return torch.cat([u.reshape(-1), p.reshape(-1)])

        def unflat(v):
            return v[:nu].reshape(2, d1, nc), v[nu:].reshape(d0, nc)

        def matvec(v):
            u, p = unflat(v)
            r_u = tentative_operator_matvec(geom, t_op, u) - dt * pressure_gradient_dg_apply(geom, p)
            return flat(r_u, dt * weak_divergence_apply(geom, u))

        def M(v):
            r_u, r_p = unflat(v)
            dQt, _, _ = tentative_solve(geom, t_op, r_u, rtol=1e-6, maxiter=60)
            f_p = (-1.0 / dt) * weak_divergence_apply(geom, dQt) + (1.0 / dt) * r_p
            du, dp, _, _, _ = pressure_solve(
                geom, self._cs, torch.zeros_like(r_u), f_p,
                r_u.new_zeros((self._cs.nt, geom.n_facets)), rtol=1e-6, maxiter=60,
                precond=self._precond)
            return flat(dQt + dt * du, dp)

        comm = dist_axis(geom)
        ones_p = b_u.new_ones((d0, nc))
        if geom.cvalid is not None:  # not the dummy cells of an uneven slab split
            ones_p = ones_p * geom.cvalid
        nullv = flat(b_u.new_zeros((2, d1, nc)), ones_p)
        nullv = nullv / pnorm(nullv, comm)

        def project(v):
            return v - nullv * pdot(nullv, v, comm)

        x, iters, _ = fgmres(matvec, flat(b_u, b_u.new_zeros((d0, nc))), M=M, x0=flat(Q0, p0),
                             rtol=10 * self.rtol_pressure, restart=20, maxiter=100,
                             project=project, comm=comm)
        return (*unflat(x), iters)

    def advance(self, Q, p, f_nodal):
        """One timestep from (Q, p) with the forcing ``f_nodal`` at its start
        time.  Returns (Q, p, {"fgmres": [iterations]})."""
        geom, dt = self.geom, self._dt
        star = star_fields(geom, project_bdm(geom, self._proj, Q))
        b_u = F.mass_apply(geom, geom.m1, Q + dt * f_nodal)
        t_op = build_tentative_operator(geom, star, dt, self.alpha, self.upwind)
        Q_new, p_new, iters = self._solve_coupled(t_op, b_u, Q, p)
        return Q_new, self.shift_pressure(p_new), {"fgmres": [iters]}
