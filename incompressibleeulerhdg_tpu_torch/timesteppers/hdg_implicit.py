"""First-order HDG solver: Chorin projection method (and monolithic variant).

Counterpart of incompressibleeulerhdg_tpu/timesteppers/hdg_implicit.py
(the loop, the tracer, the checkpoint and the slab-decomposed run are the
base class's).  Per timestep:

  1. Q* = project_bdm(Q)
  projection:
  2a. tentative velocity: (M - dt f_impl(., Q*)) Q~ = M Q + dt M f
  2b. HDG mixed-Poisson pressure correction with rhs -(1/dt) (psi, div Q~)_dx
      (volume term only)
  2c. Q <- Q~ + dt u'
  monolithic:
  2.  the coupled (u, p, lambda) system by FGMRES (linalg/monolithic.py)
  3. p <- phi, shifted to zero mean
"""

from .common import IncompressibleEuler
from ..ops import fields as F
from ..ops.forms import star_fields
from ..ops.projection import project_bdm
from ..linalg.condense import build_condensed_system
from ..linalg.gtmg import build_gtmg, gtmg_apply
from ..linalg.monolithic import monolithic_stage_solve
from ..linalg.pressure import pressure_solve
from ..linalg.preconditioners import build_tentative_operator
from ..linalg.tentative import tentative_solve

__all__ = ["IncompressibleEulerHDGImplicit"]


class IncompressibleEulerHDGImplicit(IncompressibleEuler):
    """First-order-in-time HDG solver (projection or monolithic).

    :arg disc: HDGDiscretisation
    :arg dt: timestep size
    :arg flux: "upwind" or "centered"
    :arg use_projection_method: Chorin projection instead of monolithic solve
    :arg callbacks: per-timestep callbacks
    """

    def __init__(self, disc, dt, flux="upwind", use_projection_method=True, callbacks=None):
        super().__init__(disc, dt, label="HDG Implicit", callbacks=callbacks)
        if flux not in ("upwind", "centered"):
            raise ValueError(f"flux must be 'upwind' or 'centered', got {flux!r}")
        self.flux = flux
        self.upwind = flux == "upwind"
        self.use_projection_method = use_projection_method
        self.alpha = 1.0
        self.tau = 1.0
        self._cs = build_condensed_system(disc, tau=self.tau)
        self._gtmg = build_gtmg(disc, self._cs)

    def _precond(self, v):
        return gtmg_apply(self.geom, self._cs, self._gtmg, v)

    def step(self, Q, p, f_nodal):
        """One timestep from (Q, p) with the forcing ``f_nodal`` at its start
        time.  Returns (Q, p, tentative or FGMRES iterations, pressure or
        FGMRES iterations)."""
        geom, cs, dt = self.geom, self._cs, self._dt
        star = star_fields(geom, project_bdm(geom, self._proj, Q))
        b = F.mass_apply(geom, geom.m1, Q + dt * f_nodal)
        if self.use_projection_method:
            t_op = build_tentative_operator(geom, star, dt, self.alpha, self.upwind)
            Qt, it_tent, _ = tentative_solve(geom, t_op, b, rtol=self.rtol_tentative)
            f_p = (-1.0 / dt) * F.cell_integrate(geom, geom.phi0, F.cell_div(geom, Qt))
            du, p_new, _, it_p, _ = pressure_solve(
                geom, cs, Q.new_zeros(Q.shape), f_p, Q.new_zeros((cs.nt, geom.n_facets)),
                rtol=self.rtol_pressure, precond=self._precond)
            Q_new = Qt + dt * du
        else:
            Q_new, p_new, _, it_tent, it_p = monolithic_stage_solve(
                geom, cs, star, b, dt, precond=self._precond, alpha=self.alpha,
                upwind=self.upwind, rtol=self.rtol_pressure)
        return Q_new, self.shift_pressure(p_new), it_tent, it_p

    def advance(self, Q, p, f_nodal):
        """:meth:`step` with its counts as ``self.step_counts`` keeps them."""
        Q, p, it_tent, it_p = self.step(Q, p, f_nodal)
        return Q, p, dict(tentative=[it_tent], pressure=[it_p])
