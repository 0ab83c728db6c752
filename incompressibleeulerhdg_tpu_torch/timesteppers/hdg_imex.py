"""HDG IMEX timesteppers: projection (Richardson) and monolithic stage solves.

Counterpart of incompressibleeulerhdg_tpu/timesteppers/hdg_imex.py.  Per
timestep:

- evaluate the forcing at the stage times;
- for each stage i = 1..s-1: BDM-project the previous stage velocity and
  build the star fields, then either (projection) build the stage's
  tentative operator and run ``n_richardson`` sweeps of (tentative GMRES
  solve -> condensed-trace pressure solve -> increment), or (monolithic)
  solve the coupled (u, p, lambda) stage system by FGMRES from the carried
  stage state (linalg/monolithic.py); shift the stage pressure to zero mean;
- final-stage mixed solve from the unrolled final residual;
- pressure reconstruction from the new velocity.

With a tracer, each stage advects the tableau-combined tracer stages with
that stage's own CG-projected velocity, and the final tracer sums every
stage's flux, each with its own stage velocity, as the JAX package does.

After :meth:`distribute` the same step runs on a slab's tables
(parallel/slab.py) or a partition's (parallel/partition.py), one rank per
part; :meth:`solve` then gathers the state to rank 0 at a checkpoint, for
the callbacks and at the end.

The stage loop is a Python loop on eager tensors; on one card each
application of the GTMG V-cycle and of the tentative solve's fused sweep
replays CUDA graphs (``krylov.graphed``).  Iteration counts of every
solve are returned by :meth:`step` and averaged by :meth:`solve`, which also
checkpoints and resumes the full stage state (and the tracer), hands each
step's fields to the callbacks, and warns of a non-finite Krylov residual
and of a projection run that stalled above its tolerance.

The JAX package's environment knobs, each read where the JAX package reads
it, so that one environment means one computation in both packages:

- ``IEHDG_TENT_RESTART`` (default 28), ``IEHDG_TENT_SWEEPS`` (1) and
  ``IEHDG_TENT_SYM`` (1): read in ``__init__`` into ``tentative_restart``,
  ``tentative_sweeps`` and ``tentative_symmetric`` (hdg_imex.py:118-125)
  and passed to every tentative solve of the Richardson sweep; a forward
  sweep (``SYM=0``) visits each colour once (K3 ``ncol`` times instead of
  ``2 ncol - 1``), a second sweep doubles the K1-K3 launches of an
  application;
- ``IEHDG_TENT_FUSED`` (linalg/tentative.py) and ``IEHDG_FACT``
  (linalg/preconditioners.py): read at every solve and every stage build;
  ``FUSED=0`` takes the left-preconditioned composition (K1, K2 in the
  matvec between colours), ``FACT=0`` dense tables on a structured mesh
  (``einsum``s; K4, or K5 from k = 4, alone);
- ``IEHDG_LAG_PC=1``: read at every step; on the projection path a stage
  whose a_ii equals the previous stage's reuses that stage's patch factors
  (``build_tentative_operator(reuse_factors=...)``, hdg_imex.py:621-666),
  so its build launches no Gauss-Jordan kernel (SSP2(3,3,2) never lags;
  ARS2(2,3,2), ARS3(4,4,3) and SSP3(4,3,3) build once a step).  The JAX
  package honours it only in its composite step, above
  ``COMPOSITE_STEP_CELLS`` = 100,000 cells (hdg_imex.py:141-172); this
  single host loop is the composite step's analogue, so the port honours
  it on every mesh of one rank;
- ``IEHDG_PHASE_TIMING=1``: read at every step, on one rank; the wall
  clock of each phase, ended by ``torch.cuda.synchronize()`` on the card,
  goes into ``PerformanceLog`` under the JAX labels "forcing",
  "star+build", "residual", "sweep", "monolithic", "final", "reconstruct"
  (each interval runs from the end of the previous one, as
  hdg_imex.py:586-604 does).  The same switch records the step's other
  spans (utils/logging.py), each its own host seconds with no synchronise:
  "step", "bdm_projection" and "tentative_build" inside "star+build",
  "solve.tentative" and "solve.pressure" around every solve,
  "krylov.precond", "krylov.matvec" and "krylov.orthogonalise" in the
  Krylov loops, and "host.read" around each blocking read of the card.
  While torch.profiler records, every span, phases included, is in its
  trace as ``iehdg.<label>``, whether the switch is on or not.

- ``IEHDG_PC_BF16=1``: read at every step, in float32 only (ignored in
  float64, as hdg_imex.py:204-213): each stage build of the projection path
  stores the patch factors ``Dinv0`` and ``Sinv`` in bfloat16
  (``build_tentative_operator(pc_dtype=torch.bfloat16)``), on every mesh
  and every route, and K3/K3w launch their bfloat16-factor variants.

Over ranks (:meth:`distribute`) the JAX package runs its fused step, which
reads the restart, sweeps, symmetry, fused, factored and bfloat16 knobs
and ignores the lag and the phase timing; so does the port.
``IEHDG_TENT_FUSED=2`` takes the sweep's free ``A z`` wherever the fused
sweep runs (linalg/tentative.py).
"""

import os
import time
import warnings
from functools import partial

import numpy as np
import torch

from .common import IncompressibleEuler, synchronize
from .tableaus import TABLEAUS, unroll_residual_coefficients
from ..utils.logging import PerformanceLog, Averager, span, step_spans
from ..ops import fields as F
from ..ops.forms import (
    star_fields,
    f_impl_apply,
    pressure_gradient_apply,
    weak_divergence_apply,
    reconstruct_trace_rhs,
)
from ..ops.projection import project_bdm
from ..ops.reconstruction import pressure_reconstruction_rhs
from ..ops.tracer import cg_project_velocity, tracer_advection_apply
from ..linalg.condense import build_condensed_system
from ..linalg.gtmg import build_gtmg, gtmg_apply
from ..linalg.krylov import graphed
from ..linalg.pressure import pressure_solve
from ..linalg.tentative import tentative_solve
from ..linalg.preconditioners import build_tentative_operator
from ..linalg.monolithic import monolithic_stage_solve

__all__ = [
    "IncompressibleEulerHDGIMEX",
    "IncompressibleEulerHDGIMEXImplicit",
    "IncompressibleEulerHDGIMEXARS2_232",
    "IncompressibleEulerHDGIMEXARS3_443",
    "IncompressibleEulerHDGIMEXSSP2_332",
    "IncompressibleEulerHDGIMEXSSP3_433",
]


TENTATIVE_RESTART = 28
ALPHA_PENALTY = 1.0
TAU = 1.0


class IncompressibleEulerHDGIMEX(IncompressibleEuler):
    """IMEX timestepper parameterised by a Butcher tableau.

    :arg disc: HDGDiscretisation
    :arg dt: timestep size
    :arg flux: "upwind" or "centered"
    :arg use_projection_method: Richardson + projection instead of monolithic
    :arg n_richardson: number of Richardson iterations
    :arg label: name of the method (default: the tableau's)
    :arg callbacks: per-timestep callbacks
    """

    tableau_name = None  # set by subclasses

    def __init__(self, disc, dt, flux="upwind", use_projection_method=True, n_richardson=2,
                 label=None, callbacks=None):
        tab = self.tableau = TABLEAUS[self.tableau_name]
        super().__init__(disc, dt, label or tab.label, callbacks=callbacks)
        if flux not in ("upwind", "centered"):
            raise ValueError(f"flux must be 'upwind' or 'centered', got {flux!r}")
        self.flux = flux
        self.upwind = flux == "upwind"
        self.use_projection_method = use_projection_method
        self.n_richardson = n_richardson
        self.tau = TAU
        alpha, beta, alpha_f, beta_f = unroll_residual_coefficients(tab)
        t = lambda a: torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
        self._alpha, self._beta = t(alpha), t(beta)
        self._alpha_f, self._beta_f = t(alpha_f), t(beta_f)
        self._cs = build_condensed_system(disc, tau=self.tau)
        self._gtmg = build_gtmg(disc, self._cs)
        self._graphs = {}  # the V-cycle's captures, which live as long as its tables
        self._graphed_vcycle = graphed(partial(gtmg_apply, self.geom, self._cs, self._gtmg),
                                       self._graphs, ("gtmg", self._gtmg.coarse_kind))
        self.tentative_restart = int(os.environ.get("IEHDG_TENT_RESTART", str(TENTATIVE_RESTART)))
        self.tentative_sweeps = int(os.environ.get("IEHDG_TENT_SWEEPS", "1"))
        self.tentative_symmetric = os.environ.get("IEHDG_TENT_SYM", "1") == "1"
        self.niter_tentative = Averager()
        self.niter_pressure = Averager()
        self.niter_final_pressure = Averager()
        self.niter_pressure_reconstruction = Averager()
        self.max_relres = 0.0

    @property
    def nstages(self):
        return self.tableau.nstages

    # ------------------------------------------------------------------
    # phases of one step
    # ------------------------------------------------------------------

    slab_tracer = True

    def distribute(self, comm, device, tracer=False):
        super().distribute(comm, device, tracer)
        for name in ("_alpha", "_beta", "_alpha_f", "_beta_f"):
            setattr(self, name, getattr(self, name).to(device))

    def _shift(self, p, lam):
        """Shift (p, lambda) by the pressure mean; the dummy positions of a
        slab-local layout stay zero."""
        geom = self.geom
        m = F.integral(geom, geom.phi0, p) / self.domain_volume
        mp = m if geom.cvalid is None else m * geom.cvalid
        ml = m if geom.fvalid is None else m * geom.fvalid
        return p - mp, lam - ml

    def _vcycle(self, v):
        return gtmg_apply(self.geom, self._cs, self._gtmg, v)

    def _precond(self, v):
        """The GTMG V-cycle: on one card replayed from its CUDA graphs
        (``krylov.graphed``), on a rank eager (its sums run over the ranks)."""
        return self._vcycle(v) if self.dec is not None else self._graphed_vcycle(v)

    def _pressure_solve(self, f_u, f_p, f_lam):
        return pressure_solve(self.geom, self._cs, f_u, f_p, f_lam,
                              rtol=self.rtol_pressure, precond=self._precond)

    def _forcing(self, f_rhs_fn, tn):
        """Forcing at all stage times: (s, 2, d1, nc)."""
        c_expl = self.tableau.c_expl.tolist()
        return torch.stack([
            self.disc.interpolate_velocity(f_rhs_fn(tn + cj * self._dt)) for cj in c_expl
        ])

    def _weighted(self, coeffs, SQ, b_all):
        """Unrolled (stage or final) residual: M (sum alpha Q + dt sum beta b)."""
        comb = (torch.einsum("s,s...->...", coeffs[0], SQ)
                + self._dt * torch.einsum("s,s...->...", coeffs[1], b_all))
        return F.mass_apply(self.geom, self.geom.m1, comb)

    def _sweep(self, star, op, r_i, Q_i, p_i, lam_i, c):
        """One Richardson iteration: tentative solve -> pressure solve ->
        increment.  The tentative rhs stays in WEAK form (f_impl_apply): the
        assembled matvec differs by float32 assembly rounding and moves the
        Richardson fixed point."""
        geom = self.geom
        b_tent = (r_i - F.mass_apply(geom, geom.m1, Q_i)
                  + c * (f_impl_apply(geom, star, Q_i, ALPHA_PENALTY, self.upwind)
                         + pressure_gradient_apply(geom, p_i, lam_i)))
        dQt, n_t, rr_t = tentative_solve(geom, op, b_tent, rtol=self.rtol_tentative,
                                         restart=self.tentative_restart,
                                         sweeps=self.tentative_sweeps,
                                         symmetric=self.tentative_symmetric)
        f_p = (-1.0 / c) * weak_divergence_apply(geom, dQt)
        du, dp, dlam, n_p, rr_p = self._pressure_solve(
            torch.zeros_like(Q_i), f_p, torch.zeros_like(lam_i))
        dp, dlam = self._shift(dp, dlam)
        return Q_i + dQt + c * du, p_i + dp, lam_i + dlam, n_t, n_p, max(rr_t, rr_p)

    def _reconstruct(self, f_rhs_fn, Q_new, tn):
        """Pressure reconstruction from the new velocity."""
        b_new = self.disc.interpolate_velocity(f_rhs_fn(tn + self._dt))
        f_p, f_lam = pressure_reconstruction_rhs(self.geom, Q_new, b_new)
        _, p_new, lam_new, n_pr, rr_pr = self._pressure_solve(
            torch.zeros_like(Q_new), f_p, f_lam)
        p_new, lam_new = self._shift(p_new, lam_new)
        return p_new, lam_new, n_pr, rr_pr

    def step(self, stage_Q, stage_p, stage_lam, tn, f_rhs_fn):
        """One IMEX timestep from time ``tn`` (a float).

        stage_Q/p/lam: lists (length s) of per-stage states carried over
        between steps; index 0 holds the current solution.  Returns the new
        lists and a dict of iteration counts and the largest Krylov relres.
        """
        timing = os.environ.get("IEHDG_PHASE_TIMING") == "1" and self.dec is None
        with step_spans(timing, self.disc.device) as phase:
            return self._step(stage_Q, stage_p, stage_lam, tn, f_rhs_fn, phase)

    def _step(self, stage_Q, stage_p, stage_lam, tn, f_rhs_fn, phase):
        """:meth:`step` under its spans; ``phase(label)`` opens a phase."""
        geom = self.geom
        s = self.nstages
        dt = self._dt
        a_impl = self.tableau.a_impl
        pc_dtype = torch.bfloat16 if self.disc.dtype == torch.float32 and \
            os.environ.get("IEHDG_PC_BF16") == "1" else None
        lag_pc = os.environ.get("IEHDG_LAG_PC", "0") == "1" and self.dec is None
        stage_Q, stage_p, stage_lam = list(stage_Q), list(stage_p), list(stage_lam)
        with phase("forcing"):
            b_all = self._forcing(f_rhs_fn, tn)
        its_t, its_p, relres = [], [], []
        op_prev, c_prev = None, None
        for i in range(1, s):
            a_ii = float(a_impl[i][i])
            c = a_ii * dt
            with phase("star+build"):
                with span("bdm_projection"):
                    Q_bdm = project_bdm(geom, self._proj, stage_Q[i - 1])
                star = star_fields(geom, Q_bdm)
                if self.use_projection_method:
                    # the patch factors carry over only between equal a_ii
                    # (preconditioners.py:211-227, hdg_imex.py:621-626)
                    reuse = op_prev if lag_pc and a_ii == c_prev else None
                    with span("tentative_build"):
                        op = build_tentative_operator(geom, star, c, ALPHA_PENALTY, self.upwind,
                                                      pc_dtype=pc_dtype, reuse_factors=reuse)
            with phase("residual"):
                r_i = self._weighted((self._alpha[i], self._beta[i]), torch.stack(stage_Q),
                                     b_all)
            Q_i, p_i, lam_i = stage_Q[i], stage_p[i], stage_lam[i]
            if self.use_projection_method:
                for _ in range(self.n_richardson):
                    with phase("sweep"):
                        Q_i, p_i, lam_i, n_t, n_p, rr = self._sweep(star, op, r_i, Q_i, p_i,
                                                                    lam_i, c)
                    its_t.append(n_t)
                    its_p.append(n_p)
                    relres.append(rr)
                op_prev = op if lag_pc else None
                del op
            else:
                with phase("monolithic"):
                    Q_i, p_i, lam_i, n_m, _ = monolithic_stage_solve(
                        geom, self._cs, star, r_i, c, precond=self._precond,
                        alpha=ALPHA_PENALTY, upwind=self.upwind, rtol=10 * self.rtol_pressure,
                        x0=(Q_i, p_i, lam_i))
                its_t.append(n_m)
                its_p.append(n_m)
                relres.append(0.0)
            c_prev = a_ii
            del star
            stage_p[i], stage_lam[i] = self._shift(p_i, lam_i)
            stage_Q[i] = Q_i

        with phase("final"):
            r_fin = self._weighted((self._alpha_f, self._beta_f), torch.stack(stage_Q), b_all)
            Q_new, _, _, n_fp, rr_fp = self._pressure_solve(
                r_fin, r_fin.new_zeros((geom.d0, geom.n_cells)),
                r_fin.new_zeros((self._cs.nt, geom.n_facets)))
        with phase("reconstruct"):
            p_new, lam_new, n_pr, rr_pr = self._reconstruct(f_rhs_fn, Q_new, tn)
        stage_Q[0], stage_p[0], stage_lam[0] = Q_new, p_new, lam_new
        counts = dict(
            tentative=its_t,
            pressure=its_p,
            final_pressure=n_fp,
            reconstruction=n_pr,
            max_relres=max(relres + [rr_fp, rr_pr]),
        )
        return stage_Q, stage_p, stage_lam, counts

    def tracer_step(self, q, SQ):
        """The tracer after one step from ``q``, given the step's stage
        velocities ``SQ`` (the old velocity, then stages 1..s-1).  Stage i
        advects the explicit-tableau combination of the tracer stages with
        stage i's own CG-projected velocity; the final tracer sums every
        stage's flux, each with its own stage velocity."""
        geom, dt, tab = self.geom, self._dt, self.tableau
        s = self.nstages
        u_adv = [cg_project_velocity(geom, self.tracer_cg_space(), Q) for Q in SQ]
        a_expl = torch.as_tensor(tab.a_expl, dtype=q.dtype, device=q.device)
        QS = [q] + [torch.zeros_like(q)] * (s - 1)
        for i in range(1, s):
            q_comb = torch.einsum("s,s...->...", a_expl[i], torch.stack(QS))
            b_q = (F.mass_apply(geom, geom.m0, QS[0])
                   + dt * tracer_advection_apply(geom, q_comb, u_adv[i]))
            QS[i] = F.mass_solve(geom, geom.m0inv, b_q)
        b_q = F.mass_apply(geom, geom.m0, QS[0])
        for w, q_i, u_i in zip(tab.b_expl.tolist(), QS, u_adv):
            b_q = b_q + dt * w * tracer_advection_apply(geom, q_i, u_i)
        return F.mass_solve(geom, geom.m0inv, b_q)

    def _reconstruct_trace(self, Q, p):
        """Facet mass solve for lambda(0): (nt, nf)."""
        geom = self.geom
        rhs = reconstruct_trace_rhs(geom, Q, p, tau=self.tau)
        fac = self.tau * (1.0 + F.interior_mask(geom, 1))  # 2 tau interior, tau boundary
        return torch.einsum("ij,jf->if", geom.mtinv, rhs) / (fac * geom.flen)[None, :]

    def initial_state(self, Q_initial, p_initial):
        """Stage lists at t = 0 from initial-condition expressions."""
        Q0 = self.disc.interpolate_velocity(Q_initial)
        p0 = self.shift_pressure(self.disc.interpolate_pressure(p_initial))
        lam0 = self._reconstruct_trace(Q0, p0)
        s = self.nstages
        return ([Q0] + [torch.zeros_like(Q0)] * (s - 1),
                [p0] + [torch.zeros_like(p0)] * (s - 1),
                [lam0] + [torch.zeros_like(lam0)] * (s - 1))

    def test_pressure_solver(self, seed=123456789):
        """Stand-alone pressure-solver benchmark: seeded random velocity rhs
        b = (f_Q, w) dx, one warm-up solve, one timed solve at rtol 1e-12.
        Returns (seconds, iterations)."""
        geom = self.geom
        rng = np.random.default_rng(seed)
        f_Q = rng.standard_normal((2, geom.d1, self.output_disc.geom.n_cells))
        if self.dec is None:
            f_Q = torch.as_tensor(f_Q, dtype=self.disc.dtype, device=self.disc.device)
        else:
            f_Q = self.dec.scatter_cell_field(f_Q)
        f_u = F.mass_apply(geom, geom.m1, f_Q)
        zp = f_u.new_zeros((geom.d0, geom.n_cells))
        zl = f_u.new_zeros((self._cs.nt, geom.n_facets))

        def solve():
            out = pressure_solve(geom, self._cs, f_u, zp, zl, rtol=1e-12,
                                 precond=self._precond)
            synchronize(out[0])
            return out

        solve()  # warm-up
        t0 = time.perf_counter()
        out = solve()
        return time.perf_counter() - t0, int(out[3])

    def _checkpoint_config(self):
        return {
            "scheme": self.tableau_name,
            "n_cells": int(self.output_disc.geom.n_cells),
            "degree": int(self.degree),
            "dt": float(self._dt),
            "n_richardson": int(self.n_richardson),
            "projection": bool(self.use_projection_method),
        }

    def solve(self, Q_initial, p_initial, q_initial, f_rhs, T_final, warmup=False,
              checkpoint_every=0, checkpoint_path="checkpoint.npz", resume=False):
        """Propagate (Q, p) and, when ``q_initial`` is given, the tracer from
        the initial expressions to T_final; ``self.step_counts`` keeps each
        step's iteration counts.

        :arg q_initial: tracer expression ``(x, y) -> q`` or None
        :arg f_rhs: ``t -> ((x, y) -> (fx, fy))`` forcing factory
        :arg warmup: take a single timestep only
        :arg checkpoint_every: save the full stage state every N steps (0 = off)
        :arg resume: load ``checkpoint_path`` (validated against this run's
            mesh/scheme/dt) and continue from its step
        :returns: (Q, p) final coefficient tensors (gathered to rank 0 when
            distributed; (None, None) on the other ranks)
        """
        n_steps = self.get_timesteps(T_final, warmup)
        stage_Q, stage_p, stage_lam = self.initial_state(Q_initial, p_initial)
        q_tracer = self.initial_tracer(q_initial)
        k_start = 0
        if resume:
            state, k_start = self.resume_state(checkpoint_path)
            stage_Q, stage_p, stage_lam = state["stage_Q"], state["stage_p"], state["stage_lam"]
            if state.get("q_tracer") is not None and q_tracer is not None:
                q_tracer = state["q_tracer"]
        for av in (self.niter_tentative, self.niter_pressure,
                   self.niter_final_pressure, self.niter_pressure_reconstruction):
            av.reset()
        self.max_relres = 0.0
        self.notify(stage_Q[0], stage_p[0], 0.0, q_tracer, reset=True)
        self.step_counts = []
        for k in range(k_start, n_steps):
            with PerformanceLog("timestep"):
                Q_old = stage_Q[0]
                stage_Q, stage_p, stage_lam, counts = self.step(
                    stage_Q, stage_p, stage_lam, k * self._dt, f_rhs)
                if q_tracer is not None:
                    q_tracer = self.tracer_step(q_tracer, [Q_old] + stage_Q[1:])
                synchronize(stage_Q[0])
            self.step_counts.append(counts)
            for n in counts["tentative"]:
                self.niter_tentative.update(n)
            for n in counts["pressure"]:
                self.niter_pressure.update(n)
            self.niter_final_pressure.update(counts["final_pressure"])
            self.niter_pressure_reconstruction.update(counts["reconstruction"])
            r = counts["max_relres"]
            if not np.isfinite(r):  # counts as diverged, and is reported at once
                r = float("inf")
                warnings.warn(f"non-finite Krylov residual at step {k + 1}/{n_steps} — "
                              f"the solve diverged (NaN/Inf state likely)", RuntimeWarning)
            self.max_relres = max(self.max_relres, r)
            if checkpoint_every and (k + 1) % checkpoint_every == 0:
                self.save_state(checkpoint_path, k + 1, {
                    "stage_Q": stage_Q, "stage_p": stage_p, "stage_lam": stage_lam,
                    "q_tracer": q_tracer})
            self.notify(stage_Q[0], stage_p[0], k * self._dt + self._dt, q_tracer)
        print("average number of solver iterations")
        print(40 * "-")
        print(f"  tentative velocity its      : {self.niter_tentative.value:8.2f}")
        if self.use_projection_method:
            print(f"  pressure its                : {self.niter_pressure.value:8.2f}")
            print(f"  final pressure its          : {self.niter_final_pressure.value:8.2f}")
        print(f"  pressure reconstruction its : {self.niter_pressure_reconstruction.value:8.2f}")
        if self.use_projection_method:
            print(f"  max Krylov relative residual: {self.max_relres:8.2e}")
            # a solve that leaves through the stagnation guard above its
            # tolerance is otherwise silent; in float32 the threshold is
            # floored at 1e3 eps, the attainable accuracy of the true
            # residual that the tentative solve reports
            stall_tol = 20.0 * max(self.rtol_pressure, self.rtol_tentative)
            if self.disc.dtype == torch.float32:
                stall_tol = max(stall_tol, 1.0e3 * torch.finfo(torch.float32).eps)
            if self.max_relres > stall_tol:
                warnings.warn(f"Krylov solver stalled above tolerance: max relative residual "
                              f"{self.max_relres:.2e} > {stall_tol:.2e}", RuntimeWarning)
        print()
        return self.gather(stage_Q[0]), self.gather(stage_p[0])


class IncompressibleEulerHDGIMEXImplicit(IncompressibleEulerHDGIMEX):
    """First-order implicit method as IMEX."""

    tableau_name = "imex_implicit"


class IncompressibleEulerHDGIMEXARS2_232(IncompressibleEulerHDGIMEX):
    """ARS2(2,3,2)."""

    tableau_name = "imex_ars2_232"


class IncompressibleEulerHDGIMEXARS3_443(IncompressibleEulerHDGIMEX):
    """ARS3(4,4,3)."""

    tableau_name = "imex_ars3_443"


class IncompressibleEulerHDGIMEXSSP2_332(IncompressibleEulerHDGIMEX):
    """SSP2(3,3,2), the main-path scheme."""

    tableau_name = "imex_ssp2_332"


class IncompressibleEulerHDGIMEXSSP3_433(IncompressibleEulerHDGIMEX):
    """SSP3(4,3,3)."""

    tableau_name = "imex_ssp3_433"
