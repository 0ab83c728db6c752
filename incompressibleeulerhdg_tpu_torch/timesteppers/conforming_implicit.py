"""Conforming RT1 x DG0 implicit solver.

Counterpart of incompressibleeulerhdg_tpu/timesteppers/conforming_implicit.py
(the loop, the tracer, the checkpoint and the distributed run are the base
class's; ``--n_devices`` takes the cell/facet partition on every mesh, as
the JAX package takes its GSPMD sharding: the RT assembly gathers through
index tables the slab layout does not carry).  Velocity: global H(div)-conforming RT dofs, one normal
flux per facet (``ops/rt.py``); pressure: DG0, one value per cell.  Per
timestep, projection branch:

  1. mass solve  M Qhat = (Q,w) + dt [ (f,w) + p div w - (w, (Q.grad)Q)
                                        + advective facet flux ]
     with zero normal flux on the boundary;
  2. the Darcy system [[M, B^T], [B, 0]] (dQ, dphi) = (0, (1/dt) div Qhat)
     by a Schur-complement CG (outer CG on B M^-1 B^T with the constant
     projected out, inner diagonally preconditioned CG mass solves);
  3. Q <- Qhat - dt dQ;  p <- p + dphi;  zero-mean shift.

The monolithic branch (the CLI default) runs FGMRES on the coupled residual,
preconditioned by one mass solve + Darcy correction cycle.

The mass solve asks for rtol 1e-14, as the JAX package does.  In float32
it still stops well before its cap of 200 (24 iterations at 256^2 on an
H100: CG's recursively updated residual keeps falling below the float32
floor of the true one), and the Schur CG nests those solves.
"""

import torch

from .common import IncompressibleEuler
from ..ops import fields as F
from ..ops import rt as RT
from ..linalg.krylov import cg, fgmres, pdot, pnorm
from ..ops.structured import dist_axis

__all__ = ["IncompressibleEulerConformingImplicit"]


class IncompressibleEulerConformingImplicit(IncompressibleEuler):
    """Conforming implicit scheme (RT1 velocity, DG0 pressure).

    :arg disc: HDGDiscretisation of degree 0
    :arg dt: timestep size
    :arg flux: "upwind" or "centered"
    :arg use_projection_method: projection instead of the monolithic solve
    :arg callbacks: per-timestep callbacks
    """

    def __init__(self, disc, dt, flux="upwind", use_projection_method=True, callbacks=None):
        if disc.degree != 0:
            raise ValueError("the conforming scheme uses degree 0 (RT1 x DG0)")
        super().__init__(disc, dt, label="Conforming Implicit", callbacks=callbacks)
        if flux not in ("upwind", "centered"):
            raise ValueError(f"flux must be 'upwind' or 'centered', got {flux!r}")
        self.flux = flux
        self.upwind = flux == "upwind"
        self.use_projection_method = use_projection_method
        self._rt = RT.build_rt_tables(disc)

    slab = False  # the partition on every mesh
    facet_state = ("Q",)  # the RT dofs

    def _mean(self, q):
        """Mean of a cell vector (nc,) over every cell of the mesh."""
        n = self.output_disc.geom.n_cells
        return F.sum_ranks(self.geom, torch.sum(q)) / n

    def _area_mean(self, p):
        """Area-weighted mean of a DG0 pressure (nc,)."""
        return F.sum_ranks(self.geom, torch.sum(p * self._rt.area)) / self.domain_volume

    # ------------------------------------------------------------------
    # the pieces of a step
    # ------------------------------------------------------------------

    def mass_solve(self, b):
        """CG solve of Z M Z g = Z b (boundary dofs pinned to zero); returns
        (g, iterations)."""
        geom, rt = self.geom, self._rt
        Z = rt.int_dof_mask

        def mv(v):
            return Z * RT.rt_mass_apply(geom, rt, Z * v) + rt.bnd_mask * v

        x, iters, _ = cg(mv, Z * b, M=lambda v: rt.mass_diag_inv * v, rtol=1e-14, maxiter=200,
                         comm=dist_axis(geom))
        return x, iters

    def apply_BT(self, phi):
        """B^T phi: dof coefficients of int phi div w."""
        return self._rt.int_dof_mask * RT.rt_div_adjoint(self.geom, self._rt, phi)

    def apply_B(self, g):
        """B g: cell values int div(v) psi = sum_l s_l g_l."""
        geom = self.geom
        return torch.sum(RT.cell_dofs(geom, self._rt.int_dof_mask * g) * geom.cfsign, dim=0)

    def mixed_solve(self, b_p):
        """Schur-complement solve of the Darcy system with rhs (0, b_p).
        Returns (dQ (nf,), dphi (nc,), outer iterations)."""
        rt = self._rt

        def project(q):
            return q - self._mean(q)

        def schur(phi):
            return self.apply_B(self.mass_solve(self.apply_BT(phi))[0])

        phi, iters, _ = cg(schur, project(-b_p), M=lambda v: v * rt.area,
                           rtol=self.rtol_pressure, maxiter=300, project=project,
                           comm=dist_axis(self.geom))
        y, _ = self.mass_solve(self.apply_BT(phi))
        return -y, phi, iters

    def advective_rhs(self, Q):
        """dt [ -(w, (Q.grad)Q) + advective facet flux ] coefficients."""
        geom, rt, dt = self.geom, self._rt, self._dt
        a, _ = RT.rt_cell_coeffs(geom, rt, Q)
        # (Q.grad)Q = a_c Q(x): the gradient of an RT1 field is a_c times the identity
        Qq = RT.rt_eval_cellq(geom, rt, Q)
        r = RT.rt_volume_adjoint(geom, rt, -dt * a[None, None, :] * Qq)
        v0, v1 = RT.rt_facet_values(geom, rt, Q)
        mask = F.interior_mask(geom, 3)
        jump = (v0 - v1) * mask
        qn = torch.einsum("dqf,df->qf", v0, geom.normal)
        if self.upwind:
            # (Q+.n)(jump Q).avg(w) - 1/2 |Q+.n| (jump Q).(jump w)
            G0 = dt * (0.5 * qn[None] * jump - 0.5 * torch.abs(qn)[None] * jump)
            G1 = dt * (0.5 * qn[None] * jump + 0.5 * torch.abs(qn)[None] * jump)
        else:
            # centered: 2 avg((Q.n) Q).avg(w) = (Q+.n)(jump Q).avg(w) for RT
            G0 = dt * 0.5 * qn[None] * jump
            G1 = dt * 0.5 * qn[None] * jump
        return r + RT.rt_facet_adjoint(geom, rt, G0, G1 * mask)

    def monolithic_matvec(self, Qlin, v, phi):
        """The coupled operator linearised about ``Qlin`` on (v, phi)."""
        geom, rt, dt = self.geom, self._rt, self._dt
        Z = rt.int_dof_mask
        aQ, _ = RT.rt_cell_coeffs(geom, rt, Qlin)
        vq = RT.rt_eval_cellq(geom, rt, Z * v)
        # inner(grad Q, outer(v, w)) = a_Q v . w for RT1
        r_v = RT.rt_mass_apply(geom, rt, Z * v) + dt * RT.rt_volume_adjoint(
            geom, rt, aQ[None, None, :] * vq)
        # minus the advective facet flux of v with Q as the advecting field
        q0, _ = RT.rt_facet_values(geom, rt, Qlin)
        w0, w1 = RT.rt_facet_values(geom, rt, Z * v)
        mask = F.interior_mask(geom, 3)
        jmp = (w0 - w1) * mask
        qn = torch.einsum("dqf,df->qf", q0, geom.normal)
        G0 = -dt * 0.5 * qn[None] * jmp
        G1 = -dt * 0.5 * qn[None] * jmp
        if self.upwind:
            G0 = G0 + dt * torch.abs(qn)[None] * jmp
            G1 = G1 - dt * torch.abs(qn)[None] * jmp
        r_v = r_v + RT.rt_facet_adjoint(geom, rt, G0, G1 * mask)
        # - dt phi div w ; psi div v
        r_v = r_v - dt * self.apply_BT(phi)
        return Z * r_v + rt.bnd_mask * v, self.apply_B(v)

    def monolithic_solve(self, Q, p, b_v):
        """FGMRES on the coupled (v, phi) system from (Q, p), preconditioned
        by one mass solve + Darcy correction cycle; returns (Q, p, iterations)."""
        dt = self._dt
        b_v = self._rt.int_dof_mask * b_v
        nf = self.geom.n_facets

        def unflat(x):
            return x[:nf], x[nf:]

        def matvec(x):
            return torch.cat(self.monolithic_matvec(Q, *unflat(x)))

        def M(x):
            r_v, r_p = unflat(x)
            vt, _ = self.mass_solve(r_v)
            # continuity: B(vt - dt dv) = r_p  =>  B dv = (B vt - r_p) / dt
            dv, dphi, _ = self.mixed_solve((1.0 / dt) * (self.apply_B(vt) - r_p))
            return torch.cat([vt - dt * dv, dphi])

        comm = dist_axis(self.geom)
        nullv = torch.cat([b_v.new_zeros(nf), b_v.new_ones(self.geom.n_cells)])
        nullv = nullv / pnorm(nullv, comm)

        def project(x):
            return x - nullv * pdot(nullv, x, comm)

        x, iters, _ = fgmres(matvec, torch.cat([b_v, b_v.new_zeros(self.geom.n_cells)]), M=M,
                             x0=torch.cat([Q, p]), rtol=10 * self.rtol_pressure, restart=20,
                             maxiter=100, project=project, comm=comm)
        return (*unflat(x), iters)

    # ------------------------------------------------------------------
    # the step and the state of the base class's loop
    # ------------------------------------------------------------------

    def advance(self, Q, p, f_dofs):
        """One timestep from the RT dofs Q (nf,) and the DG0 pressure p (nc,)
        with the RT-interpolated forcing ``f_dofs``.  Returns (Q, p, counts):
        the first mass solve's and the Schur CG's iterations (projection),
        or the FGMRES iterations (monolithic)."""
        geom, rt, dt = self.geom, self._rt, self._dt
        MQ_f = RT.rt_mass_apply(geom, rt, Q) + dt * RT.rt_mass_apply(geom, rt, f_dofs)
        if self.use_projection_method:
            b_v = MQ_f + dt * RT.rt_div_adjoint(geom, rt, p) + self.advective_rhs(Q)
            Qhat, it_mass = self.mass_solve(b_v)
            dQ, dphi, it_schur = self.mixed_solve((1.0 / dt) * self.apply_B(Qhat))
            Q_new, p_new = Qhat - dt * dQ, p + dphi
            counts = {"mass": [it_mass], "schur": [it_schur]}
        else:
            Q_new, p_new, iters = self.monolithic_solve(Q, p, MQ_f)
            counts = {"fgmres": [iters]}
        # zero-mean pressure (DG0: area-weighted mean)
        return Q_new, p_new - self._area_mean(p_new), counts

    def initial_fields(self, Q_initial, p_initial):
        """RT dofs of the initial velocity (zero on the boundary) and the
        initial pressure at the cell centroids, shifted to zero mean."""
        rt = self._rt
        Q = RT.rt_interpolate(self.disc, rt, Q_initial) * rt.int_dof_mask
        xc = torch.mean(self.geom.xnodes1, dim=1)  # (2, nc)
        p = torch.as_tensor(p_initial(xc[0], xc[1])).broadcast_to(xc.shape[1:]).to(
            self.disc.dtype)
        return Q, p - self._area_mean(p)

    def forcing(self, fn):
        return RT.rt_interpolate(self.disc, self._rt, fn)

    def output_fields(self, Q, p):
        """(the RT velocity as a DG1 nodal field (2, 3, nc), p as (1, nc))."""
        return self.velocity_dg(Q), p[None, :]

    def velocity_dg(self, Q):
        """RT velocity as a DG1 nodal field (2, 3, nc) for outputs and errors."""
        return RT.rt_to_dg1(self.geom, self._rt, Q)
