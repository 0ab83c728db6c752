"""Timestepper base: shared FEM operations of the schemes.

Counterpart of incompressibleeulerhdg_tpu/timesteppers/common.py, with the
checkpoint of the plain (Q, p, tracer) state through the port's copy of the
numpy checkpoint format (``utils/checkpoint.py``; the files are
interchangeable between the two packages), the lazily built CG space of the
tracer's velocity projection, and the timestepping loop of the schemes
without stage state (HDG implicit, DG, conforming): each supplies its
initial fields, its forcing and ``advance``; IMEX has its own loop.

:meth:`IncompressibleEuler.distribute` makes a stepper one rank of a
distributed run, on the route the JAX package takes: the slab
decomposition (parallel/slab.py, its ``slab_context``) where the slab
layout splits the mesh and no tracer rides on a scheme without stage
state, else the cell/facet partition (parallel/partition.py, its GSPMD
sharding).  Its tables become its part's, its fields are the part's
entries, and the state is gathered to rank 0 only for a checkpoint, the
callbacks and the result of :meth:`solve`.
"""

import numpy as np
import torch

from ..ops import fields as F
from ..ops.projection import build_bdm_projection, project_bdm
from ..ops.tracer import tracer_step
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import PerformanceLog

__all__ = ["IncompressibleEuler"]


class IncompressibleEuler:
    """Base class of the timesteppers.

    :arg disc: HDGDiscretisation (mesh + degree + dtype + device)
    :arg dt: timestep size
    :arg label: name of the timestepping method
    :arg callbacks: per-timestep callbacks (``utils/callbacks.py``)
    """

    def __init__(self, disc, dt, label=None, callbacks=None):
        self.disc = disc
        self.geom = disc.geom
        self.degree = disc.degree
        self._dt = float(dt)
        self._label = label
        self.callbacks = [] if callbacks is None else callbacks
        self.domain_volume = disc.domain_volume
        self._proj = build_bdm_projection(disc)
        self._cg_space = None
        self.dec = None  # the slab decomposition or partition of a distributed run

    @property
    def label(self):
        """Name of the timestepping method."""
        return self._label

    def get_timesteps(self, t_final, warmup):
        """Number of timesteps; dt must divide t_final."""
        nt = 1 if warmup else int(np.round(t_final / self._dt))
        if not (warmup or abs(nt * self._dt - t_final) < 1.0e-12):
            raise ValueError(f"dt = {self._dt} does not divide t_final = {t_final}")
        return nt

    def project_bdm(self, Q):
        """H(div)-conforming averaging projection."""
        return project_bdm(self.geom, self._proj, Q)

    def pressure_mean(self, p):
        """Integral mean of a DG(k) pressure field (0-d tensor)."""
        return F.integral(self.geom, self.geom.phi0, p) / self.domain_volume

    def shift_pressure(self, p):
        """Shift pressure to zero mean (dummy cells of an uneven slab split
        stay zero)."""
        m = self.pressure_mean(p)
        return p - (m if self.geom.cvalid is None else m * self.geom.cvalid)

    def tracer_cg_space(self):
        """Vector CG(k+1) space of the tracer's advecting-velocity projection,
        built on first use (most runs carry no tracer); a slab's or a
        partition's view of the global space when distributed."""
        if self._cg_space is None:
            from ..fem.cg import build_cg_space

            if self.dec is None:
                self._cg_space = build_cg_space(self.disc, self.degree + 1)
            else:
                self._cg_space = self.dec.local_cg(
                    build_cg_space(self.dec.global_disc, self.degree + 1))
        return self._cg_space

    # ------------------------------------------------------------------
    # distributed runs
    # ------------------------------------------------------------------

    slab = True  # whether the scheme can take the slab decomposition
    slab_tracer = False  # whether it carries a tracer on a slab (IMEX only)
    facet_state = ("stage_lam",)  # state entries that are facet fields

    def takes_slab(self, n, tracer=False):
        """Whether a run over ``n`` ranks takes the slab decomposition (the
        JAX package's choice): the scheme allows it, the slab layout splits
        the mesh ``n`` ways, and a tracer only rides on a scheme that
        carries one there."""
        from ..parallel.slab import slab_supported

        return (self.slab and slab_supported(self.disc.mesh, n)
                and not (tracer and not self.slab_tracer))

    def distribute(self, comm, device, tracer=False):
        """Make this stepper rank ``comm.rank`` of a run over ``comm.size``
        ranks: its geometry, condensed system, BDM projection, GTMG and RT
        tables become its part's tables on ``device`` (built from the
        global ones, which it drops), on the slab decomposition where
        :meth:`takes_slab` holds (``tracer``: the run advects one), else on
        the cell/facet partition."""
        from ..parallel.partition import Partition
        from ..parallel.slab import SlabDecomposition

        route = SlabDecomposition if self.takes_slab(comm.size, tracer) else Partition
        dec = route(self.disc, self, comm.size, comm.rank, comm=comm, device=device)
        self.dec = dec
        self.disc, self.geom = dec.disc, dec.geom
        self._proj, self._cs, self._gtmg = dec.proj, dec.cs, dec.pc
        if getattr(dec, "rt", None) is not None:
            self._rt = dec.rt
        self._cg_space = None

    @property
    def output_disc(self):
        """The discretisation of :meth:`solve`'s result: the global one."""
        return self.disc if self.dec is None else self.dec.global_disc

    @property
    def is_root(self):
        """Whether this process writes outputs (rank 0, or the only one)."""
        return self.dec is None or self.dec.rank == 0

    def gather(self, field, facets=False):
        """The global field from every rank's part, on rank 0 (None on the
        other ranks; a collective); ``field`` itself when not distributed."""
        if self.dec is None or field is None:
            return field
        if facets:
            return self.dec.gather_facet_field(field)
        return self.dec.gather_cell_field(field)

    def initial_tracer(self, q_initial):
        """The tracer interpolated into V_p, or None without a tracer."""
        return None if q_initial is None else self.disc.interpolate_pressure(q_initial)

    def notify(self, Q, p, t, q_tracer, reset=False):
        """Hand the fields at time ``t`` to every callback (``reset`` first at
        the start of a run); gathered to rank 0 when distributed."""
        if not self.callbacks:
            return
        Q, p, q_tracer = self.gather(Q), self.gather(p), self.gather(q_tracer)
        if not self.is_root:
            return
        for callback in self.callbacks:
            if reset:
                callback.reset()
            callback(Q, p, t, q_tracer=q_tracer)

    def _checkpoint_config(self):
        """Run-defining config validated on resume (mesh/scheme/dt guard)."""
        return {
            "scheme": type(self).__name__,
            "n_cells": int(self.output_disc.geom.n_cells),
            "degree": int(self.degree),
            "dt": float(self._dt),
        }

    def save_state(self, checkpoint_path, k, state):
        """Atomically save ``state`` (name -> tensor, list of tensors or None,
        which is left out) after step ``k``; gathered to rank 0, which
        writes it, when distributed (``stage_lam`` is the facet field)."""
        def host(name, a):
            a = self.gather(a, facets=name in self.facet_state)
            return None if a is None else to_host(a)

        state = {name: [host(name, a) for a in v] if isinstance(v, list) else host(name, v)
                 for name, v in state.items() if v is not None}
        if self.is_root:
            save_checkpoint(checkpoint_path, state, t=k * self._dt,
                            config=self._checkpoint_config())

    def resume_state(self, checkpoint_path):
        """Load a state saved by :meth:`save_state`; the stored config must
        match this run's mesh/scheme/dt.  Returns (state with tensors on the
        discretisation's device, the step it was saved after)."""
        state, t_ck, _ = load_checkpoint(checkpoint_path,
                                         expect_config=self._checkpoint_config())
        k_start = int(round(t_ck / self._dt))
        print(f"resumed from {checkpoint_path} at t = {t_ck} (step {k_start})")

        def dev(name, a):
            if self.dec is not None:  # every rank reads its part
                if name in self.facet_state:
                    return self.dec.scatter_facet_field(a)
                return self.dec.scatter_cell_field(a)
            return torch.as_tensor(np.asarray(a), dtype=self.disc.dtype, device=self.disc.device)

        return {name: [dev(name, a) for a in v] if isinstance(v, list) else dev(name, v)
                for name, v in state.items()}, k_start

    def velocity_error_norm(self, Q, Q_exact):
        """L2 norm of the velocity error (of :meth:`solve`'s global result)."""
        geom = self.output_disc.geom
        return float(torch.sqrt(F.l2_norm_sq(geom, geom.phi1, Q - Q_exact)))

    def pressure_error_norm(self, p, p_exact):
        """L2 norm of the pressure error (of :meth:`solve`'s global result)."""
        geom = self.output_disc.geom
        return float(torch.sqrt(F.l2_norm_sq(geom, geom.phi0, p - p_exact)))

    @property
    def rtol_pressure(self):
        """Condensed-trace GMRES tolerance, loosened in float32."""
        return 1.0e-12 if self.disc.dtype == torch.float64 else 2.0e-6

    @property
    def rtol_tentative(self):
        """Tentative-velocity GMRES tolerance, loosened in float32."""
        return 1.0e-10 if self.disc.dtype == torch.float64 else 1.0e-6

    # ------------------------------------------------------------------
    # the loop of the schemes with a plain (Q, p) state
    # ------------------------------------------------------------------

    def initial_fields(self, Q_initial, p_initial):
        """(Q, p) at t = 0 from the initial-condition expressions."""
        Q = self.disc.interpolate_velocity(Q_initial)
        return Q, self.shift_pressure(self.disc.interpolate_pressure(p_initial))

    def forcing(self, fn):
        """The forcing expression ``fn`` in the velocity space of the state."""
        return self.disc.interpolate_velocity(fn)

    def output_fields(self, Q, p):
        """(velocity (2, d1, nc), pressure (d0, nc)) of the state, as the
        tracer, the callbacks, the error norms and the VTK output read it."""
        return Q, p

    def advance(self, Q, p, f):
        """One timestep; returns (Q, p, dict of iteration-count lists)."""
        raise NotImplementedError

    def solve(self, Q_initial, p_initial, q_initial, f_rhs, T_final, warmup=False,
              checkpoint_every=0, checkpoint_path="checkpoint.npz", resume=False):
        """Propagate (Q, p) from the initial expressions to T_final; the
        tracer, when ``q_initial`` is given, takes one explicit step with the
        old velocity before each velocity step.  ``self.step_counts`` keeps
        each step's iteration counts.

        :arg f_rhs: ``t -> ((x, y) -> (fx, fy))`` forcing factory
        :arg warmup: take a single timestep only
        :arg checkpoint_every: save (Q, p, tracer) every N steps (0 = off)
        :arg resume: load ``checkpoint_path`` (validated against this run's
            mesh/scheme/dt) and continue from its step
        :returns: :meth:`output_fields` of the final state (gathered to rank
            0 when distributed; (None, None) on the other ranks)
        """
        dt = self._dt
        nt = self.get_timesteps(T_final, warmup)
        if q_initial is not None and self.dec is not None and not self.slab_tracer:
            from ..parallel.slab import SlabDecomposition

            if isinstance(self.dec, SlabDecomposition):
                raise ValueError(f"the tracer under {self.label} runs on the partition: "
                                 "distribute(comm, device, tracer=True)")
        Q, p = self.initial_fields(Q_initial, p_initial)
        q_tracer = self.initial_tracer(q_initial)
        k_start = 0
        if resume:
            state, k_start = self.resume_state(checkpoint_path)
            Q, p = state["Q"], state["p"]
            if state.get("q_tracer") is not None and q_tracer is not None:
                q_tracer = state["q_tracer"]
        self.notify(*self.output_fields(Q, p), k_start * dt, q_tracer, reset=True)
        self.step_counts = []
        for k in range(k_start, nt):
            with PerformanceLog("timestep"):
                if q_tracer is not None:
                    q_tracer = tracer_step(self.geom, q_tracer, self.output_fields(Q, p)[0], dt,
                                           cg_space=self.tracer_cg_space())
                Q, p, counts = self.advance(Q, p, self.forcing(f_rhs(k * dt)))
                synchronize(Q)
            self.step_counts.append(counts)
            if checkpoint_every and (k + 1) % checkpoint_every == 0:
                self.save_state(checkpoint_path, k + 1, {"Q": Q, "p": p, "q_tracer": q_tracer})
            self.notify(*self.output_fields(Q, p), (k + 1) * dt, q_tracer)
        Q, p = self.output_fields(Q, p)
        return self.gather(Q), self.gather(p)


def to_host(t):
    """Tensor -> host numpy array (checkpoint and VTK output)."""
    return t.detach().cpu().numpy()


def synchronize(t):
    """Wait for the card when ``t`` lies on one (host timers end here)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
