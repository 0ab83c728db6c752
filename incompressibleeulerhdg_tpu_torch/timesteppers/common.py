"""Timestepper base: shared FEM operations of the schemes (single device).

Counterpart of incompressibleeulerhdg_tpu/timesteppers/common.py, with the
checkpoint of the plain (Q, p) state through the port's copy of the numpy
checkpoint format (``utils/checkpoint.py``; the files are interchangeable
between the two packages).
"""

import numpy as np
import torch

from ..ops import fields as F
from ..ops.projection import build_bdm_projection, project_bdm
from ..utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["IncompressibleEuler"]


class IncompressibleEuler:
    """Base class of the timesteppers.

    :arg disc: HDGDiscretisation (mesh + degree + dtype + device)
    :arg dt: timestep size
    :arg label: name of the timestepping method
    """

    def __init__(self, disc, dt, label=None):
        self.disc = disc
        self.geom = disc.geom
        self.degree = disc.degree
        self._dt = float(dt)
        self._label = label
        self.domain_volume = disc.domain_volume
        self._proj = build_bdm_projection(disc)

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
        """Shift pressure to zero mean."""
        return p - self.pressure_mean(p)

    def _checkpoint_config(self):
        """Run-defining config validated on resume (mesh/scheme/dt guard)."""
        return {
            "scheme": type(self).__name__,
            "n_cells": int(self.geom.n_cells),
            "degree": int(self.degree),
            "dt": float(self._dt),
        }

    def save_state(self, checkpoint_path, k, state):
        """Atomically save ``state`` (name -> tensor or list of tensors) after
        step ``k``."""
        host = {name: [to_host(a) for a in v] if isinstance(v, list) else to_host(v)
                for name, v in state.items()}
        save_checkpoint(checkpoint_path, host, t=k * self._dt, config=self._checkpoint_config())

    def resume_state(self, checkpoint_path):
        """Load a state saved by :meth:`save_state`; the stored config must
        match this run's mesh/scheme/dt.  Returns (state with tensors on the
        discretisation's device, the step it was saved after)."""
        state, t_ck, _ = load_checkpoint(checkpoint_path,
                                         expect_config=self._checkpoint_config())
        k_start = int(round(t_ck / self._dt))
        print(f"resumed from {checkpoint_path} at t = {t_ck} (step {k_start})")
        dev = lambda a: torch.as_tensor(np.asarray(a), dtype=self.disc.dtype,
                                        device=self.disc.device)
        return {name: [dev(a) for a in v] if isinstance(v, list) else dev(v)
                for name, v in state.items()}, k_start

    def velocity_error_norm(self, Q, Q_exact):
        """L2 norm of the velocity error."""
        return float(torch.sqrt(F.l2_norm_sq(self.geom, self.geom.phi1, Q - Q_exact)))

    def pressure_error_norm(self, p, p_exact):
        """L2 norm of the pressure error."""
        return float(torch.sqrt(F.l2_norm_sq(self.geom, self.geom.phi0, p - p_exact)))

    @property
    def rtol_pressure(self):
        """Condensed-trace GMRES tolerance, loosened in float32."""
        return 1.0e-12 if self.disc.dtype == torch.float64 else 2.0e-6

    @property
    def rtol_tentative(self):
        """Tentative-velocity GMRES tolerance, loosened in float32."""
        return 1.0e-10 if self.disc.dtype == torch.float64 else 1.0e-6


def to_host(t):
    """Tensor -> host numpy array (checkpoint and VTK output)."""
    return t.detach().cpu().numpy()


def synchronize(t):
    """Wait for the card when ``t`` lies on one (host timers end here)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
