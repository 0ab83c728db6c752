"""Timestepper base: shared FEM operations of the schemes (single device).

Counterpart of incompressibleeulerhdg_tpu/timesteppers/common.py.
"""

import numpy as np
import torch

from ..ops import fields as F
from ..ops.projection import build_bdm_projection, project_bdm

__all__ = ["IncompressibleEuler"]


class IncompressibleEuler:
    """Base class of the timesteppers.

    :arg disc: HDGDiscretisation (mesh + degree + dtype + device)
    :arg dt: timestep size
    """

    def __init__(self, disc, dt):
        self.disc = disc
        self.geom = disc.geom
        self.degree = disc.degree
        self._dt = float(dt)
        self.domain_volume = disc.domain_volume
        self._proj = build_bdm_projection(disc)

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
