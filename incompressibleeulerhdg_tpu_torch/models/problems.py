"""Model problem of the port's main path: the Taylor-Green vortex.

Counterpart of incompressibleeulerhdg_tpu/models/problems.py:TaylorGreen.
Expressions are closures ``(x, y) -> value`` on tensors, evaluated at the DG
nodal points by the discretisation's interpolation.
"""

import math

import torch

from ..ops import fields as F

__all__ = ["TaylorGreen"]


class TaylorGreen:
    """Taylor-Green vortex on the unit square:

        Q_s = (-cos((x-1/2) pi) sin((y-1/2) pi), sin((x-1/2) pi) cos((y-1/2) pi))
        p_s = (sin^2((x-1/2) pi) + sin^2((y-1/2) pi)) / 2

    decaying as exp(-kappa t) under the forcing -kappa exp(-kappa t) Q_s
    (``forcing="exponential"``, the default) or linearly as 1 - kappa t under
    the constant forcing -kappa Q_s (``forcing="constant"``).
    """

    def __init__(self, disc, forcing="exponential", kappa=0.5):
        if forcing not in ("exponential", "constant"):
            raise ValueError("Forcing must be 'constant' or 'exponential'")
        self.disc = disc
        self.forcing = forcing
        self.kappa = kappa

    @staticmethod
    def _Q_stationary(x, y):
        pi = math.pi
        return (
            -torch.cos((x - 0.5) * pi) * torch.sin((y - 0.5) * pi),
            torch.sin((x - 0.5) * pi) * torch.cos((y - 0.5) * pi),
        )

    @staticmethod
    def _p_stationary(x, y):
        pi = math.pi
        return (torch.sin((x - 0.5) * pi) ** 2 + torch.sin((y - 0.5) * pi) ** 2) / 2.0

    def initial_condition(self):
        return self._Q_stationary, self._p_stationary

    def f_rhs(self):
        """Forcing factory ``t -> ((x, y) -> (fx, fy))`` with t a float."""
        kappa = self.kappa
        exponential = self.forcing == "exponential"

        def factory(t):
            s = -kappa * math.exp(-kappa * float(t)) if exponential else -kappa

            def f(x, y):
                qx, qy = self._Q_stationary(x, y)
                return s * qx, s * qy

            return f

        return factory

    def solution(self, t):
        """Interpolated exact solution at time t with zero-mean pressure."""
        disc = self.disc
        if self.forcing == "exponential":
            q_t, p_t = math.exp(-self.kappa * t), math.exp(-2.0 * self.kappa * t)
        else:
            q_t = 1.0 - self.kappa * t
            p_t = q_t ** 2
        Q_exact = q_t * disc.interpolate_velocity(self._Q_stationary)
        p_exact = p_t * disc.interpolate_pressure(self._p_stationary)
        return Q_exact, p_exact - F.integral(disc.geom, disc.geom.phi0, p_exact)
