"""Model problems: Taylor-Green vortex, Kelvin-Helmholtz, double shear layer.

Counterpart of incompressibleeulerhdg_tpu/models/problems.py.  Expressions
are closures ``(x, y) -> value`` on tensors, evaluated at the DG nodal
points by the discretisation's interpolation.  ``solution(t)`` returns the
interpolated exact solution, or None where the problem has none.
"""

import math

import numpy as np
import torch

from ..ops import fields as F

__all__ = ["TaylorGreen", "KelvinHelmholtz", "DoubleLayerShearFlow"]


def _no_forcing(t):
    return lambda x, y: (torch.zeros_like(x), torch.zeros_like(y))


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


class KelvinHelmholtz:
    """Rigidly rotating disk of radius ``r_max`` inside the resting unit disk
    (``unit_disk_mesh``): Q = (-y, x) where x^2 + y^2 < r_max^2, else 0;
    zero pressure, no forcing, no exact solution."""

    def __init__(self, disc, r_max=0.5):
        self.disc = disc
        self.r_max = r_max

    def initial_condition(self):
        r_max = self.r_max

        def Q0(x, y):
            inside = x**2 + y**2 < r_max**2
            return torch.where(inside, -y, 0.0), torch.where(inside, x, 0.0)

        return Q0, (lambda x, y: torch.zeros_like(x))

    def f_rhs(self):
        return _no_forcing

    def solution(self, t):
        return None


class DoubleLayerShearFlow:
    """Double shear layer on the 2 pi-periodic square (``periodic_square_mesh``):

        u = tanh((y - pi/2) / rho) for y <= pi, tanh((3 pi/2 - y) / rho) above,
        v = delta sin(x),

    with the initial pressure as a ``kmax``-term sine series in y whose
    coefficients are oscillatory-weight quadratures (scipy's QUADPACK, at
    set-up on the host).  No forcing, no exact solution.
    """

    def __init__(self, disc, rho=np.pi / 15.0, delta=0.05, kmax=28):
        import scipy.integrate as integrate

        self.disc = disc
        self.rho = rho
        self.delta = delta
        coeffs = []
        for k in range(kmax):
            c = integrate.quad(
                lambda z: np.where(
                    z <= 0.0,
                    1 - np.tanh((np.pi + 2 * z) / (4 * np.pi * rho)) ** 2,
                    -1 + np.tanh((np.pi - 2 * z) / (4 * np.pi * rho)) ** 2,
                )
                / (np.pi**2 * rho),
                -np.pi,
                np.pi,
                weight="sin",
                wvar=2 * k + 1,
                epsabs=1e-12,
                epsrel=1e-12,
            )[0]
            coeffs.append(c / (1 + (2 * k + 1) ** 2))
        self.coeffs = np.asarray(coeffs)

    def initial_condition(self):
        rho, delta, pi = self.rho, self.delta, math.pi

        def Q0(x, y):
            u = torch.where(y <= pi, torch.tanh((y - pi / 2.0) / rho),
                            torch.tanh((1.5 * pi - y) / rho))
            return u, delta * torch.sin(x)

        def p0(x, y):
            c = torch.as_tensor(self.coeffs, dtype=y.dtype, device=y.device)
            k = torch.arange(c.shape[0], dtype=y.dtype, device=y.device)
            series = torch.sum(c * torch.sin((2 * k + 1) * (y[..., None] - pi)), dim=-1)
            return delta * torch.cos(x) * series

        return Q0, p0

    def f_rhs(self):
        return _no_forcing

    def solution(self, t):
        return None
