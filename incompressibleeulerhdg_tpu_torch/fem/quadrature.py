"""Quadrature rules on the reference triangle and reference edge.

The port's own copy of incompressibleeulerhdg_tpu/fem/quadrature.py (numpy
and scipy only, equal rules).  All rules are constructed once at setup time
in numpy float64; the point/weight tables become tensors of the ``Geom``.

The triangle rule is a collapsed (Duffy) Gauss-Legendre x Gauss-Jacobi rule:
exact for all bivariate polynomials of total degree <= ``degree``.
"""

import numpy as np
from scipy.special import roots_legendre, roots_jacobi

__all__ = ["gauss_legendre_01", "triangle_quadrature", "edge_quadrature"]


def gauss_legendre_01(n):
    """n-point Gauss-Legendre rule on [0, 1]; exact for degree <= 2n-1."""
    x, w = roots_legendre(n)
    return (x + 1.0) / 2.0, w / 2.0


def edge_quadrature(degree):
    """Gauss-Legendre rule on [0,1] exact for 1-D polynomials of total degree <= degree."""
    n = degree // 2 + 1
    return gauss_legendre_01(n)


def triangle_quadrature(degree):
    """Quadrature on the reference triangle {(x,y): x,y >= 0, x+y <= 1}.

    Collapsed-coordinate rule: with x = a(1-b), y = b,
        int_T f dx dy = int_0^1 int_0^1 f(a(1-b), b) (1-b) da db.
    Gauss-Legendre in ``a`` and Gauss-Jacobi(alpha=1) in ``b`` (the Jacobi
    weight absorbs the (1-b) Duffy factor), so an n x n tensor rule is exact
    for total degree <= 2n-1.

    Returns (points (nq, 2), weights (nq,)); weights sum to 1/2.
    """
    n = degree // 2 + 1
    a, wa = gauss_legendre_01(n)
    # Gauss-Jacobi with weight (1-t)^1 on [-1, 1] -> map to [0, 1]
    t, wt = roots_jacobi(n, 1.0, 0.0)
    b = (t + 1.0) / 2.0
    wb = wt / 4.0
    A, B = np.meshgrid(a, b, indexing="ij")
    WA, WB = np.meshgrid(wa, wb, indexing="ij")
    x = (A * (1.0 - B)).ravel()
    y = B.ravel()
    w = (WA * WB).ravel()
    return np.stack([x, y], axis=-1), w
