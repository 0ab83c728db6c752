"""Nodal Lagrange bases on the reference triangle and reference edge.

The port's own copy of incompressibleeulerhdg_tpu/fem/lagrange.py (numpy
only, equal tables): the DG, CG and discontinuous-trace (DGT) bases.

Bases are constructed numerically: a (conditioned) monomial basis is evaluated
at the nodal points, the generalized Vandermonde matrix is inverted, and any
tabulation (values / gradients at arbitrary points) is a matrix product.  All
of this happens once at setup time in float64 numpy; degrees used in practice
are <= 5, for which this is well conditioned.
"""

import numpy as np

__all__ = [
    "triangle_nodes",
    "triangle_basis",
    "edge_nodes",
    "edge_basis",
    "shifted_legendre",
    "tri_dim",
]


def tri_dim(k):
    """Dimension of P_k on a triangle."""
    return (k + 1) * (k + 2) // 2


def _tri_exponents(k):
    """Monomial exponents (i, j) with i + j <= k, in a fixed order."""
    return [(i, j) for tot in range(k + 1) for i in range(tot, -1, -1) for j in (tot - i,)]


def triangle_nodes(k):
    """Equispaced lattice nodes on the reference triangle, shape (tri_dim(k), 2).

    k = 0 returns the centroid.  Ordering: vertices of the lattice enumerated
    row-by-row, (i/k, j/k) for i + j <= k.
    """
    if k == 0:
        return np.array([[1.0 / 3.0, 1.0 / 3.0]])
    pts = [(i / k, j / k) for i in range(k + 1) for j in range(k + 1 - i)]
    return np.asarray(pts, dtype=np.float64)


def _tri_monomial_vals(pts, k):
    """Monomial values at pts, centered at the centroid for conditioning."""
    x = pts[:, 0] - 1.0 / 3.0
    y = pts[:, 1] - 1.0 / 3.0
    cols = [x**i * y**j for (i, j) in _tri_exponents(k)]
    return np.stack(cols, axis=-1)


def _tri_monomial_hess(pts, k):
    x = pts[:, 0] - 1.0 / 3.0
    y = pts[:, 1] - 1.0 / 3.0
    z = np.zeros_like(x)
    hxx, hxy, hyy = [], [], []
    for (i, j) in _tri_exponents(k):
        hxx.append(i * (i - 1) * x ** max(i - 2, 0) * y**j if i > 1 else z)
        hxy.append(i * j * x ** max(i - 1, 0) * y ** max(j - 1, 0) if (i > 0 and j > 0) else z)
        hyy.append(j * (j - 1) * x**i * y ** max(j - 2, 0) if j > 1 else z)
    Hxx = np.stack(hxx, -1)
    Hxy = np.stack(hxy, -1)
    Hyy = np.stack(hyy, -1)
    return np.stack(
        [np.stack([Hxx, Hxy], -1), np.stack([Hxy, Hyy], -1)], axis=-1
    )  # (npts, nmono, 2, 2)


def _tri_monomial_grads(pts, k):
    x = pts[:, 0] - 1.0 / 3.0
    y = pts[:, 1] - 1.0 / 3.0
    gx, gy = [], []
    for (i, j) in _tri_exponents(k):
        gx.append(i * x ** max(i - 1, 0) * y**j if i > 0 else np.zeros_like(x))
        gy.append(j * x**i * y ** max(j - 1, 0) if j > 0 else np.zeros_like(x))
    return np.stack([np.stack(gx, -1), np.stack(gy, -1)], axis=-1)  # (npts, ndof, 2)


class TriangleBasis:
    """Nodal Lagrange basis of degree k on the reference triangle."""

    def __init__(self, k):
        self.degree = k
        self.ndof = tri_dim(k)
        self.nodes = triangle_nodes(k)
        V = _tri_monomial_vals(self.nodes, k)
        self._coeff = np.linalg.inv(V)  # columns: monomial coeffs of each nodal fn

    def tabulate(self, pts):
        """Basis values at pts: (npts, ndof)."""
        return _tri_monomial_vals(np.atleast_2d(pts), self.degree) @ self._coeff

    def tabulate_grad(self, pts):
        """Basis gradients at pts: (npts, ndof, 2)."""
        G = _tri_monomial_grads(np.atleast_2d(pts), self.degree)  # (npts, nmono, 2)
        return np.einsum("pmd,mn->pnd", G, self._coeff)

    def tabulate_hess(self, pts):
        """Basis second derivatives at pts: (npts, ndof, 2, 2)."""
        H = _tri_monomial_hess(np.atleast_2d(pts), self.degree)
        return np.einsum("pmde,mn->pnde", H, self._coeff)


def triangle_basis(k):
    return TriangleBasis(k)


def edge_nodes(k):
    """Equispaced nodes on [0, 1]; k = 0 returns the midpoint."""
    if k == 0:
        return np.array([0.5])
    return np.linspace(0.0, 1.0, k + 1)


class EdgeBasis:
    """Nodal Lagrange basis of degree k on the reference edge [0, 1]."""

    def __init__(self, k):
        self.degree = k
        self.ndof = k + 1
        self.nodes = edge_nodes(k)
        V = self._mono(self.nodes)
        self._coeff = np.linalg.inv(V)

    def _mono(self, s):
        s = np.atleast_1d(s) - 0.5
        return np.stack([s**i for i in range(self.degree + 1)], axis=-1)

    def tabulate(self, s):
        return self._mono(s) @ self._coeff


def edge_basis(k):
    return EdgeBasis(k)


def shifted_legendre(nmax, s):
    """L2(0,1)-orthonormal (shifted) Legendre polynomials P_0..P_nmax at points s.

    Returns (npts, nmax+1).  Used as the facet-moment basis for BDM
    interpolation (the dual functionals of the facet dofs).
    """
    s = np.atleast_1d(s)
    t = 2.0 * s - 1.0
    vals = np.zeros((s.shape[0], nmax + 1))
    vals[:, 0] = 1.0
    if nmax >= 1:
        vals[:, 1] = t
    for n in range(1, nmax):
        vals[:, n + 1] = ((2 * n + 1) * t * vals[:, n] - n * vals[:, n - 1]) / (n + 1)
    norm = np.sqrt(2.0 * np.arange(nmax + 1) + 1.0)
    return vals * norm[None, :]
