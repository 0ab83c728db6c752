"""Plain reference of the Taylor–Green cells: the closed-form solution.

The Taylor–Green vortex on the unit square under the forcing
``-kappa exp(-kappa t) Q_s`` solves the incompressible Euler equations
exactly with

    u(x, y, t) = exp(-kappa t)   (-cos a sin b,  sin a cos b)
    p(x, y, t) = exp(-2 kappa t) ((sin^2 a + sin^2 b) / 2 - 1/2)

where a = pi (x - 1/2), b = pi (y - 1/2); ``p`` has zero mean.  This module
works out, in float64 NumPy and independently of the program, the mesh
(the documented ordering of the unit-square triangulation), the nodal
Lagrange bases the program's state is written in (equispaced lattice
nodes), quadrature rules, and the L2 distances of the program's velocity,
pressure and trace from that solution.  It imports nothing of the program.

The trace lives on facets in the program's facet order.  The reference
reads that order from the facet list the program reports (each facet's
two end points) and first checks that the list is exactly the mesh's set
of edges, each once; a wrong list fails the check.
"""

import numpy as np

__all__ = ["unit_square", "TriangleLagrange", "EdgeLagrange", "triangle_rule", "edge_rule",
           "exact_velocity", "exact_pressure", "check_facets", "state_errors"]


def unit_square(nx):
    """Vertices (nv, 2) and cells (nc, 3) of the nx x nx unit square split
    along each square's (i, j) -> (i+1, j+1) diagonal: vertex id i (nx + 1)
    + j, every lower triangle (v00, v10, v11) in i-major order, then every
    upper triangle (v00, v11, v01)."""
    xs = np.linspace(0.0, 1.0, nx + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    i, j = i.ravel(), j.ravel()
    v00, v10 = i * (nx + 1) + j, (i + 1) * (nx + 1) + j
    v01, v11 = v00 + 1, v10 + 1
    lowers = np.stack([v00, v10, v11], axis=-1)
    uppers = np.stack([v00, v11, v01], axis=-1)
    return vertices, np.concatenate([lowers, uppers]).astype(np.int64)


def _monomials(pts, m):
    x, y = pts[:, 0] - 1.0 / 3.0, pts[:, 1] - 1.0 / 3.0
    return np.stack([x ** a * y ** (t - a) for t in range(m + 1) for a in range(t + 1)], -1)


class TriangleLagrange:
    """Nodal P_m on the reference triangle (0,0), (1,0), (0,1), nodes at
    (i/m, j/m) for i = 0..m, j = 0..m-i in that order (the centroid for
    m = 0)."""

    def __init__(self, m):
        self.m = m
        if m == 0:
            self.nodes = np.array([[1.0 / 3.0, 1.0 / 3.0]])
        else:
            self.nodes = np.array([(i / m, j / m) for i in range(m + 1)
                                   for j in range(m + 1 - i)])
        self._coef = np.linalg.inv(_monomials(self.nodes, m))

    def __call__(self, pts):
        """Basis values at reference points: (npts, ndof)."""
        return _monomials(pts, self.m) @ self._coef


class EdgeLagrange:
    """Nodal P_m on [0, 1] at equispaced nodes (the midpoint for m = 0)."""

    def __init__(self, m):
        self.m = m
        self.nodes = np.array([0.5]) if m == 0 else np.linspace(0.0, 1.0, m + 1)
        self._coef = np.linalg.inv(self._mono(self.nodes))

    def _mono(self, s):
        return np.stack([(s - 0.5) ** i for i in range(self.m + 1)], -1)

    def __call__(self, s):
        return self._mono(np.asarray(s)) @ self._coef


def edge_rule(n):
    """n-point Gauss–Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def triangle_rule(n):
    """Collapsed n x n Gauss rule on the reference triangle (weights sum to
    1/2): x = a (1 - b), y = b, with the Jacobian (1 - b) in the weight."""
    a, wa = edge_rule(n)
    b, wb = edge_rule(n)
    A, B = np.meshgrid(a, b, indexing="ij")
    W = np.outer(wa, wb) * (1.0 - B)
    return np.stack([(A * (1.0 - B)).ravel(), B.ravel()], -1), W.ravel()


def exact_velocity(x, y, kappa, t):
    a, b = np.pi * (x - 0.5), np.pi * (y - 0.5)
    q = np.exp(-kappa * t)
    return q * -np.cos(a) * np.sin(b), q * np.sin(a) * np.cos(b)


def exact_pressure(x, y, kappa, t):
    a, b = np.pi * (x - 0.5), np.pi * (y - 0.5)
    return np.exp(-2.0 * kappa * t) * ((np.sin(a) ** 2 + np.sin(b) ** 2) / 2.0 - 0.5)


def check_facets(facet_ends, vertices, cells):
    """Raise ValueError unless ``facet_ends`` (nf, 2) vertex ids list every
    edge of the triangulation exactly once."""
    nv = vertices.shape[0]
    edges = np.concatenate([cells[:, [1, 2]], cells[:, [2, 0]], cells[:, [0, 1]]])
    key = lambda e: np.minimum(e[:, 0], e[:, 1]) * nv + np.maximum(e[:, 0], e[:, 1])
    want = np.unique(key(edges))
    got = np.sort(key(np.asarray(facet_ends, dtype=np.int64)))
    if got.shape != want.shape or not np.array_equal(got, want):
        raise ValueError(f"the program's facet list ({got.shape[0]} facets) is not the mesh's "
                         f"{want.shape[0]} edges, each once")


def _cell_sq_error(coefs, basis, rule, corners, fn, block):
    """sum over cells of the integral of |u_h - u|^2; ``coefs`` (ncomp,
    ndof, nc), ``fn(x, y)`` a tuple of ncomp arrays."""
    pts, w = rule
    phi = basis(pts)  # (nq, ndof)
    lam = np.stack([1.0 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]], -1)  # (nq, 3)
    total = 0.0
    for c0 in range(0, corners.shape[0], block):
        cc = corners[c0:c0 + block]  # (b, 3, 2)
        xq = np.einsum("ql,bld->dqb", lam, cc)  # (2, nq, b)
        e1, e2 = cc[:, 1] - cc[:, 0], cc[:, 2] - cc[:, 0]
        det = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        for comp, exact in enumerate(fn(xq[0], xq[1])):
            diff = phi @ coefs[comp, :, c0:c0 + block] - exact
            total += float(np.sum((w @ diff ** 2) * det))
    return total


def state_errors(Q, p, lam, cells, facet_ends, nx, degree, kappa, t, block=65536):
    """L2 distances of the program's state from the closed-form solution at
    time ``t`` on the nx^2 unit square at degree k = ``degree``:

    - ``velocity_l2``: of Q (2, d1, nc), nodal vector P_{k+1};
    - ``pressure_l2``: of p (d0, nc), nodal P_k (zero mean, as the exact p);
    - ``trace_rms``: of the trace lam (k+1, nf), nodal P_k on each facet
      from its lexicographically smaller end point, against the exact p,
      as a root mean square over the skeleton.

    Everything is float64.  ``cells`` (nc, 3) are the vertex ids of the
    program's cells, which must be :func:`unit_square`'s, in its order;
    ``facet_ends`` (nf, 2) are the vertex ids of the program's facets,
    checked by :func:`check_facets`.  A layout that fails either check
    raises ValueError."""
    vertices, own = unit_square(nx)
    if not np.array_equal(np.asarray(cells, dtype=np.int64), own):
        raise ValueError("the program's cells are not the unit square's, in its order")
    cells = own
    corners = vertices[cells]
    k = degree
    nq = k + 5
    rule = triangle_rule(nq)
    q64 = np.asarray(Q, dtype=np.float64)
    p64 = np.asarray(p, dtype=np.float64)[None]
    vel = _cell_sq_error(q64, TriangleLagrange(k + 1), rule, corners,
                         lambda x, y: exact_velocity(x, y, kappa, t), block)
    pres = _cell_sq_error(p64, TriangleLagrange(k), rule, corners,
                          lambda x, y: (exact_pressure(x, y, kappa, t),), block)

    check_facets(facet_ends, vertices, cells)
    ends = vertices[np.asarray(facet_ends, dtype=np.int64)]  # (nf, 2, 2)
    a, b = ends[:, 0], ends[:, 1]
    swap = (a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
    start = np.where(swap[:, None], b, a)
    end = np.where(swap[:, None], a, b)
    length = np.linalg.norm(end - start, axis=-1)
    s, ws = edge_rule(nq)
    tr = EdgeLagrange(k)(s)  # (nq, k+1)
    lam64 = np.asarray(lam, dtype=np.float64)
    sq = 0.0
    for f0 in range(0, length.shape[0], block):
        sl = slice(f0, f0 + block)
        x = start[sl, None, :] + s[None, :, None] * (end[sl] - start[sl])[:, None, :]
        diff = tr @ lam64[:, sl] - exact_pressure(x[..., 0], x[..., 1], kappa, t).T
        sq += float(np.sum((ws @ diff ** 2) * length[sl]))
    return {
        "velocity_l2": float(np.sqrt(vel)),
        "pressure_l2": float(np.sqrt(pres)),
        "trace_rms": float(np.sqrt(sq / length.sum())),
    }
