"""Reference-element tabulations of the function spaces.

The port's own copy of incompressibleeulerhdg_tpu/fem/spaces.py (numpy
only, equal tables).  The spaces are
    V_Q  = vector DG(k+1)
    V_p  = DG(k)
    V_t  = DGT(k)      (facet trace space)
each a static table of basis values/gradients at cell quadrature points plus
facet-trace tables indexed by (local facet, orientation flip).

All tables are numpy float64, built once at setup.
"""

from dataclasses import dataclass
import numpy as np

from .lagrange import triangle_basis, edge_basis, tri_dim
from .quadrature import triangle_quadrature, edge_quadrature

__all__ = ["CellSpaceTab", "TraceSpaceTab", "tabulate_cell_space", "tabulate_trace_space"]

# reference coordinates of the canonical endpoints of each local facet
# (local facet l is opposite vertex l; see mesh/triangle_mesh.py)
_REF_FACET_ENDS = np.array(
    [
        [[1.0, 0.0], [0.0, 1.0]],  # facet 0: v1 -> v2
        [[0.0, 1.0], [0.0, 0.0]],  # facet 1: v2 -> v0
        [[0.0, 0.0], [1.0, 0.0]],  # facet 2: v0 -> v1
    ]
)


def facet_ref_points(local_facet, flip, s):
    """Reference-cell coordinates of facet points at canonical facet parameters s.

    ``s`` parametrises the facet from its lower-global-id endpoint to the
    higher one; ``flip = 1`` means the cell's canonical local direction is
    reversed relative to that.
    """
    a, b = _REF_FACET_ENDS[local_facet]
    t = (1.0 - s) if flip else s
    return a[None, :] + t[:, None] * (b - a)[None, :]


@dataclass
class CellSpaceTab:
    """Tabulated scalar DG space on the reference triangle."""

    degree: int
    ndof: int
    # cell quadrature
    qp: np.ndarray  # (nq, 2)
    qw: np.ndarray  # (nq,)
    phi: np.ndarray  # (nq, ndof)
    gphi: np.ndarray  # (nq, ndof, 2) reference gradients
    hphi: np.ndarray  # (nq, ndof, 2, 2) reference second derivatives
    # facet-trace tabulation, index = 2 * local_facet + flip: (6, nqf, ndof)
    tphi: np.ndarray
    # facet-trace tabulation of reference gradients: (6, nqf, ndof, 2)
    tgphi: np.ndarray
    # nodal points (for interpolation of expressions)
    nodes: np.ndarray  # (ndof, 2)
    mass_ref: np.ndarray  # (ndof, ndof) reference mass matrix
    mass_ref_inv: np.ndarray

    basis: object = None


@dataclass
class TraceSpaceTab:
    """Tabulated DGT (facet trace) space on the reference edge [0, 1]."""

    degree: int
    ndof: int
    sq: np.ndarray  # (nqf,) facet quadrature points
    wq: np.ndarray  # (nqf,)
    tr: np.ndarray  # (nqf, ndof) basis values at quadrature points
    nodes: np.ndarray  # (ndof,)
    mass_ref: np.ndarray  # (ndof, ndof) int_0^1 tr_i tr_j ds
    mass_ref_inv: np.ndarray

    basis: object = None


def tabulate_cell_space(degree, quad_degree, facet_quad_s):
    """Build a CellSpaceTab for DG(degree) with given quadrature orders.

    :arg quad_degree: polynomial exactness of the cell rule
    :arg facet_quad_s: 1-D array of canonical facet quadrature points in [0,1]
    """
    basis = triangle_basis(degree)
    qp, qw = triangle_quadrature(quad_degree)
    phi = basis.tabulate(qp)
    gphi = basis.tabulate_grad(qp)
    hphi = basis.tabulate_hess(qp)
    fpts = [facet_ref_points(l, flip, facet_quad_s) for l in range(3) for flip in (0, 1)]
    tphi = np.stack([basis.tabulate(p) for p in fpts])
    tgphi = np.stack([basis.tabulate_grad(p) for p in fpts])
    mass = np.einsum("q,qi,qj->ij", qw, phi, phi)
    return CellSpaceTab(
        degree=degree,
        ndof=tri_dim(degree),
        qp=qp,
        qw=qw,
        phi=phi,
        gphi=gphi,
        hphi=hphi,
        tphi=tphi,
        tgphi=tgphi,
        nodes=basis.nodes,
        mass_ref=mass,
        mass_ref_inv=np.linalg.inv(mass),
        basis=basis,
    )


def tabulate_trace_space(degree, quad_degree):
    """Build a TraceSpaceTab for DGT(degree) with a facet rule of given exactness."""
    basis = edge_basis(degree)
    sq, wq = edge_quadrature(quad_degree)
    tr = basis.tabulate(sq)
    mass = np.einsum("q,qi,qj->ij", wq, tr, tr)
    return TraceSpaceTab(
        degree=degree,
        ndof=degree + 1,
        sq=sq,
        wq=wq,
        tr=tr,
        nodes=basis.nodes,
        mass_ref=mass,
        mass_ref_inv=np.linalg.inv(mass),
        basis=basis,
    )
