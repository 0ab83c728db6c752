"""Continuous (CG) Lagrange spaces: global numbering + matrix-free operators.

Counterpart of incompressibleeulerhdg_tpu/fem/cg.py.  The port uses CG
spaces for the tracer's advecting-velocity projection onto vector CG(k+1)
(``ops/tracer.py``) and the vorticity output projection onto CG(k+1)
(``ops/vorticity.py``).  The P1 coarse space of the two-level trace
preconditioner (``linalg/gtmg.py``) numbers its dofs by the mesh vertices,
``mesh.cells``, which is this module's CG(1) dof map, so it needs no table
from here.

A CG field is a flat tensor over global dofs; cell-local views are gathers
through the (nloc, n_cells) dof map, operators are batched dense element
kernels followed by a scatter-add (``index_add_``), and the mass solve is a
Jacobi-preconditioned CG iteration.  The numbering is host numpy, built once.
On a slab- or partition-local geometry (parallel/slab.py, partition.py) the
dof vector stays replicated: each rank accumulates its own cells into it and
a sum over the ranks resolves the interface dofs, as the GTMG coarse
residual.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .lagrange import triangle_basis, tri_dim
from ..linalg.krylov import cg
from ..ops.structured import dist_axis

__all__ = ["CGSpace", "build_cg_space", "cg_gather", "cg_scatter", "cg_mass_matvec",
           "cg_mass_solve", "cg_project_dg", "cg_eval_at_q"]


@dataclass
class CGSpace:
    """Device tables of a scalar CG(degree) space on the mesh."""

    dofmap: torch.Tensor  # (nloc, nc) int64 global dof ids (batch-last)
    phi_at_q1: torch.Tensor  # (nq, nloc) CG basis at the V1 cell quadrature
    mass_diag: torch.Tensor  # (n_dofs,) assembled diagonal of the mass matrix
    node_coords: torch.Tensor  # (n_dofs, 2)
    degree: int = 1
    n_dofs: int = 0


def _local_node_classification(m):
    """Classify the lattice nodes of degree m, in the order of
    ``fem.lagrange.triangle_nodes`` (i outer, j inner): a list of (kind,
    data) with kind 'v' (data: local vertex), 'e' (data: (local edge,
    position 1..m-1 along the edge's canonical direction)) or 'i' (data:
    interior counter)."""
    out = []
    n_int = 0
    for i in range(m + 1):
        for j in range(m + 1 - i):
            k = m - i - j
            # barycentric indices (k, i, j) of vertices (v0, v1, v2)
            if i == m:
                out.append(("v", 1))
            elif j == m:
                out.append(("v", 2))
            elif k == m:
                out.append(("v", 0))
            elif k == 0:  # edge v1-v2 = local facet 0, from v1 to v2
                out.append(("e", (0, j)))
            elif j == 0:  # edge v0-v1 = local facet 2, from v0 to v1
                out.append(("e", (2, i)))
            elif i == 0:  # edge v2-v0 = local facet 1, from v2 to v0
                out.append(("e", (1, m - j)))
            else:
                n_int += 1
                out.append(("i", n_int - 1))
    return out


def build_cg_space(disc, degree):
    """A CGSpace of the given degree on ``disc``'s mesh, in its dtype on its
    device (host numpy numbering)."""
    mesh = disc.mesh
    m = degree
    nc, nv, nf = mesh.n_cells, mesh.n_vertices, mesh.n_facets
    n_edge = m - 1
    n_int = tri_dim(m - 3) if m >= 3 else 0
    nloc = tri_dim(m)
    n_dofs = nv + nf * n_edge + nc * n_int

    basis = triangle_basis(m)
    cls = _local_node_classification(m)
    assert len(cls) == nloc

    dofmap = np.zeros((nc, nloc), dtype=np.int64)
    for loc, (kind, data) in enumerate(cls):
        if kind == "v":
            dofmap[:, loc] = mesh.cells[:, data]
        elif kind == "e":
            le, pos = data
            f = mesh.cell_facets[:, le]
            side = mesh.cell_facet_side[:, le]
            flip = mesh.facet_flip[f, side]
            # position along the facet's global (lo -> hi) direction
            gpos = np.where(flip == 1, m - pos, pos)
            dofmap[:, loc] = nv + f * n_edge + (gpos - 1)
        else:
            dofmap[:, loc] = nv + nf * n_edge + np.arange(nc) * n_int + data

    phi = basis.tabulate(disc.V1.qp)
    # assembled diagonal of the consistent mass matrix
    Mloc = np.einsum("q,qi,qj->ij", disc.V1.qw, phi, phi)
    diag_loc = np.einsum("c,i->ci", mesh.det_jac, np.diag(Mloc))
    mass_diag = np.zeros(n_dofs)
    np.add.at(mass_diag, dofmap, diag_loc)

    # node coordinates (every cell sharing a dof writes the same point)
    lam = np.stack([1.0 - basis.nodes[:, 0] - basis.nodes[:, 1], basis.nodes[:, 0],
                    basis.nodes[:, 1]], axis=-1)
    cell_nodes = np.einsum("pl,cld->cpd", lam, mesh.cell_coords)
    node_coords = np.zeros((n_dofs, 2))
    node_coords[dofmap.ravel()] = cell_nodes.reshape(-1, 2)

    f = lambda a: torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
    return CGSpace(
        dofmap=torch.as_tensor(np.ascontiguousarray(dofmap.T), device=disc.device),
        phi_at_q1=f(phi),
        mass_diag=f(mass_diag),
        node_coords=f(node_coords),
        degree=m,
        n_dofs=int(n_dofs),
    )


def cg_gather(space, v):
    """Global CG vector(s) (..., n_dofs) -> cell-local (..., nloc, nc)."""
    return v[..., space.dofmap]


def cg_scatter(space, local):
    """Adjoint of :func:`cg_gather`: accumulate (..., nloc, nc) into
    (..., n_dofs)."""
    out = local.new_zeros(local.shape[:-2] + (space.n_dofs,))
    return out.index_add_(-1, space.dofmap.reshape(-1),
                          local.reshape(local.shape[:-2] + (-1,)))


def _assemble(geom, space, local):
    """:func:`cg_scatter` of a geometry's cells: the dummy cells of an uneven
    slab split left out, summed over the ranks of a distributed geometry."""
    if geom.cvalid is not None:
        local = local * geom.cvalid
    out = cg_scatter(space, local)
    comm = dist_axis(geom)
    return out if comm is None else comm.allreduce(out)


def cg_mass_matvec(geom, space, v):
    """Consistent CG mass matrix action on (..., n_dofs) vectors."""
    loc = cg_gather(space, v)
    Mloc = torch.einsum("q,qi,qj->ij", geom.wq, space.phi_at_q1, space.phi_at_q1)
    return _assemble(geom, space, geom.det_jac * torch.einsum("ij,...jc->...ic", Mloc, loc))


def cg_mass_solve(geom, space, b, rtol=1e-12, maxiter=200):
    """Solve the CG mass system M x = b by Jacobi-preconditioned CG on an
    (n_dofs,) or (k, n_dofs) right-hand side (components solved together,
    one iteration count).  Returns (x, iters)."""
    shape = b.shape
    dinv = 1.0 / space.mass_diag

    def mv(v):
        return cg_mass_matvec(geom, space, v.reshape(shape)).reshape(-1)

    def M(v):
        return (dinv * v.reshape(shape)).reshape(-1)

    x, iters, _ = cg(mv, b.reshape(-1), M=M, rtol=rtol, maxiter=maxiter)
    return x.reshape(shape), iters


def cg_project_dg(geom, space, u, rtol=1e-12):
    """L2-project a DG(k+1) field ([2,] d1, nc) onto the CG space.
    Returns (x ([2,] n_dofs), iters)."""
    uq = torch.einsum("qi,...ic->...qc", geom.phi1, u)
    loc = torch.einsum("c,q,qi,...qc->...ic", geom.det_jac, geom.wq, space.phi_at_q1, uq)
    return cg_mass_solve(geom, space, _assemble(geom, space, loc), rtol=rtol)


def cg_eval_at_q(geom, space, x):
    """A CG field at the cell quadrature points: (..., nq, nc)."""
    return torch.einsum("qi,...ic->...qc", space.phi_at_q1, cg_gather(space, x))
