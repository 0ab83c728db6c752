"""Batched field evaluation primitives shared by all weak-form operators.

Counterpart of incompressibleeulerhdg_tpu/ops/fields.py.  Fields are
batch-last: scalar ``(d, nc)``, vector ``(2, d, nc)``, trace ``(nt, nf)``;
quadrature values ``([2,] nq, nc)`` / ``([2,] nqf, nf)``.  Per-facet trace
tables are the 6 reference tables indexed by each facet's orientation code
``ftab`` (2 * local facet + flip).

Facet<->cell moves take one of two branches: on a structured mesh
(``geom.shift``) the slices and rolls of ``ops/structured.py``; on any other
mesh (the unit disk) index gathers through ``fcells`` and ``cfassemble``,
as the JAX package's gather branches.  On a slab-local geometry
(parallel/slab.py) the domain integrals are sums over all ranks.  On a
partition-local one (parallel/partition.py) the gather tables index
``[owned | ghost]`` arrays: each gather first appends its source's ghost
entries (:func:`cells_ext`, :func:`facets_ext`, one ``Comm.ghosts`` each),
and the static tables it reads carry theirs from the set-up
(:func:`table_ext`).
"""

import torch

from .structured import dist_axis, gather_plus, gather_minus, scatter_sides_sum, slot_gather

__all__ = [
    "cells_ext",
    "facets_ext",
    "table_ext",
    "gather_side",
    "gather_sides",
    "gather_facet_contribs",
    "slot_values",
    "cell_values",
    "cell_grads",
    "cell_div",
    "facet_traces",
    "facet_trace_plus",
    "trace_values",
    "scatter_facets",
    "facet_integrate_trace",
    "cell_integrate",
    "integral",
    "sum_ranks",
    "mass_apply",
    "mass_solve",
    "l2_norm_sq",
    "interior_mask",
]


def cell_values(phi, u):
    """DG field at cell quadrature points: (..., nd, nc) -> (..., nq, nc)."""
    return torch.einsum("qi,...ic->...qc", phi, u)


def cell_grads(geom, gphi, u):
    """Physical gradients at cell quadrature points: (..., 2, nq, nc), the
    new axis (before nq) the derivative direction."""
    gref = torch.einsum("qib,...ic->...bqc", gphi, u)
    jinv = geom.jac_inv
    return torch.stack(
        [gref[..., 0, :, :] * jinv[0, a] + gref[..., 1, :, :] * jinv[1, a]
         for a in (0, 1)],
        dim=-3,
    )


def cell_div(geom, u):
    """Divergence of a velocity field at cell quadrature points: (nq, nc)."""
    g = cell_grads(geom, geom.gphi1, u)
    return g[0, 0] + g[1, 1]


def cells_ext(geom, u):
    """A cell field (..., nc) followed by the ghost cells of a
    partition-local geometry (one ghost exchange); ``u`` elsewhere."""
    part = geom.part
    return u if part is None else part.comm.ghosts(part.cells, u)


def facets_ext(geom, g):
    """A facet field (..., nf) followed by the ghost facets of a
    partition-local geometry (one ghost exchange); ``g`` elsewhere."""
    part = geom.part
    return g if part is None else part.comm.ghosts(part.facets, g)


def table_ext(geom, name):
    """The static geometry table ``name`` with the ghost entries of a
    partition-local geometry, built with it; the table itself elsewhere."""
    return getattr(geom, name) if geom.part is None else geom.part.tables[name]


def gather_side(geom, u, side):
    """Cell values of each facet's plus (side 0) or minus (side 1) cell:
    (..., nc) -> (..., nf).  On boundary facets the minus values are zero
    on a structured mesh and another cell's on a gathered one; callers mask
    them."""
    if geom.shift is not None:
        return gather_plus(geom, u) if side == 0 else gather_minus(geom, u)
    return cells_ext(geom, u)[..., geom.fcells[side]]


def gather_sides(geom, u, ext=False):
    """Both sides' cell values, :func:`gather_side` 0 and 1, from one ghost
    exchange; ``ext``: ``u`` already holds its ghost cells."""
    if geom.shift is not None:
        return gather_plus(geom, u), gather_minus(geom, u)
    if not ext:
        u = cells_ext(geom, u)
    return u[..., geom.fcells[0]], u[..., geom.fcells[1]]


def gather_facet_contribs(geom, c0, c1):
    """Accumulate per-facet contributions into cells: c0 targets each
    facet's plus cell, c1 its minus cell, (..., nf) each -> (..., nc).  The
    gather branch reads three entries per cell from the side-concatenated
    array (every cell has three facets), so no scatter is needed."""
    if geom.shift is not None:
        return scatter_sides_sum(geom, c0, c1)
    if geom.part is None:
        zcat = torch.cat([c0, c1], dim=-1)
    else:
        c = facets_ext(geom, torch.stack(torch.broadcast_tensors(c0, c1)))
        zcat = torch.cat([c[0], c[1]], dim=-1)
    return sum(zcat[..., geom.cfassemble[l]] for l in range(3))


def slot_values(geom, gf, ext=False):
    """Facet values per local cell slot: (..., nf) -> 3-list of (..., nc),
    slot l of cell c holding ``gf[..., cell_facets[l, c]]``; ``ext``:
    ``gf`` already holds its ghost facets."""
    if geom.shift is not None:
        return slot_gather(geom, gf)
    if not ext:
        gf = facets_ext(geom, gf)
    return [gf[..., geom.cell_facets[l]] for l in range(3)]


def _eval_side(geom, tphi, ug, side):
    """Trace of a DG field on one facet side from its cell values there
    (..., nd, nf): (..., nqf, nf)."""
    U = tphi[geom.ftab[side]]  # (nf, nqf, nd)
    return torch.einsum("fqi,...if->...qf", U, ug)


def facet_traces(geom, tphi, u):
    """Both-side traces at facet quadrature points, each (..., nqf, nf); the
    minus trace on boundary facets is not data (mask with :func:`interior_mask`)."""
    u0, u1 = gather_sides(geom, u)
    return _eval_side(geom, tphi, u0, 0), _eval_side(geom, tphi, u1, 1)


def facet_trace_plus(geom, tphi, u):
    """Plus-side trace only: (..., nqf, nf)."""
    return _eval_side(geom, tphi, gather_side(geom, u, 0), 0)


def trace_values(geom, lam):
    """DGT trace field at facet quadrature points: (nqf, nf)."""
    return torch.einsum("qj,jf->qf", geom.tr, lam)


def interior_mask(geom, ndim=2):
    """(..., nf) float mask (1 on interior facets) with ndim-1 leading axes:
    the stored ``geom.fint`` on slab-local layouts (their colour rectangles
    hold boundary facets), else the interior-first facet order."""
    if geom.fint is not None:
        m = geom.fint
    else:
        m = (torch.arange(geom.n_facets, device=geom.device) < geom.n_int).to(geom.dtype)
    return m.reshape((1,) * (ndim - 1) + (-1,))


def _adjoint_side(geom, tphi, g, side):
    """Integrate an integrand against one side's trace basis: (..., nd, nf)."""
    U = tphi[geom.ftab[side]]  # (nf, nqf, nd)
    w = geom.wqf[:, None] * geom.flen[None, :]
    return torch.einsum("fqi,...qf->...if", U, w * g)


def scatter_facets(geom, tphi, g0, g1):
    """Adjoint of facet trace evaluation: accumulate facet integrands into
    cells.  g0/g1 (..., nqf, nf) multiply the test function's plus/minus
    trace; g1 is masked to interior facets."""
    c0 = _adjoint_side(geom, tphi, g0, 0)
    c1 = _adjoint_side(geom, tphi, g1 * interior_mask(geom, g1.ndim), 1)
    return gather_facet_contribs(geom, c0, c1)


def facet_integrate_trace(geom, integrand):
    """Integrate against the DGT test basis: (nqf, nf) -> (nt, nf)."""
    w = geom.wqf[:, None] * geom.flen[None, :]
    return torch.einsum("qj,qf->jf", geom.tr, w * integrand)


def cell_integrate(geom, phi, integrand):
    """(..., nq, nc) -> (..., nd, nc): detJ * sum_q wq phi[q, i] g[..., q, c]."""
    return geom.det_jac * torch.einsum("qi,...qc->...ic", geom.wq[:, None] * phi, integrand)


def sum_ranks(geom, x):
    """A rank's partial sum summed over all ranks on a slab- or
    partition-local geometry; ``x`` elsewhere."""
    comm = dist_axis(geom)
    return x if comm is None else comm.allreduce(x)


def integral(geom, phi, u):
    """Integral of a DG field over the domain (summed over components), as a
    0-d tensor."""
    vals = cell_values(phi, u)
    return sum_ranks(geom, torch.einsum("c,q,...qc->", geom.det_jac, geom.wq, vals))


def mass_apply(geom, mref, u):
    """Block-diagonal DG mass matrix (affine cells: detJ * M_ref)."""
    return geom.det_jac * torch.einsum("ij,...jc->...ic", mref, u)


def mass_solve(geom, minv, r):
    """Solve M u = r for the block-diagonal DG mass matrix."""
    return torch.einsum("ij,...jc->...ic", minv, r) / geom.det_jac


def l2_norm_sq(geom, phi, u):
    """Squared L2 norm of a scalar (d, nc) or vector (2, d, nc) DG field."""
    vals = cell_values(phi, u)
    sq = vals**2 if vals.ndim == 2 else torch.sum(vals**2, dim=0)
    return sum_ranks(geom, torch.einsum("c,q,qc->", geom.det_jac, geom.wq, sq))
