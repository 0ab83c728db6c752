"""Lowest-order Raviart-Thomas (RT1 in Firedrake numbering) element operations.

Counterpart of incompressibleeulerhdg_tpu/ops/rt.py, the element layer of the
conforming scheme.  The velocity lives in the H(div)-conforming RT space
with ONE global dof per facet, the integrated normal flux g_f = int_f v . n_f
ds (n_f the stored facet normal).  On a cell c with area A and opposite
vertex P_l the local basis

    W_l(x) = (x - P_l) / (2 A),   v|_c = sum_l sign_{c,l} g_{f(c,l)} W_l

has unit outward flux through facet l and none through the others.  Because
W_l is affine, every evaluation reduces to v(x) = a_c x - b_c with per-cell
scalars a_c and vectors b_c.

Layouts are batch-last: RT dof vectors are flat (nf,), quadrature-point
fields (2, nq, nc) / (2, nqf, nf).  Cell -> facet accumulation is a gather
of each facet's two cell slots (``RTTables.fslot``), facet -> cell
accumulation goes through ``ops.fields.gather_facet_contribs``: both are
sums over a fixed number of sources, so the card adds them in a fixed order.
On a partition-local geometry (parallel/partition.py) a rank holds the dofs
of its own facets; both moves read the ghost entries of their source first
(``ops.fields.cells_ext`` / ``facets_ext``).
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import fields as F
from ..fem.spaces import facet_ref_points

__all__ = [
    "RTTables",
    "build_rt_tables",
    "facet_slots",
    "cell_dofs",
    "rt_cell_coeffs",
    "rt_eval",
    "rt_eval_cellq",
    "rt_facet_values",
    "rt_divergence",
    "rt_div_adjoint",
    "rt_mass_apply",
    "rt_volume_adjoint",
    "rt_facet_adjoint",
    "rt_to_dg1",
    "rt_interpolate",
]


@dataclass
class RTTables:
    P_opp: torch.Tensor  # (3, 2, nc) opposite-vertex coordinates per local facet
    area: torch.Tensor  # (nc,)
    mass_elem: torch.Tensor  # (3, 3, nc) signed element mass matrices
    mass_diag_inv: torch.Tensor  # (nf,) inverse of the assembled mass diagonal
    xqf: torch.Tensor  # (2 side, 2 comp, nqf, nf) facet quadrature coords (unwrapped)
    bnd_mask: torch.Tensor  # (nf,) 1.0 on boundary facets
    int_dof_mask: torch.Tensor  # (nf,) 1.0 on interior facets (the BC projector)
    fslot: torch.Tensor  # (2, nf) int64 flat (local facet, cell) index of each side


def facet_slots(geom):
    """(2, nf) flat indices into a (3, nc) cell-local array of each facet's
    plus and minus cell slot (the minus slot of a boundary facet is not
    data).  On a partition-local geometry the array holds the ghost cells
    too (``ops.fields.cells_ext``)."""
    nc = geom.n_cells if geom.part is None else geom.part.cells.n_ext
    return geom.ftab.clamp(min=0) // 2 * nc + geom.fcells


def build_rt_tables(disc):
    """RT tables of a degree-0 discretisation (V1 = DG1), host numpy."""
    if disc.degree != 0:
        raise ValueError("the conforming RT solver uses the degree-0 discretisation")
    mesh = disc.mesh
    area = mesh.det_jac / 2.0
    P_opp = mesh.cell_coords  # (nc, 3, 2): vertex l is opposite facet l

    # signed element mass: M[l,m] = s_l s_m / (4A^2) int (x-P_l).(x-P_m) dx
    qp = disc.V1.qp
    lam = np.stack([1.0 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]], axis=-1)
    xq = np.einsum("ql,cld->cqd", lam, mesh.cell_coords)  # (nc, nq, 2)
    diff = xq[:, :, None, :] - P_opp[:, None, :, :]  # (nc, nq, 3, 2)
    M = np.einsum("c,q,cqld,cqmd->clm", mesh.det_jac, disc.V1.qw, diff, diff)
    sgn = np.where(mesh.cell_facet_side == 0, 1.0, -1.0)
    M = M * sgn[:, :, None] * sgn[:, None, :] / (4.0 * area**2)[:, None, None]

    nf = mesh.n_facets
    Mdiag = np.zeros(nf)
    np.add.at(Mdiag, mesh.cell_facets, np.einsum("cll->cl", M))

    # facet quadrature coordinates per side, in each cell's unwrapped frame
    sq = disc.Vt.sq
    xqf = np.zeros((nf, 2, sq.shape[0], 2))
    for side in (0, 1):
        c = mesh.facet_cells[:, side].copy()
        c[c < 0] = 0
        l = mesh.facet_local[:, side]
        flip = mesh.facet_flip[:, side]
        for li in range(3):
            for fl in range(2):
                sel = (l == li) & (flip == fl)
                if not np.any(sel):
                    continue
                ref = facet_ref_points(li, fl, sq)  # (nqf, 2)
                lamf = np.stack([1.0 - ref[:, 0] - ref[:, 1], ref[:, 0], ref[:, 1]], axis=-1)
                xqf[sel, side] = np.einsum("ql,cld->cqd", lamf, mesh.cell_coords[c[sel]])

    bnd = np.zeros(nf)
    bnd[mesh.n_interior_facets:] = 1.0

    f = lambda a: torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
    return RTTables(
        P_opp=f(P_opp.transpose(1, 2, 0)),
        area=f(area),
        mass_elem=f(M.transpose(1, 2, 0)),
        mass_diag_inv=f(1.0 / Mdiag),
        xqf=f(xqf.transpose(1, 3, 2, 0)),
        bnd_mask=f(bnd),
        int_dof_mask=f(1.0 - bnd),
        fslot=facet_slots(disc.geom),
    )


def cell_dofs(geom, gdofs):
    """The dofs of each cell's facets: (nf,) -> (3, nc), unsigned."""
    return F.facets_ext(geom, gdofs)[geom.cell_facets]


def _signed_local(geom, gdofs):
    """Signed local dofs per cell: (3, nc)."""
    return cell_dofs(geom, gdofs) * geom.cfsign


def _scatter_cell_dofs(geom, rt, coeff):
    """Accumulate per-cell local-facet coefficients (3, nc) into (nf,): each
    facet's plus slot plus, on interior facets, its minus slot."""
    flat = F.cells_ext(geom, coeff).reshape(-1)
    return flat[rt.fslot[0]] + rt.int_dof_mask * flat[rt.fslot[1]]


def rt_cell_coeffs(geom, rt, gdofs):
    """Per-cell affine representation v(x) = a_c x - b_c: (a (nc,), b (2, nc))."""
    gl = _signed_local(geom, gdofs)
    a = torch.sum(gl, dim=0) / (2.0 * rt.area)
    b = torch.einsum("lc,ldc->dc", gl, rt.P_opp) / (2.0 * rt.area)[None, :]
    return a, b


def rt_eval(geom, rt, gdofs, x):
    """The RT field at per-cell points x (2, npts, nc)."""
    a, b = rt_cell_coeffs(geom, rt, gdofs)
    return a[None, None, :] * x - b[:, None, :]


def rt_eval_cellq(geom, rt, gdofs):
    """Values at the cell quadrature points (2, nq, nc)."""
    return rt_eval(geom, rt, gdofs, geom.xq)


def rt_facet_values(geom, rt, gdofs):
    """Both-side values at facet quadrature: (v_plus, v_minus), each (2, nqf,
    nf); the minus values of boundary facets are not data."""
    a, b = rt_cell_coeffs(geom, rt, gdofs)
    sides = F.gather_sides(geom, torch.cat([a[None], b]))
    return tuple(ab[0][None, None, :] * rt.xqf[side] - ab[1:][:, None, :]
                 for side, ab in enumerate(sides))


def rt_divergence(geom, rt, gdofs):
    """Cellwise-constant divergence: (nc,) = sum_l s_l g_l / A."""
    return torch.sum(_signed_local(geom, gdofs), dim=0) / rt.area


def rt_div_adjoint(geom, rt, q):
    """Adjoint of (cell values q) -> int q div(w): dof coefficients (nf,);
    int_K q div W_l = q_c (unit flux), so coeff(c, l) = s_l q_c."""
    return _scatter_cell_dofs(geom, rt, geom.cfsign * q[None, :])


def rt_mass_apply(geom, rt, gdofs):
    """Global RT mass matrix action (nf,) -> (nf,)."""
    y = torch.einsum("lmc,mc->lc", rt.mass_elem, cell_dofs(geom, gdofs))
    return _scatter_cell_dofs(geom, rt, y)


def rt_volume_adjoint(geom, rt, G):
    """Test coefficients of int_K G(x) . w dx for a quadrature-point field G
    (2, nq, nc): coeff(c, l) = s_l / (2A) int_K [G.x - G.P_l] dx."""
    wdet = geom.det_jac[None, :] * geom.wq[:, None]  # (nq, nc)
    S1 = torch.einsum("qc,dqc,dqc->c", wdet, G, geom.xq)  # int G.x
    S0 = torch.einsum("qc,dqc->dc", wdet, G)  # int G
    coeff = (S1[None, :] - torch.einsum("ldc,dc->lc", rt.P_opp, S0)) * geom.cfsign
    return _scatter_cell_dofs(geom, rt, coeff / (2.0 * rt.area)[None, :])


def rt_facet_adjoint(geom, rt, G0, G1):
    """Test coefficients of the facet integrals sum_f int_f G_side . w_side ds.

    :arg G0/G1: (2, nqf, nf) weights of the plus/minus side trace of the RT
        test function (G1 masked to interior facets by the caller)
    """
    w = geom.wqf[:, None] * geom.flen[None, :]  # (nqf, nf)
    A1 = [torch.einsum("qf,dqf,dqf->f", w, G, rt.xqf[side]) for side, G in ((0, G0), (1, G1))]
    A0 = [torch.einsum("qf,dqf->df", w, G) for G in (G0, G1)]
    Scell1 = F.gather_facet_contribs(geom, *A1)
    Scell0 = F.gather_facet_contribs(geom, *A0)
    coeff = (Scell1[None, :] - torch.einsum("ldc,dc->lc", rt.P_opp, Scell0)) * geom.cfsign
    return _scatter_cell_dofs(geom, rt, coeff / (2.0 * rt.area)[None, :])


def rt_to_dg1(geom, rt, gdofs):
    """An RT field in the (k=0) DG1 nodal velocity layout (2, 3, nc): the DG1
    nodes of the degree-0 discretisation are the cell vertices."""
    return rt_eval(geom, rt, gdofs, geom.xnodes1)


def rt_interpolate(disc, rt, fn):
    """RT interpolation of an expression ``fn(x, y) -> (fx, fy)``:
    g_f = int_f fn . n_f ds."""
    geom = disc.geom
    x = rt.xqf[0]  # plus-side coordinates (2, nqf, nf)
    fx, fy = fn(x[0], x[1])
    vals = torch.stack(torch.broadcast_tensors(torch.as_tensor(fx), torch.as_tensor(fy)))
    w = geom.wqf[:, None] * geom.flen[None, :]
    return torch.einsum("qf,dqf,df->f", w, vals.to(disc.dtype), geom.normal)
