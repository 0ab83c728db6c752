"""BDM projection: H(div)-conforming averaging of a DG velocity.

Counterpart of incompressibleeulerhdg_tpu/ops/projection.py.  The setup
(:func:`build_bdm_projection`) is host numpy: averaged facet normal moments
against Legendre polynomials plus interior Nedelec moments, inverted per
cell geometry class.  :func:`project_bdm` applies the three batched steps
(facet moments, interior moments, per-class reconstruction).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.lagrange import shifted_legendre
from .fields import cell_values, facet_traces, interior_mask, slot_values

__all__ = [
    "BDMProjection",
    "build_bdm_projection",
    "project_bdm",
    "cell_geometry_classes",
    "amajor_perm",
    "apply_class_blocks",
]


@dataclass
class BDMProjection:
    """Device tables of the BDM(k+1) projection."""

    leg: torch.Tensor  # (nqf, r+1) orthonormal Legendre at facet quadrature
    vhat: torch.Tensor  # (nj, nq, 2) Nedelec span on the reference cell
    recon: torch.Tensor  # (n_classes, 2*d1, 2*d1) reconstruction matrices
    class_id: torch.Tensor  # (nc,) int64
    n_moments: int = 0
    n_interior_dofs: int = 0


def _nedelec_span(m, qp):
    """Spanning set of the first-kind Nedelec space N1_m at points qp:
    (m (m + 2), npts, 2); m = 0 gives an empty set."""
    if m == 0:
        return np.zeros((0, qp.shape[0], 2))
    x, y = qp[:, 0], qp[:, 1]
    vs = []
    for tot in range(m):
        for i in range(tot + 1):
            mono = x**i * y ** (tot - i)
            vs.append(np.stack([mono, np.zeros_like(mono)], -1))
            vs.append(np.stack([np.zeros_like(mono), mono], -1))
    for i in range(m):
        h = x**i * y ** (m - 1 - i)
        vs.append(np.stack([-y * h, x * h], -1))
    return np.stack(vs)


def amajor_perm(d1):
    """Permutation from i-major (i*2+a) local u-dofs to the component-major
    (a*d1+i) batch-last convention."""
    return np.array([i * 2 + a for a in range(2) for i in range(d1)])


def cell_geometry_classes(mesh):
    """(class_id (nc,), representative cells): cells with equal Jacobian,
    facet flips, facet sides and boundary pattern share every element matrix."""
    flips = mesh.facet_flip[mesh.cell_facets, mesh.cell_facet_side]
    bnd = (mesh.cell_facets >= mesh.n_interior_facets).astype(np.int64)
    sig = np.concatenate(
        [
            np.round(mesh.jac.reshape(-1, 4), 12),
            flips.astype(np.float64),
            mesh.cell_facet_side.astype(np.float64),
            bnd.astype(np.float64),
        ],
        axis=1,
    )
    view = np.ascontiguousarray(sig).view([("", sig.dtype)] * sig.shape[1]).ravel()
    _, reps, class_id = np.unique(view, return_index=True, return_inverse=True)
    return class_id.astype(np.int64).ravel(), reps


def build_bdm_projection(disc):
    """Build the BDMProjection tables of an HDGDiscretisation (host numpy)."""
    mesh = disc.mesh
    k = disc.degree
    r = k + 1
    V1, Vt = disc.V1, disc.Vt
    d1 = V1.ndof
    n = 2 * d1
    nm = r + 1
    nj = (r - 1) * (r + 1)

    leg = shifted_legendre(r, Vt.sq)
    vhat = _nedelec_span(r - 1, V1.qp)
    class_id, reps = cell_geometry_classes(mesh)

    nc_r = reps.shape[0]
    D = np.zeros((nc_r, n, n))
    jac_inv = mesh.jac_inv[reps]
    det = mesh.det_jac[reps]
    for l in range(3):
        f = mesh.cell_facets[reps, l]
        side = mesh.cell_facet_side[reps, l]
        flip = mesh.facet_flip[f, side]
        tab = V1.tphi[2 * l + flip]
        sign = np.where(side == 0, 1.0, -1.0)
        n_out = sign[:, None] * mesh.normals[f]
        L = mesh.facet_lengths[f]
        rows = np.einsum("c,q,qm,cqi,ca->cmia", L, Vt.wq, leg, tab, n_out)
        D[:, l * nm : (l + 1) * nm, :] = rows.reshape(nc_r, nm, n)
    if nj > 0:
        rows = np.einsum("c,q,qi,cba,jqb->cjia", det, V1.qw, V1.phi, jac_inv, vhat)
        D[:, 3 * nm :, :] = rows.reshape(nc_r, nj, n)
    recon = np.linalg.inv(D)[:, amajor_perm(d1), :]

    dev, dt = disc.device, disc.dtype
    return BDMProjection(
        leg=torch.as_tensor(leg, dtype=dt, device=dev),
        vhat=torch.as_tensor(vhat, dtype=dt, device=dev),
        recon=torch.as_tensor(recon, dtype=dt, device=dev),
        class_id=torch.as_tensor(class_id, device=dev),
        n_moments=nm,
        n_interior_dofs=nj,
    )


CLASS_LOOP_MAX = 16  # the JAX package's switch (projection.py:210, condense.py:238)


def apply_class_blocks(tables, class_id, x):
    """y[:, c] = tables[class_id[c]] @ x[:, c].  Up to ``CLASS_LOOP_MAX``
    geometry classes (the structured meshes): one (m, n) x (n, nc) product
    per class, selected by class id.  Above it (the unit disk, thousands of
    classes) the per-class products would cost O(ncls * nc): gather each
    cell's block and contract once."""
    if tables.shape[0] > CLASS_LOOP_MAX:
        return torch.einsum("cij,jc->ic", tables[class_id], x)
    out = x.new_zeros((tables.shape[1], x.shape[1]))
    for k in range(tables.shape[0]):
        out = torch.where((class_id == k)[None, :], tables[k] @ x, out)
    return out


def project_bdm(geom, proj, Q):
    """Apply the BDM projection: (2, d1, nc) -> (2, d1, nc)."""
    d1 = geom.d1
    # (1) averaged facet normal moments, zero on boundary facets
    Q0, Q1 = facet_traces(geom, geom.tphi1, Q)
    mask = interior_mask(geom, 1)
    n = geom.normal
    qsum = Q0 + Q1
    avg_n = 0.5 * (qsum[0] * n[0] + qsum[1] * n[1]) * mask[None, :]
    w = geom.wqf[:, None] * geom.flen[None, :]
    m_f = torch.einsum("qm,qf->mf", proj.leg, w * avg_n)  # (nm, nf)

    # (2) interior Nedelec moments
    if proj.n_interior_dofs > 0:
        Qq = cell_values(geom.phi1, Q)
        jinv = geom.jac_inv
        im = 0.0
        for b in (0, 1):
            Vb = jinv[b, 0] * Qq[0] + jinv[b, 1] * Qq[1]
            im = im + torch.einsum("q,jq,qc->jc", geom.wq, proj.vhat[:, :, b], Vb)
        im = geom.det_jac * im
    else:
        im = Q.new_zeros((0, geom.n_cells))

    # (3) per-cell dofs (sign-corrected to the outward normal), reconstruct
    mf_cell = [s * geom.cfsign[l][None, :] for l, s in enumerate(slot_values(geom, m_f))]
    dofs = torch.cat(mf_cell + [im], dim=0)
    sol = apply_class_blocks(proj.recon, proj.class_id, dofs)
    return sol.reshape(2, d1, geom.n_cells)
