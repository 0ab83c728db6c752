"""Batched static condensation of the HDG mixed-Poisson operator.

Counterpart of incompressibleeulerhdg_tpu/linalg/condense.py.  The element
blocks of

    a((u,p,lam),(w,psi,mu)) = (w,u) - g(w,p,lam) + Gamma(psi,mu,u,p,lam)

are constant in time and formed once on the host (numpy) per cell geometry
class; the per-cell trace Schur blocks S_c = D_c - C_c A_c^{-1} B_c are
stored batch-last (3nt, 3nt, nc) on the device, and the trace operator is
their facet-scatter sum.  Cell<->facet moves are slot slices on structured
meshes and index gathers on the others (the JAX package's two branches),
with the ghost entries of a partition-local geometry appended first.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fields import cells_ext, interior_mask, slot_values
from ..ops.projection import cell_geometry_classes, amajor_perm, apply_class_blocks
from ..ops.structured import slot_scatter

__all__ = [
    "CondensedSystem",
    "build_condensed_system",
    "trace_matvec",
    "condense_rhs",
    "back_substitute",
]


@dataclass
class CondensedSystem:
    S: torch.Tensor  # (3nt, 3nt, nc) per-cell trace Schur blocks, batch-last
    Ainv: torch.Tensor  # (ncls, nloc, nloc); u-dofs component-major
    AinvB: torch.Tensor  # (ncls, nloc, 3nt)
    CAinv: torch.Tensor  # (ncls, 3nt, nloc)
    class_id: torch.Tensor  # (nc,) int64
    Sdiag_inv: torch.Tensor  # (nt, nt, nf) inverse facet-diagonal blocks
    nullvec: torch.Tensor  # (nt, nf) unit constant-trace nullspace of S
    tau: float = 1.0
    nt: int = 1


def build_element_blocks(disc, reps, tau):
    """Dense element blocks (A, B, C, D) of the representative cells (numpy)."""
    mesh, V1, V0, Vt = disc.mesh, disc.V1, disc.V0, disc.Vt
    d1, d0, nt = V1.ndof, V0.ndof, Vt.ndof
    nu = 2 * d1
    nloc = nu + d0
    ncr = reps.shape[0]
    det = mesh.det_jac[reps]
    jinv = mesh.jac_inv[reps]
    gphys = np.einsum("qib,cba->cqia", V1.gphi, jinv)

    A = np.zeros((ncr, nloc, nloc))
    B = np.zeros((ncr, nloc, 3 * nt))
    C = np.zeros((ncr, 3 * nt, nloc))
    D = np.zeros((ncr, 3 * nt, 3 * nt))

    Muu = np.einsum("c,q,qi,qj->cij", det, V1.qw, V1.phi, V1.phi)
    for a in range(2):
        A[:, a:nu:2, a:nu:2] = Muu
    div_blk = np.einsum("c,q,qp,cqia->cpia", det, V1.qw, V0.phi, gphys)
    A[:, :nu, nu:] = -div_blk.reshape(ncr, d0, nu).transpose(0, 2, 1)
    A[:, nu:, :nu] = div_blk.reshape(ncr, d0, nu)

    for l in range(3):
        f = mesh.cell_facets[reps, l]
        side = mesh.cell_facet_side[reps, l]
        flip = mesh.facet_flip[f, side]
        T1 = V1.tphi[2 * l + flip]
        T0 = V0.tphi[2 * l + flip]
        sgn = np.where(side == 0, 1.0, -1.0)
        n_out = sgn[:, None] * mesh.normals[f]
        L = mesh.facet_lengths[f]
        w = L[:, None] * Vt.wq[None, :]
        A[:, nu:, nu:] += tau * np.einsum("cq,cqa,cqb->cab", w, T0, T0)
        sl = slice(l * nt, (l + 1) * nt)
        Bu = np.einsum("cq,qm,cqi,ca->cima", w, Vt.tr, T1, n_out)
        Bu_cols = Bu.transpose(0, 1, 3, 2).reshape(ncr, nu, nt)
        B[:, :nu, sl] = Bu_cols
        Bp = np.einsum("cq,qm,cqa->cma", w, Vt.tr, T0)
        B[:, nu:, sl] = -tau * Bp.transpose(0, 2, 1)
        C[:, sl, :nu] = Bu_cols.transpose(0, 2, 1)
        C[:, sl, nu:] = tau * Bp
        D[:, sl, sl] = -tau * np.einsum("cq,qm,qn->cmn", w, Vt.tr, Vt.tr)
    return A, B, C, D


def build_condensed_system(disc, tau=1.0):
    """Condense the mixed-Poisson HDG operator (host numpy, then the device).

    Also returns, in ``disc.cs_host``, float64 host copies of S (nc, 3nt,
    3nt) and Sdiag_inv (nf, nt, nt) for the GTMG set-up's spectral estimates.
    """
    mesh = disc.mesh
    nt = disc.Vt.ndof
    class_id, reps = cell_geometry_classes(mesh)
    A, B, C, D = build_element_blocks(disc, reps, tau)

    Ainv = np.linalg.inv(A)
    AinvB = Ainv @ B
    CAinv = C @ Ainv
    S = (D - C @ AinvB)[class_id]

    d1 = disc.V1.ndof
    perm = np.concatenate([amajor_perm(d1), 2 * d1 + np.arange(disc.V0.ndof)])
    Ainv = Ainv[:, perm][:, :, perm]
    AinvB = AinvB[:, perm, :]
    CAinv = CAinv[:, :, perm]

    nf = mesh.n_facets
    Sdiag = np.zeros((nf, nt, nt))
    for l in range(3):
        sl = slice(l * nt, (l + 1) * nt)
        np.add.at(Sdiag, mesh.cell_facets[:, l], S[:, sl, sl])
    Sdiag_inv = np.linalg.inv(Sdiag)
    nullvec = np.ones((nt, nf))
    nullvec /= np.linalg.norm(nullvec)
    disc.cs_host = {"S": S, "Sdiag_inv": Sdiag_inv}

    f = lambda a: torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
    return CondensedSystem(
        S=f(S.transpose(1, 2, 0)),
        Ainv=f(Ainv),
        AinvB=f(AinvB),
        CAinv=f(CAinv),
        class_id=torch.as_tensor(class_id, device=disc.device),
        Sdiag_inv=f(Sdiag_inv.transpose(1, 2, 0)),
        nullvec=f(nullvec),
        tau=float(tau),
        nt=int(nt),
    )


def _facets_from_cells(geom, y_c):
    """Facet assembly of per-cell (3nt, nc) contributions -> (nt, nf)."""
    nt = y_c.shape[0] // 3
    if geom.shift is not None:
        return slot_scatter(geom, [y_c[l * nt : (l + 1) * nt] for l in range(3)])
    # each facet reads its plus and (interior) minus cell's slot of the
    # facet's local index on that side
    y_c = cells_ext(geom, y_c)
    blocks = [y_c[l * nt : (l + 1) * nt] for l in range(3)]
    fl = geom.ftab // 2
    msk = interior_mask(geom, 2)
    out = 0.0
    for l in range(3):
        sel0 = (fl[0] == l).to(y_c.dtype)[None, :]
        sel1 = (fl[1] == l).to(y_c.dtype)[None, :] * msk
        out = out + sel0 * blocks[l][:, geom.fcells[0]] + sel1 * blocks[l][:, geom.fcells[1]]
    return out


def _cells_from_facets(geom, lam):
    """Per-cell trace dofs: (nt, nf) -> (3nt, nc), local facet major."""
    return torch.cat(slot_values(geom, lam), dim=0)


def trace_matvec(geom, cs, lam):
    """Condensed trace operator: (nt, nf) -> (nt, nf)."""
    y_c = torch.einsum("ijc,jc->ic", cs.S, _cells_from_facets(geom, lam))
    return _facets_from_cells(geom, y_c)


def _flatten_local(f_u, f_p):
    """(2, d1, nc) u-rows + (d0, nc) p-rows -> (nloc, nc)."""
    return torch.cat([f_u.reshape(-1, f_u.shape[-1]), f_p], dim=0)


def condense_rhs(geom, cs, f_u, f_p, f_lam):
    """Condensed right-hand side g = f_lam - C A^{-1} f_loc: (nt, nf)."""
    contrib = apply_class_blocks(cs.CAinv, cs.class_id, _flatten_local(f_u, f_p))
    return f_lam - _facets_from_cells(geom, contrib)


def back_substitute(geom, cs, f_u, f_p, lam):
    """Recover (u, p) from the trace solution: x = A^{-1}(f_loc - B lam)."""
    x = apply_class_blocks(cs.Ainv, cs.class_id, _flatten_local(f_u, f_p)) - (
        apply_class_blocks(cs.AinvB, cs.class_id, _cells_from_facets(geom, lam))
    )
    d1 = geom.d1
    return x[: 2 * d1].reshape(2, d1, -1), x[2 * d1 :]
