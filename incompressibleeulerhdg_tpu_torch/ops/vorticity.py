"""Vorticity projection for the animation output.

Counterpart of incompressibleeulerhdg_tpu/ops/vorticity.py: the weak curl of
the DG velocity projected onto CG(k+1),

    (tau, xi)_CG = -int (d_x tau Q_y - d_y tau Q_x) dx
                   + oint tau (n_x Q_y - n_y Q_x) ds
"""

import torch

from . import fields as F
from ..fem.cg import cg_scatter, cg_mass_solve

__all__ = ["vorticity_project"]


def vorticity_project(disc, space, Q, gphi_cg, tphi_cg, rtol=1e-12):
    """Project the weak curl of Q onto the CG space.

    :arg gphi_cg: (nq, nloc, 2) reference gradients of the CG basis at the
        cell quadrature
    :arg tphi_cg: (6, nqf, nloc) facet traces of the CG basis
    :returns: (omega (n_dofs,), iters)
    """
    geom = disc.geom
    Qq = F.cell_values(geom.phi1, Q)  # (2, nq, nc)
    gphys = torch.einsum("qib,bac->aqic", gphi_cg, geom.jac_inv)  # (2, nq, nloc, nc)
    vol = (-torch.einsum("c,q,qic,qc->ic", geom.det_jac, geom.wq, gphys[0], Qq[1])
           + torch.einsum("c,q,qic,qc->ic", geom.det_jac, geom.wq, gphys[1], Qq[0]))
    b = cg_scatter(space, vol)

    # boundary: + tau (n_x Q_y - n_y Q_x) ds, on the plus side of boundary facets
    Q0 = F.facet_trace_plus(geom, geom.tphi1, Q)  # (2, nqf, nf)
    integrand = geom.normal[0][None, :] * Q0[1] - geom.normal[1][None, :] * Q0[0]
    bnd = 1.0 - F.interior_mask(geom)
    w = geom.wqf[:, None] * geom.flen[None, :]
    T0 = tphi_cg[geom.ftab[0]]  # (nf, nqf, nloc)
    contrib = torch.einsum("qf,fqi,qf->if", w, T0, integrand * bnd)
    loc = F.gather_facet_contribs(geom, contrib, torch.zeros_like(contrib))
    return cg_mass_solve(geom, space, b + cg_scatter(space, loc), rtol=rtol)
