"""Right-hand side of the IMEX pressure reconstruction solve.

Counterpart of incompressibleeulerhdg_tpu/ops/reconstruction.py:

    weak_div(psi, -f + (grad Q) Q) - mu (n . f) ds

with Q the new velocity and f the forcing at t + dt, both (2, d1, nc).
"""

import torch

from . import fields as F
from .forms import weak_divergence_values

__all__ = ["pressure_reconstruction_rhs", "facet_grad_traces"]


def facet_grad_traces(geom, u):
    """Physical gradient traces of a DG(k+1) field at facet quadrature:
    (g_plus, g_minus), each (..., 2, nqf, nf) with the derivative direction
    before nqf."""
    out = []
    ugs = F.gather_sides(geom, u)  # (..., d1, nf) each
    jinvs = F.gather_sides(geom, F.table_ext(geom, "jac_inv"), ext=True)  # (2=b, 2=a, nf)
    for side, ug, jinv in zip((0, 1), ugs, jinvs):
        U = geom.tgphi1[geom.ftab[side]]  # (nf, nqf, d1, 2)
        gref = torch.einsum("fqib,...if->...bqf", U, ug)
        out.append(torch.stack(
            [gref[..., 0, :, :] * jinv[0, a] + gref[..., 1, :, :] * jinv[1, a]
             for a in (0, 1)],
            dim=-3,
        ))
    return out[0], out[1]


def pressure_reconstruction_rhs(geom, Q, f_nodal):
    """(psi-rows (d0, nc), mu-rows (nt, nf)) of the reconstruction solve."""
    gQ = F.cell_grads(geom, geom.gphi1, Q)  # (2 a, 2 d, nq, nc)
    Qq = F.cell_values(geom.phi1, Q)  # (2, nq, nc)
    href = torch.einsum("qibf,aic->abfqc", geom.hphi1, Q)
    jinv = geom.jac_inv

    def hp(a, d, e):
        return sum(href[a, b, f] * (jinv[b, d] * jinv[f, e]) for b in (0, 1) for f in (0, 1))

    # div((grad Q) Q) = (d_a d_b Q_a) Q_b + (d_b Q_a)(d_a Q_b)
    term1 = sum(hp(a, a, b) * Qq[b] for a in (0, 1) for b in (0, 1))
    term2 = sum(gQ[a, d] * gQ[d, a] for a in (0, 1) for d in (0, 1))
    divG = -F.cell_div(geom, f_nodal) + term1 + term2

    f0, f1 = F.facet_traces(geom, geom.tphi1, f_nodal)
    Q0, Q1 = F.facet_traces(geom, geom.tphi1, Q)
    g0, g1 = facet_grad_traces(geom, Q)
    G0 = torch.stack([g0[a, 0] * Q0[0] + g0[a, 1] * Q0[1] for a in (0, 1)]) - f0
    G1 = torch.stack([g1[a, 0] * Q1[0] + g1[a, 1] * Q1[1] for a in (0, 1)]) - f1
    n = geom.normal
    Gn0 = G0[0] * n[0] + G0[1] * n[1]
    Gn1 = G1[0] * n[0] + G1[1] * n[1]
    f_p = weak_divergence_values(geom, divG, Gn0, Gn1)

    fn0 = f0[0] * n[0] + f0[1] * n[1]
    f_lam = -F.facet_integrate_trace(geom, fn0 * (1.0 - F.interior_mask(geom)))
    return f_p, f_lam
