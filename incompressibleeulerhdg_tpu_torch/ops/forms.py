"""Batched weak-form operators of the HDG incompressible Euler discretisation.

Counterpart of incompressibleeulerhdg_tpu/ops/forms.py (the forms of the
HDG IMEX and implicit schemes, projection and monolithic, and the DG
scheme's pressure coupling).  Each function
returns test-function coefficients of one form given trial fields as
coefficient arrays; the derivations are in the JAX package's docstrings.  The facet normal ``n_f`` points out of the plus
cell.
"""

import torch

from .fields import (
    cell_values,
    cell_div,
    facet_traces,
    facet_trace_plus,
    trace_values,
    scatter_facets,
    facet_integrate_trace,
    cell_integrate,
    interior_mask,
)

__all__ = [
    "star_fields",
    "f_impl_apply",
    "pressure_gradient_apply",
    "pressure_gradient_dg_apply",
    "gamma_apply",
    "weak_divergence_apply",
    "weak_divergence_values",
    "trace_mass_apply",
    "reconstruct_trace_rhs",
]


def _dot_normal(geom, v):
    """v[..., a, q, f] . n[a, f] -> (..., q, f)."""
    n = geom.normal
    return v[..., 0, :, :] * n[0] + v[..., 1, :, :] * n[1]


def star_fields(geom, Qstar):
    """(Q* coefficients (2, d1, nc), plus-trace normal component Q*("+").n at
    facet quadrature (nqf, nf))."""
    q0 = facet_trace_plus(geom, geom.tphi1, Qstar)
    return Qstar, _dot_normal(geom, q0)


def _convect(geom, star_q, u):
    """(Q*.grad) u at cell quadrature: (2, nq, nc)."""
    jinv = geom.jac_inv
    R = torch.stack(
        [jinv[b, 0] * star_q[0] + jinv[b, 1] * star_q[1] for b in (0, 1)]
    )  # (2=b, nq, nc)
    GP = torch.einsum("qjb,bqc->jqc", geom.gphi1, R)
    return torch.einsum("jqc,...jc->...qc", GP, u)


def f_impl_apply(geom, star, u, alpha=1.0, upwind=True):
    """Coefficients of ``f_impl(w, u, Q*)``:

    + int_dS (Q*+.n+)(u+ - u-).avg(w) - int_dx (w otimes Q*) : grad u
    - alpha [int_dS (1/h_F)((u+-u-).n)((w+-w-).n) + int_ds (1/h)(u.n)(w.n)]
    - upwind: int_dS |Q*+.n+| (u+-u-).(w+-w-)
    """
    star_coeff, star_n = star
    star_q = cell_values(geom.phi1, star_coeff)
    r = -cell_integrate(geom, geom.phi1, _convect(geom, star_q, u))

    u0, u1 = facet_traces(geom, geom.tphi1, u)  # (2, nqf, nf)
    mask = interior_mask(geom, 3)
    jump = (u0 - u1) * mask
    jn = _dot_normal(geom, jump)
    nrm = geom.normal[:, None, :]
    hinv = geom.hF_inv[None, :]

    g0 = 0.5 * star_n[None] * jump
    g1 = 0.5 * star_n[None] * jump
    pen = (alpha * hinv * jn)[None] * nrm
    g0 = g0 - pen
    g1 = g1 + pen
    if upwind:
        upw = torch.abs(star_n)[None] * jump
        g0 = g0 - upw
        g1 = g1 + upw
    u0n = _dot_normal(geom, u0)
    g0 = g0 - (alpha * hinv * u0n)[None] * nrm * (1.0 - mask)
    return r + scatter_facets(geom, geom.tphi1, g0, g1)


def _div_test_coeffs(geom, scalar_q):
    """Coefficients of int scalar * div(w) dx: (nq, nc) -> (2, d1, nc)."""
    t = torch.einsum("q,qib,qc->ibc", geom.wq, geom.gphi1, scalar_q)
    jinv = geom.jac_inv
    return geom.det_jac * torch.stack(
        [t[:, 0, :] * jinv[0, a] + t[:, 1, :] * jinv[1, a] for a in (0, 1)]
    )


def pressure_gradient_apply(geom, p, lam):
    """Coefficients of ``g(w, p, lambda) = int p div w - int_dS lambda
    (w+ - w-).n - int_ds lambda w.n``."""
    gw = _div_test_coeffs(geom, cell_values(geom.phi0, p))
    lam_q = trace_values(geom, lam)
    nrm = geom.normal[:, None, :]
    return gw + scatter_facets(geom, geom.tphi1, -lam_q[None] * nrm, lam_q[None] * nrm)


def pressure_gradient_dg_apply(geom, p):
    """u-row coefficients of the trace-free DG pressure coupling of the DG
    scheme: ``g_DG(w, p) = int p div w - int_dS (w+ - w-).n avg(p) - int_ds
    (w.n) p``."""
    gw = _div_test_coeffs(geom, cell_values(geom.phi0, p))
    p0, p1 = facet_traces(geom, geom.tphi0, p)
    pavg = torch.where(interior_mask(geom) > 0, 0.5 * (p0 + p1), p0)
    nrm = geom.normal[:, None, :]
    return gw + scatter_facets(geom, geom.tphi1, -pavg[None] * nrm, pavg[None] * nrm)


def gamma_apply(geom, u, p, lam, tau=1.0):
    """Coefficients of ``Gamma(psi, mu, u, p, lambda; tau)``:

    psi-rows: int psi div u + sum_sides tau (p_side - lambda) psi_side (dS)
              + tau (p - lambda) psi (ds)
    mu-rows:  int_dS mu [ (u+-u-).n + tau (p+ + p- - 2 lambda) ]
              + int_ds mu [ u.n + tau (p - lambda) ]
    """
    rp = cell_integrate(geom, geom.phi0, cell_div(geom, u))
    u0, u1 = facet_traces(geom, geom.tphi1, u)
    p0, p1 = facet_traces(geom, geom.tphi0, p)
    lam_q = trace_values(geom, lam)
    rp = rp + scatter_facets(geom, geom.tphi0, tau * (p0 - lam_q), tau * (p1 - lam_q))
    un0 = _dot_normal(geom, u0)
    un1 = _dot_normal(geom, u1)
    interior = (un0 - un1) + tau * (p0 + p1 - 2.0 * lam_q)
    boundary = un0 + tau * (p0 - lam_q)
    mask = interior_mask(geom)
    return rp, facet_integrate_trace(geom, torch.where(mask > 0, interior, boundary))


def weak_divergence_values(geom, Q_q, Qn0, Qn1):
    """psi-row coefficients of ``weak_div(psi, Q)`` from quadrature data:
    cell divergence (nq, nc) and plus/minus normal traces (nqf, nf)."""
    rp = cell_integrate(geom, geom.phi0, Q_q)
    mask = interior_mask(geom)
    jumpn = (Qn0 - Qn1) * mask
    g0 = -0.5 * jumpn - (1.0 - mask) * Qn0
    g1 = -0.5 * jumpn
    return rp + scatter_facets(geom, geom.tphi0, g0, g1)


def weak_divergence_apply(geom, Q):
    """psi-row coefficients of ``weak_div(psi, Q)`` for a DG velocity Q."""
    Q0, Q1 = facet_traces(geom, geom.tphi1, Q)
    return weak_divergence_values(
        geom, cell_div(geom, Q), _dot_normal(geom, Q0), _dot_normal(geom, Q1)
    )


def trace_mass_apply(geom, lam, tau=1.0):
    """Trace 'mass' operator ``2 tau (lam+, mu+) dS + tau (lam, mu) ds``."""
    fac = tau * (1.0 + interior_mask(geom, 1))  # 2 tau interior, tau boundary
    return fac[None, :] * facet_integrate_trace(geom, trace_values(geom, lam))


def reconstruct_trace_rhs(geom, Q, p, tau=1.0):
    """RHS of the t=0 trace reconstruction: (nt, nf)."""
    Q0, Q1 = facet_traces(geom, geom.tphi1, Q)
    p0, p1 = facet_traces(geom, geom.tphi0, p)
    un0 = _dot_normal(geom, Q0)
    un1 = _dot_normal(geom, Q1)
    mask = interior_mask(geom)
    interior = (un0 - un1) + tau * (p0 + p1)
    boundary = un0 + tau * p0
    return facet_integrate_trace(geom, torch.where(mask > 0, interior, boundary))
