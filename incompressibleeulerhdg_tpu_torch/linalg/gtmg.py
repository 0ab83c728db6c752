"""Two-level preconditioner for the condensed trace system, structured path.

Counterpart of incompressibleeulerhdg_tpu/linalg/gtmg.py on structured
unit-square meshes (``fft_neumann``): Chebyshev over facet-block Jacobi on
the fine trace level, an exact FFT-diagonalised solve of the P1 coarse
Laplacian (DCT-I on ``torch.fft``), and linear interpolation along facets
between them, read as slices/shifts of the vertex grid.  The set-up
(spectral bounds by power iteration, the coarse spectrum) is host numpy with
the same seeded generator as the JAX package, so both build equal tables.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.triangle_mesh import LOCAL_FACET_VERTS
from ..ops.structured import shift2, rect_flat
from .condense import trace_matvec

__all__ = ["TwoLevelTracePC", "build_gtmg", "gtmg_apply", "prolong", "restrict"]


@dataclass
class TwoLevelTracePC:
    Sdiag_inv: torch.Tensor  # (nt, nt, nf) batch-last
    trace_nodes: torch.Tensor  # (nt,) nodal positions on [0, 1]
    sign: float  # sign making sign * S positive semidefinite
    coarse_eig_inv: torch.Tensor  # (Mx, My) inverse coarse spectrum
    coarse_scale: torch.Tensor  # (Mx * My,) boundary-row scaling
    vshift: tuple  # (Mx, My, wrap, groups): facet endpoint vertex offsets
    n_vertices: int = 0
    grid_shape: tuple = None
    cheb_fine: int = 2
    lmax_fine: float = 1.0


def _facet_endpoints(mesh):
    """Endpoint vertex ids of every facet in canonical (flip-bit) order."""
    cp = mesh.facet_cells[:, 0]
    lp = mesh.facet_local[:, 0]
    va = mesh.cells[cp, LOCAL_FACET_VERTS[lp, 0]]
    vb = mesh.cells[cp, LOCAL_FACET_VERTS[lp, 1]]
    fl = mesh.facet_flip[:, 0].astype(bool)
    return np.stack([np.where(fl, vb, va), np.where(fl, va, vb)], axis=1)


def _vertex_shift_groups(mesh):
    """``(Mx, My, wrap, groups)``: per facet group of the shift spec (colours
    then boundary groups, in facet order) the constant vertex-grid offsets
    ``(dlo, dhi)`` of its endpoints; raises if the mesh has none."""
    spec = mesh.shift_spec
    kind, Mx, My = mesh.structured_grid
    wrap = kind == "periodic"
    fv = _facet_endpoints(mesh)
    bounds = mesh.facet_color_bounds
    items = [(bounds[k], bounds[k + 1], *col[2:6]) for k, col in enumerate(spec[4])]
    items += [(f0, f0 + ni * nj, i0, j0, ni, nj) for (h, l, i0, j0, ni, nj, f0) in spec[5]]
    groups = []
    for (f0, f1, i0, j0, ni, nj) in items:
        pi = i0 + np.repeat(np.arange(ni), nj)
        pj = j0 + np.tile(np.arange(nj), ni)
        offs = []
        for e in range(2):
            v = fv[f0:f1, e]
            di, dj = v // My - pi, v % My - pj
            if wrap:
                di = (di + Mx // 2) % Mx - Mx // 2
                dj = (dj + My // 2) % My - My // 2
            if v.size == 0 or not (np.all(di == di[0]) and np.all(dj == dj[0])):
                raise ValueError("facet endpoints are not a vertex-grid shift")
            offs.append((int(di[0]), int(dj[0])))
        groups.append((f0, f1, i0, j0, ni, nj, offs[0], offs[1]))
    return (int(Mx), int(My), wrap, tuple(groups))


def build_gtmg(disc, cs, cheb_fine=2, power_iters=25):
    """Build the two-level preconditioner of a structured unit-square mesh
    (host set-up; ``build_condensed_system`` must have run on ``disc``)."""
    mesh = disc.mesh
    sg = getattr(mesh, "structured_grid", None)
    if sg is None or sg[0] != "neumann" or mesh.shift_spec is None:
        raise NotImplementedError("the port's GTMG covers structured unit-square meshes")
    rng = np.random.default_rng(7)
    S_np = disc.cs_host["S"]
    Sdiag_inv_np = disc.cs_host["Sdiag_inv"]
    cf = mesh.cell_facets
    nt = S_np.shape[-1] // 3

    def trace_mv_np(lam):
        y_c = np.einsum("cij,cj->ci", S_np, lam[cf].reshape(mesh.n_cells, -1))
        out = np.zeros_like(lam)
        np.add.at(out, cf, y_c.reshape(mesh.n_cells, 3, nt))
        return out

    nf = mesh.n_facets
    x = rng.standard_normal((nf, nt))
    sign = float(np.sign(np.vdot(x, trace_mv_np(x))))

    def fine_op(v):
        return np.einsum("fij,fj->fi", Sdiag_inv_np, trace_mv_np(v))

    v = rng.standard_normal((nf, nt))
    for _ in range(power_iters):
        v = fine_op(v)
        v = v / np.linalg.norm(v)
    lmax_fine = float(np.vdot(v, fine_op(v)))

    # exact spectral inverse of the structured P1 Laplacian (DCT-I, Neumann);
    # boundary rows are half/quarter stencils, undone by coarse_scale
    Mx, My = sg[1], sg[2]
    xs = mesh.vertices[:, 0].reshape(Mx, My)
    ys = mesh.vertices[:, 1].reshape(Mx, My)
    hx = float(xs[1, 0] - xs[0, 0])
    hy = float(ys[0, 1] - ys[0, 0])
    lx = (hy / hx) * (2.0 - 2.0 * np.cos(np.pi * np.arange(Mx) / (Mx - 1)))
    ly = (hx / hy) * (2.0 - 2.0 * np.cos(np.pi * np.arange(My) / (My - 1)))
    lam2 = lx[:, None] + ly[None, :]
    lam2[0, 0] = 1.0
    inv = 1.0 / lam2
    inv[0, 0] = 0.0  # constant mode deflated
    wgt = np.ones((Mx, My))
    wgt[0, :] *= 0.5
    wgt[-1, :] *= 0.5
    wgt[:, 0] *= 0.5
    wgt[:, -1] *= 0.5

    f = lambda a: torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
    return TwoLevelTracePC(
        Sdiag_inv=cs.Sdiag_inv,
        trace_nodes=f(disc.Vt.nodes),
        sign=sign,
        coarse_eig_inv=f(inv),
        coarse_scale=f(1.0 / wgt).ravel(),
        vshift=_vertex_shift_groups(mesh),
        n_vertices=mesh.n_vertices,
        grid_shape=(Mx, My),
        cheb_fine=cheb_fine,
        lmax_fine=abs(lmax_fine),
    )


def _chebyshev(apply_A, apply_Minv, r, niter, lmax):
    """Chebyshev iteration for A z = r targeting [0.1 lmax, 1.1 lmax]."""
    lmin = 0.1 * lmax
    lmax = 1.1 * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    z = apply_Minv(r) / theta
    if niter == 1:
        return z
    d = z
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(niter - 1):
        res = apply_Minv(r - apply_A(z))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * res
        rho = rho_new
        z = z + d
    return z


def _dct1_2d(u):
    """2-D DCT-I via the FFT of the even extension; involutive up to
    4 (Nx - 1)(Ny - 1)."""
    v = torch.cat([u, u[1:-1].flip(0)], dim=0)
    v = torch.cat([v, v[:, 1:-1].flip(1)], dim=1)
    return torch.fft.fft2(v).real[: u.shape[0], : u.shape[1]]


def _coarse_solve(pc, rc):
    """Exact spectral inverse of the structured P1 coarse Laplacian."""
    Mx, My = pc.grid_shape
    u = (rc * pc.coarse_scale).reshape(Mx, My)
    c = _dct1_2d(u) * pc.coarse_eig_inv
    return (_dct1_2d(c) / (4.0 * (Mx - 1) * (My - 1))).reshape(-1)


def prolong(pc, zc):
    """P1 vertex values -> trace dofs by linear interpolation along each
    facet: (nv,) -> (nt, nf)."""
    Mx, My, wrap, groups = pc.vshift
    zg = zc.reshape(Mx, My)
    lo = torch.cat([rect_flat(shift2(zg, g[6], wrap), g[2:6]) for g in groups])
    hi = torch.cat([rect_flat(shift2(zg, g[7], wrap), g[2:6]) for g in groups])
    s = pc.trace_nodes[:, None]
    return lo[None, :] * (1.0 - s) + hi[None, :] * s


def restrict(pc, lam):
    """Adjoint of :func:`prolong`: (nt, nf) -> (nv,)."""
    Mx, My, wrap, groups = pc.vshift
    s = pc.trace_nodes[:, None]
    a_lo = torch.sum(lam * (1.0 - s), dim=0)
    a_hi = torch.sum(lam * s, dim=0)
    acc = lam.new_zeros((Mx, My))
    for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
        for arr, d in ((a_lo, dlo), (a_hi, dhi)):
            seg = arr[f0:f1].reshape(ni, nj)
            pad = torch.nn.functional.pad(seg, (j0, My - j0 - nj, i0, Mx - i0 - ni))
            acc = acc + shift2(pad, (-d[0], -d[1]), wrap)
    return acc.reshape(-1)


def gtmg_apply(geom, cs, pc, r_flat):
    """Multiplicative two-level V-cycle approximating S^{-1} r (flat
    (nt, nf) trace vectors)."""
    nt = cs.nt
    sign = pc.sign
    r = (sign * r_flat).reshape(nt, -1)

    def A(v):
        return sign * trace_matvec(geom, cs, v)

    def Dinv(v):
        return sign * torch.einsum("ijf,jf->if", cs.Sdiag_inv, v)

    z = _chebyshev(A, Dinv, r, pc.cheb_fine, pc.lmax_fine)
    zc = _coarse_solve(pc, restrict(pc, r - A(z)))
    z = z + prolong(pc, zc)
    z = z + _chebyshev(A, Dinv, r - A(z), pc.cheb_fine, pc.lmax_fine)
    return (sign * z).reshape(-1)
