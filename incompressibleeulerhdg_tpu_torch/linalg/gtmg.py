"""Two-level preconditioner for the condensed trace system.

Counterpart of incompressibleeulerhdg_tpu/linalg/gtmg.py: a multiplicative
V-cycle of Chebyshev smoothing on the fine trace level, a solve of the P1
coarse Laplacian, and linear interpolation along facets between them.

- smoother: Chebyshev over facet-block Jacobi on structured meshes; over
  additive vertex-star patches (exact dense solves of the trace operator
  restricted to each vertex's facets) on the others, up to 65,536 vertices;
- coarse solve: exact spectral inverse of the structured P1 Laplacian
  (``fft_neumann``: DCT-I on ``torch.fft``; ``fft_periodic``: FFT), else a
  dense pseudo-inverse up to 8,192 vertices, else Chebyshev over Jacobi
  (``cheb``);
- transfers: slices and shifts of the vertex grid on structured meshes,
  index gathers through the padded vertex adjacency on the others.  On a
  slab-local layout (``dist``, parallel/slab.py) the restriction fills a
  canvas of the slab's nxl + 1 vertex rows, embeds it at row ``rank *
  nxl`` of the global grid and sums it over the ranks (neighbouring slabs
  share one vertex row, which the sum resolves): the coarse residual is
  the one replicated object of the distributed solve, and the coarse solve
  runs replicated on every rank.  On a partition-local layout (``part``,
  parallel/partition.py) the restriction sums each vertex's own facets'
  ends in the single device's order (one rank holds every facet of an
  interior vertex, so its sum is the single device's), places them in a
  vector of every vertex and sums that over the ranks, the
  coarse solve (FFT, dense or Chebyshev, its vertex tables replicated)
  runs on every rank, and the prolongation reads the replicated result at
  the own facets' ends; the vertex-star smoother solves the stars of the
  own facets' ends, reading the facets of those stars that other ranks own
  as ghosts (one exchange per application).

The set-up (spectral bounds by power iteration, the star inverses, the
coarse spectrum) is host numpy with the same seeded generator as the JAX
package, so both build equal tables.
"""

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.triangle_mesh import LOCAL_FACET_VERTS
from ..ops.structured import shift2, rect_flat
from .condense import trace_matvec

__all__ = ["TwoLevelTracePC", "build_gtmg", "gtmg_apply", "prolong", "restrict"]

STAR_MAX_VERTICES = 65536  # the vertex-star set-up gate (JAX gtmg.py:357)
DENSE_COARSE_MAX_VERTICES = 8192  # the dense pseudo-inverse gate (gtmg.py:423)


@dataclass
class TwoLevelTracePC:
    Sdiag_inv: torch.Tensor  # (nt, nt, nf) batch-last
    trace_nodes: torch.Tensor  # (nt,) nodal positions on [0, 1]
    sign: float  # sign making sign * S positive semidefinite
    facet_verts: torch.Tensor  # (2, nf) endpoint vertex ids, canonical order
    K_elem: torch.Tensor  # (3, 3, nc) P1 stiffness element matrices
    cells: torch.Tensor  # (3, nc) vertex ids
    K_diag_inv: torch.Tensor  # (nv,)
    # padded vertex adjacency (gather-based assembly)
    vf: torch.Tensor  # (nv, Dv) facet ids touching each vertex
    vf_end: torch.Tensor  # (nv, Dv) 0: the vertex is the facet's lo end, 1: hi
    vf_mask: torch.Tensor  # (nv, Dv) 1.0 on valid entries
    vc: torch.Tensor  # (nv, Dc) cell ids touching each vertex
    vc_pos: torch.Tensor  # (nv, Dc) local vertex index within the cell
    vc_mask: torch.Tensor  # (nv, Dc)
    coarse_eig_inv: torch.Tensor = None  # inverse coarse spectrum (fft kinds)
    coarse_scale: torch.Tensor = None  # (nv,) boundary-row scaling (fft_neumann)
    star_inv: torch.Tensor = None  # (Dv*nt, Dv*nt, nv) vertex-star inverses
    star_pos: torch.Tensor = None  # (2, nf) position of each facet in its end stars
    coarse_dense_inv: torch.Tensor = None  # (nv, nv) pseudo-inverse of the P1 Laplacian
    vshift: tuple = None  # (Mx, My, wrap, groups): facet endpoint vertex offsets
    # slab-local transfers: (comm, n_slabs, Mx, My, canvas rows, local groups, wrap)
    dist: tuple = None
    # partition-local transfers (parallel/partition.py ``PartitionTransfers``);
    # vf, vf_mask and star_inv then hold the stars of the vertices the own
    # facets end at only, vf indexing [own | ghost] facets
    part: object = None
    n_vertices: int = 0
    coarse_kind: str = "cheb"  # "cheb" | "fft_neumann" | "fft_periodic"
    grid_shape: tuple = None
    cheb_fine: int = 2
    cheb_coarse: int = 25
    lmax_fine: float = 1.0
    lmax_coarse: float = 1.0


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
    ``(dlo, dhi)`` of its endpoints, wrapped on periodic meshes; None when
    the mesh has no shift structure or its endpoints are not grid shifts."""
    spec = getattr(mesh, "shift_spec", None)
    sg = getattr(mesh, "structured_grid", None)
    if spec is None or sg is None:
        return None
    kind, Mx, My = sg
    wrap = kind == "periodic"
    fv = _facet_endpoints(mesh)
    bounds = mesh.facet_color_bounds
    items = [(bounds[k], bounds[k + 1], *col[2:6]) for k, col in enumerate(spec[4])]
    items += [(f0, f0 + ni * nj, i0, j0, ni, nj) for (h, l, i0, j0, ni, nj, f0) in spec[5]]
    groups = []
    expect_f0 = 0
    for (f0, f1, i0, j0, ni, nj) in items:
        if f0 != expect_f0:
            return None
        expect_f0 = f1
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
                return None
            offs.append((int(di[0]), int(dj[0])))
        groups.append((f0, f1, i0, j0, ni, nj, offs[0], offs[1]))
    if expect_f0 != mesh.n_facets:
        return None
    return (int(Mx), int(My), wrap, tuple(groups))


def _padded_adjacency(nv, pairs_v, payloads):
    """Incidences (vertex ``pairs_v[i]``, payload columns) as padded
    (nv, D) tables plus a (nv, D) validity mask, in stable incidence order."""
    order = np.argsort(pairs_v, kind="stable")
    sv = pairs_v[order]
    deg = np.bincount(pairs_v, minlength=nv)
    start = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(sv.shape[0]) - start[sv]
    D = int(deg.max())
    tables = []
    for col in payloads:
        t = np.zeros((nv, D), dtype=np.int64)
        t[sv, pos] = col[order]
        tables.append(t)
    mask = np.zeros((nv, D))
    mask[sv, pos] = 1.0
    return tables, mask


def _fft_spectrum(mesh):
    """(coarse_kind, grid shape, inverse spectrum, boundary-row scaling) of
    the structured P1 Laplacian, or None on an unstructured mesh.  On a
    uniform right-triangulated grid the P1 stiffness is the 5-point graph
    Laplacian with weights (hy/hx, hx/hy), diagonalised by the DCT-I
    (Neumann) or the DFT (periodic); the constant mode is deflated."""
    sg = getattr(mesh, "structured_grid", None)
    if sg is None:
        return None
    kind, Mx, My = sg
    if kind == "neumann":
        xs = mesh.vertices[:, 0].reshape(Mx, My)
        ys = mesh.vertices[:, 1].reshape(Mx, My)
        hx = float(xs[1, 0] - xs[0, 0])
        hy = float(ys[0, 1] - ys[0, 0])
        lx = (hy / hx) * (2.0 - 2.0 * np.cos(np.pi * np.arange(Mx) / (Mx - 1)))
        ly = (hx / hy) * (2.0 - 2.0 * np.cos(np.pi * np.arange(My) / (My - 1)))
    else:  # periodic: uniform square cells, the weights are 1
        lx = 2.0 - 2.0 * np.cos(2.0 * np.pi * np.arange(Mx) / Mx)
        ly = 2.0 - 2.0 * np.cos(2.0 * np.pi * np.arange(My) / My)
    lam2 = lx[:, None] + ly[None, :]
    lam2[0, 0] = 1.0
    inv = 1.0 / lam2
    inv[0, 0] = 0.0
    if kind != "neumann":
        return "fft_periodic", (Mx, My), inv, None
    # FEM boundary rows are half/quarter stencils, K = D * A_mirror with
    # D = diag(1, 1/2 edge, 1/4 corner): pre-scaling the residual by D^-1
    # makes the spectral solve exact for the FEM Laplacian
    wgt = np.ones((Mx, My))
    wgt[0, :] *= 0.5
    wgt[-1, :] *= 0.5
    wgt[:, 0] *= 0.5
    wgt[:, -1] *= 0.5
    return "fft_neumann", (Mx, My), inv, (1.0 / wgt).ravel()


def build_gtmg(disc, cs, cheb_fine=2, cheb_coarse=25, power_iters=25):
    """Build the two-level preconditioner (host set-up;
    ``build_condensed_system`` must have run on ``disc``)."""
    mesh = disc.mesh
    nv, nc, nf = mesh.n_vertices, mesh.n_cells, mesh.n_facets
    rng = np.random.default_rng(7)
    S_np = disc.cs_host["S"]
    Sdiag_inv_np = disc.cs_host["Sdiag_inv"]
    cf = mesh.cell_facets
    nt = S_np.shape[-1] // 3

    def trace_mv_np(lam):
        y_c = np.einsum("cij,cj->ci", S_np, lam[cf].reshape(nc, -1))
        out = np.zeros_like(lam)
        np.add.at(out, cf, y_c.reshape(nc, 3, nt))
        return out

    def power(op, v):
        for _ in range(power_iters):
            v = op(v)
            v = v / np.linalg.norm(v)
        return float(np.vdot(v, op(v)))

    x = rng.standard_normal((nf, nt))
    sign = float(np.sign(np.vdot(x, trace_mv_np(x))))
    lmax_fine = power(lambda v: np.einsum("fij,fj->fi", Sdiag_inv_np, trace_mv_np(v)),
                      rng.standard_normal((nf, nt)))

    # P1 stiffness K_ab = area g_a . g_b (barycentric gradients, area detJ/2)
    ghat = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    gphys = np.einsum("ab,cbd->cad", ghat, mesh.jac_inv)
    K_elem = 0.5 * mesh.det_jac[:, None, None] * np.einsum("cad,cbd->cab", gphys, gphys)
    K_diag = np.zeros(nv)
    np.add.at(K_diag, mesh.cells, np.einsum("caa->ca", K_elem))
    Kdi_np = 1.0 / np.maximum(K_diag, 1e-300)

    def coarse_mv_np(z):
        out = np.zeros_like(z)
        np.add.at(out, mesh.cells, np.einsum("cab,cb->ca", K_elem, z[mesh.cells]))
        return out

    spectrum = _fft_spectrum(mesh)
    coarse_kind = "cheb" if spectrum is None else spectrum[0]
    lmax_coarse = 1.0  # read by the Chebyshev coarse solve only
    if coarse_kind == "cheb":
        lmax_coarse = power(lambda w: Kdi_np * coarse_mv_np(w), rng.standard_normal(nv))

    facet_verts = _facet_endpoints(mesh)
    (vf, vf_end), vf_mask = _padded_adjacency(
        nv, facet_verts.ravel(), [np.repeat(np.arange(nf), 2), np.tile([0, 1], nf)])
    (vc, vc_pos), vc_mask = _padded_adjacency(
        nv, mesh.cells.ravel(), [np.repeat(np.arange(nc), 3), np.tile([0, 1, 2], nc)])

    star_inv = star_pos = coarse_dense_inv = None
    if coarse_kind == "cheb" and nv > STAR_MAX_VERTICES:
        warnings.warn(
            f"GTMG vertex-star smoother disabled: {nv} vertices exceeds the setup gate "
            f"({STAR_MAX_VERTICES}); using Chebyshev-Jacobi smoothing (expect higher "
            "iteration counts)", RuntimeWarning)
    elif coarse_kind == "cheb":
        star_inv, star_pos = _vertex_stars(S_np, cf, nt, nf, vf, vf_end, vf_mask, sign)
        mdim = star_inv.shape[1]

        def star_np(r):
            """(nf, nt) -> (nf, nt) vertex-star apply on the host (for lmax)."""
            rv = (r[vf] * vf_mask[:, :, None]).reshape(nv, mdim)
            y = np.einsum("vij,vj->vi", star_inv, rv)
            z = np.zeros_like(r)
            for e in range(2):
                cols = star_pos[e][:, None] * nt + np.arange(nt)[None, :]
                z += 0.5 * np.take_along_axis(y[facet_verts[:, e]], cols, axis=1)
            return z

        if nv <= DENSE_COARSE_MAX_VERTICES:
            K_dense = np.zeros((nv, nv))
            for a in range(3):
                for b in range(3):
                    np.add.at(K_dense, (mesh.cells[:, a], mesh.cells[:, b]), K_elem[:, a, b])
            coarse_dense_inv = np.linalg.pinv(K_dense, rcond=1e-10)
        # the Chebyshev bounds target the star-preconditioned spectrum
        lmax_fine = power(lambda v: star_np(sign * trace_mv_np(v)),
                          rng.standard_normal((nf, nt)))

    f = lambda a: None if a is None else torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
    i = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.int64), device=disc.device)
    return TwoLevelTracePC(
        Sdiag_inv=cs.Sdiag_inv,
        trace_nodes=f(disc.Vt.nodes),
        sign=sign,
        facet_verts=i(facet_verts.T),
        K_elem=f(K_elem.transpose(1, 2, 0)),
        cells=i(mesh.cells.T),
        K_diag_inv=f(Kdi_np),
        vf=i(vf), vf_end=i(vf_end), vf_mask=f(vf_mask),
        vc=i(vc), vc_pos=i(vc_pos), vc_mask=f(vc_mask),
        coarse_eig_inv=None if spectrum is None else f(spectrum[2]),
        coarse_scale=None if spectrum is None else f(spectrum[3]),
        star_inv=None if star_inv is None else f(star_inv.transpose(1, 2, 0)),
        star_pos=i(star_pos),
        coarse_dense_inv=f(coarse_dense_inv),
        vshift=_vertex_shift_groups(mesh),
        n_vertices=nv,
        coarse_kind=coarse_kind,
        grid_shape=None if spectrum is None else spectrum[1],
        cheb_fine=cheb_fine,
        cheb_coarse=cheb_coarse,
        lmax_fine=abs(lmax_fine),
        lmax_coarse=abs(lmax_coarse),
    )


def _vertex_stars(S_cells, cf, nt, nf, vf, vf_end, vf_mask, sign):
    """Host set-up of the vertex-star smoother (the ASMStarPC analogue):
    per vertex the inverse of sign * S restricted to the trace dofs of its
    facets, padded with the identity to (Dv nt, Dv nt), and the position of
    every facet in its two endpoint stars (2, nf).  The blocks are read from
    the assembled CSR matrix in one indexed gather and inverted as a batch."""
    import scipy.sparse as sp

    nv, Dv = vf.shape
    mdim = Dv * nt
    gdof = (cf[:, :, None] * nt + np.arange(nt)).reshape(cf.shape[0], 3 * nt)
    rows = np.repeat(gdof[:, :, None], 3 * nt, axis=2).ravel()
    cols = np.repeat(gdof[:, None, :], 3 * nt, axis=1).ravel()
    S_glob = sp.coo_matrix((S_cells.ravel(), (rows, cols)), shape=(nf * nt, nf * nt)).tocsr()
    valid = np.repeat(vf_mask > 0, nt, axis=1)  # (nv, mdim)
    dof = (vf[:, :, None] * nt + np.arange(nt)).reshape(nv, mdim)
    both = valid[:, :, None] & valid[:, None, :]
    ri = np.broadcast_to(dof[:, :, None], both.shape)[both]
    ci = np.broadcast_to(dof[:, None, :], both.shape)[both]
    P = np.broadcast_to(np.eye(mdim), (nv, mdim, mdim)).copy()
    P[both] = sign * np.asarray(S_glob[ri, ci]).ravel()
    star_pos = np.zeros((2, nf), np.int64)
    v_idx, p_idx = np.nonzero(vf_mask > 0)
    star_pos[vf_end[v_idx, p_idx], vf[v_idx, p_idx]] = p_idx
    return np.linalg.inv(P), star_pos


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
    """Solve (or approximate) the P1 coarse Laplacian: (nv,) -> (nv,)."""
    if pc.coarse_kind == "fft_neumann":
        Mx, My = pc.grid_shape
        u = (rc * pc.coarse_scale).reshape(Mx, My)
        c = _dct1_2d(u) * pc.coarse_eig_inv
        return (_dct1_2d(c) / (4.0 * (Mx - 1) * (My - 1))).reshape(-1)
    if pc.coarse_kind == "fft_periodic":
        c = torch.fft.fft2(rc.reshape(pc.grid_shape)) * pc.coarse_eig_inv
        return torch.fft.ifft2(c).real.reshape(-1)
    if pc.coarse_dense_inv is not None:
        return pc.coarse_dense_inv @ rc

    def Ac(v):
        loc = torch.einsum("abc,bc->ac", pc.K_elem, v[pc.cells])  # (3, nc)
        locf = loc.reshape(-1)
        nc = loc.shape[1]
        return sum(pc.vc_mask[:, d] * locf[pc.vc_pos[:, d] * nc + pc.vc[:, d]]
                   for d in range(pc.vc.shape[1]))

    return _chebyshev(Ac, lambda v: pc.K_diag_inv * v, rc, pc.cheb_coarse, pc.lmax_coarse)


def _canvas_shift(a, d, wrap):
    """Shift of a slab's vertex canvas: i offsets stay inside the canvas,
    j offsets wrap on periodic meshes."""
    return shift2(shift2(a, (d[0], 0), False), (0, d[1]), wrap)


def _dist_prolong_ends(pc, zc):
    """Facet endpoint values of a slab-local layout from the replicated
    global coarse solution: the slab's canvas rows, then its groups."""
    comm, n_slabs, Mx, My, crows, groups, wrap = pc.dist
    zg = zc.reshape(Mx, My)
    if wrap:  # the last slab's interface row is row 0
        zg = torch.cat([zg, zg[:1]])
    rows = n_slabs * (crows - 1) + 1  # dummy columns of an uneven split
    if rows > zg.shape[0]:
        zg = torch.cat([zg, zg.new_zeros((rows - zg.shape[0], My))])
    local = zg[comm.rank * (crows - 1): comm.rank * (crows - 1) + crows]
    lo = torch.cat([rect_flat(_canvas_shift(local, g[6], wrap), g[2:6]) for g in groups])
    hi = torch.cat([rect_flat(_canvas_shift(local, g[7], wrap), g[2:6]) for g in groups])
    return lo, hi


def _dist_restrict(pc, a_lo, a_hi):
    """Adjoint of :func:`_dist_prolong_ends`: the slab's canvas, embedded at
    its row offset of the global vertex grid and summed over the ranks."""
    comm, n_slabs, Mx, My, crows, groups, wrap = pc.dist
    canvas = a_lo.new_zeros((crows, My))
    for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
        for arr, d in ((a_lo, dlo), (a_hi, dhi)):
            seg = arr[f0:f1].reshape(ni, nj)
            pad = torch.nn.functional.pad(seg, (j0, My - j0 - nj, i0, crows - i0 - ni))
            canvas = canvas + _canvas_shift(pad, (-d[0], -d[1]), wrap)
    rows = max(Mx + 1 if wrap else Mx, n_slabs * (crows - 1) + 1)
    glob = a_lo.new_zeros((rows, My))
    row0 = comm.rank * (crows - 1)
    glob[row0: row0 + crows] = canvas
    if wrap:
        glob[0] += glob[Mx]
    return comm.allreduce(glob[:Mx]).reshape(-1)


def prolong(pc, zc):
    """P1 vertex values -> trace dofs by linear interpolation along each
    facet: (nv,) -> (nt, nf)."""
    if pc.dist is not None:
        lo, hi = _dist_prolong_ends(pc, zc)
    elif pc.vshift is not None:
        Mx, My, wrap, groups = pc.vshift
        zg = zc.reshape(Mx, My)
        lo = torch.cat([rect_flat(shift2(zg, g[6], wrap), g[2:6]) for g in groups])
        hi = torch.cat([rect_flat(shift2(zg, g[7], wrap), g[2:6]) for g in groups])
    else:
        lo, hi = zc[pc.facet_verts[0]], zc[pc.facet_verts[1]]
    s = pc.trace_nodes[:, None]
    return lo[None, :] * (1.0 - s) + hi[None, :] * s


def restrict(pc, lam):
    """Adjoint of :func:`prolong`: (nt, nf) -> (nv,)."""
    s = pc.trace_nodes[:, None]
    a_lo = torch.sum(lam * (1.0 - s), dim=0)
    a_hi = torch.sum(lam * s, dim=0)
    if pc.dist is not None:
        return _dist_restrict(pc, a_lo, a_hi)
    if pc.part is not None:
        t = pc.part
        acat = torch.cat([a_lo, a_hi])
        out = lam.new_zeros(pc.n_vertices)
        out[t.verts] = sum(t.vf_mask[:, d] * acat[t.vf[:, d]] for d in range(t.vf.shape[1]))
        return t.comm.allreduce(out)
    if pc.vshift is None:
        acat = torch.cat([a_lo, a_hi])
        nf = a_lo.shape[0]
        return sum(pc.vf_mask[:, d] * acat[pc.vf[:, d] + pc.vf_end[:, d] * nf]
                   for d in range(pc.vf.shape[1]))
    Mx, My, wrap, groups = pc.vshift
    acc = lam.new_zeros((Mx, My))
    for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
        for arr, d in ((a_lo, dlo), (a_hi, dhi)):
            seg = arr[f0:f1].reshape(ni, nj)
            pad = torch.nn.functional.pad(seg, (j0, My - j0 - nj, i0, Mx - i0 - ni))
            acc = acc + shift2(pad, (-d[0], -d[1]), wrap)
    return acc.reshape(-1)


def _star_apply(pc, r):
    """Additive vertex-star smoother: (nt, nf) -> (nt, nf).  Exact dense
    patch solves per vertex, summed back with weight 1/2 (each facet lies
    in exactly its two endpoint stars)."""
    nt = r.shape[0]
    ends = pc.facet_verts
    if pc.part is not None:
        r = pc.part.comm.ghosts(pc.part.star_plan, r)
        ends = pc.part.ends
    rg = r[:, pc.vf] * pc.vf_mask[None]  # (nt, nv, Dv)
    rv = rg.permute(2, 0, 1).reshape(pc.star_inv.shape[0], -1)
    y = torch.einsum("ijv,jv->iv", pc.star_inv, rv)
    z = 0.0
    rows = torch.arange(nt, device=r.device)[:, None]
    for e in range(2):
        idx = pc.star_pos[e][None, :] * nt + rows  # (nt, nf)
        z = z + 0.5 * torch.gather(y[:, ends[e]], 0, idx)
    return z


def gtmg_apply(geom, cs, pc, r_flat):
    """Multiplicative two-level V-cycle approximating S^{-1} r (flat
    (nt, nf) trace vectors)."""
    nt = cs.nt
    sign = pc.sign
    r = (sign * r_flat).reshape(nt, -1)

    def A(v):
        return sign * trace_matvec(geom, cs, v)

    def Dinv(v):
        if pc.star_inv is not None:
            return _star_apply(pc, v)  # built from sign * S already
        return sign * torch.einsum("ijf,jf->if", cs.Sdiag_inv, v)

    z = _chebyshev(A, Dinv, r, pc.cheb_fine, pc.lmax_fine)
    zc = _coarse_solve(pc, restrict(pc, r - A(z)))
    pr = prolong(pc, zc)
    if geom.fvalid is not None:
        pr = pr * geom.fvalid  # dummy facet positions of a slab-local layout
    z = z + pr
    z = z + _chebyshev(A, Dinv, r - A(z), pc.cheb_fine, pc.lmax_fine)
    return (sign * z).reshape(-1)
