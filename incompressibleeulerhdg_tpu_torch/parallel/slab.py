"""Slab decomposition of the structured meshes over ``torch.distributed`` ranks.

Counterpart of incompressibleeulerhdg_tpu/parallel/slab.py.  The structured
[lowers; uppers] mesh is cut into ``n_slabs`` contiguous slabs of grid
columns i, one per rank.  Each rank holds only its slab's cells, facets and
operator tables, on its own device, and runs the single-device step on them:

- every facet<->cell move is a slice or shift (ops/structured.py); the only
  i offsets are +-1, so an i shift exchanges exactly one grid row with a
  neighbouring rank (``Comm.halo``) and nothing is ever gathered inside a
  step;
- Krylov inner products and domain integrals are sums over the ranks
  (``Comm.allreduce``, linalg/krylov.py, ops/fields.py);
- the GTMG coarse residual (the P1 vertex field) is the one globally shared
  object: each rank fills its slab's vertex rows, the sum makes it a
  replicated global vector, and the FFT coarse solve runs replicated
  (linalg/gtmg.py); so does the tracer's CG dof vector (fem/cg.py).

Local facet layout (one layout on every rank):

    [V (nxl, ny); D (nxl, ny); H (nxl, ny); T (nxl,); L (ny,)]

indexed by the facet's plus cell: V vertical (its i = nx-1 column is the
right boundary), D diagonal, H horizontal (its j = 0 row is the bottom
boundary), T top boundary, L left boundary: real on rank 0 only, a
zero-masked dummy family elsewhere (``geom.fvalid``).  A periodic mesh has
the three interior families only.  When N does not divide nx, the last
slab carries ``N ceil(nx/N) - nx`` dummy columns (``geom.cvalid``),
decoupled by the masks of every move.

Numerical contract: the distributed solve is the single-device solve, up to
the order of the sums.  The cases the slab layout cannot represent (an
unstructured mesh, a periodic mesh with nx % N != 0, a split that leaves a
slab empty) run on the cell/facet partition (parallel/partition.py), as the
JAX package runs them on its GSPMD sharding (:func:`slab_supported`).
"""

import numpy as np
import torch

from ..fem.cg import CGSpace
from ..fem.discretisation import Geom, geom_host_arrays
from ..linalg.condense import CondensedSystem
from ..linalg.gtmg import TwoLevelTracePC, _facet_endpoints
from ..ops.projection import BDMProjection

__all__ = ["SlabDecomposition", "RankTables", "LocalDiscretisation", "slab_supported"]


def slab_supported(mesh, n_slabs):
    """Whether the slab layout represents ``mesh`` split ``n_slabs`` ways (the
    JAX package's ``slab_supported``): a structured mesh, nx divisible by
    ``n_slabs`` on a periodic one (the wrap halo needs a physical last row),
    and no empty slab."""
    spec = getattr(mesh, "shift_spec", None)
    if spec is None or n_slabs < 1:
        return False
    nx, periodic = spec[0], spec[2]
    nxl = -(-nx // n_slabs)
    if periodic and n_slabs * nxl != nx:
        return False
    return nxl * (n_slabs - 1) < nx


class LocalDiscretisation:
    """The slab's stand-in for an HDGDiscretisation: its geometry, and the
    interpolations of expressions at its nodes with the dummy cells of an
    uneven split set to zero."""

    def __init__(self, disc, geom, device):
        self.mesh = disc.mesh  # the global mesh, for set-up only
        self.degree = disc.degree
        self.dtype = disc.dtype
        self.device = torch.device(device)
        self.V1, self.V0, self.Vt = disc.V1, disc.V0, disc.Vt
        self.geom = geom
        self.domain_volume = disc.domain_volume

    def _mask(self, v):
        return v if self.geom.cvalid is None else v * self.geom.cvalid

    def interpolate_velocity(self, fn):
        x = self.geom.xnodes1
        fx, fy = fn(x[0], x[1])
        fx, fy = torch.broadcast_tensors(torch.as_tensor(fx), torch.as_tensor(fy))
        return self._mask(torch.stack([fx, fy]).to(self.dtype))

    def interpolate_pressure(self, fn):
        x = self.geom.xnodes0
        v = torch.as_tensor(fn(x[0], x[1])).broadcast_to(x.shape[1:]).to(self.dtype)
        return self._mask(v)


class RankTables:
    """A rank's tables on its device, as the slab decomposition and the
    partition (parallel/partition.py) both hold them: ``device``, ``dtype``,
    ``rank``, ``cell_maps``, ``nc_loc``, ``nf_loc``, ``geom``, ``cs`` and
    ``proj``, set by the subclass."""

    def _dev(self, a):
        """A host or CPU array on the rank's device: floats in the run's
        dtype, integers as int64."""
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.dtype.kind in "iu":
            return torch.as_tensor(a.astype(np.int64), device=self.device)
        return torch.as_tensor(a.astype(np.float64), dtype=self.dtype, device=self.device)

    def local_cg(self, space):
        """The rank's view of a global CGSpace: the dof map of its own cells
        (the dof vector stays replicated, the dofs its cells share with
        other ranks' summed over the ranks, fem/cg.py)."""
        return CGSpace(dofmap=self._dev(space.dofmap.cpu().numpy()[:, self.cell_maps[self.rank]]),
                       phi_at_q1=self._dev(space.phi_at_q1), mass_diag=self._dev(space.mass_diag),
                       node_coords=self._dev(space.node_coords), degree=space.degree,
                       n_dofs=space.n_dofs)

    def table_bytes(self):
        """Bytes of the rank's cell and facet tables on its device (geometry,
        condensed system, projection): the per-rank memory that scales as
        1/N."""
        tensors = [getattr(self.geom, f) for f in vars(self.geom)]
        if self.cs is not None:
            tensors += [self.cs.S, self.cs.class_id, self.cs.Sdiag_inv, self.cs.nullvec]
        tensors.append(self.proj.class_id)
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor) and t.dim() and t.shape[-1] in
                   (self.nc_loc, self.nf_loc))


class SlabDecomposition(RankTables):
    """Slab ``rank`` of a structured mesh split ``n_slabs`` ways: the index
    maps and masks of every slab (host numpy), and this slab's tables on
    ``device``.

    :arg disc: the global HDGDiscretisation (its tables on the host)
    :arg stepper: the global timestepper, whose condensed system, BDM
        projection and GTMG are localised
    :arg comm: the communicator of the run, or None for tables only (the
        local shifts then never exchange a row)
    """

    def __init__(self, disc, stepper, n_slabs, rank, comm=None, device="cpu"):
        mesh = disc.mesh
        if not slab_supported(mesh, n_slabs):
            raise ValueError(f"the slab layout does not split this mesh {n_slabs} ways")
        spec = mesh.shift_spec
        nx, ny, periodic = spec[0], spec[1], spec[2]
        nxl = -(-nx // n_slabs)
        self.n_slabs, self.rank, self.comm = n_slabs, rank, comm
        self.device = torch.device(device)
        self.dtype = disc.dtype
        self.nx, self.ny, self.nxl = nx, ny, nxl
        self.pad = n_slabs * nxl - nx
        self.periodic = periodic
        self.global_disc = disc
        nch = nx * ny
        cf = mesh.cell_facets
        A = nxl * ny
        self.nf_loc = 3 * A if periodic else 3 * A + nxl + ny
        self.nc_loc = 2 * A

        # local -> global index maps of every slab (dummies clamp to 0)
        self.cell_maps, self.facet_maps, self.facet_valid, self.cell_valid = [], [], [], []
        for d in range(n_slabs):
            ii = d * nxl + np.arange(nxl)
            cv_col = ii < nx
            ii_c = np.where(cv_col, ii, 0)
            low = (ii_c[:, None] * ny + np.arange(ny)).ravel().astype(np.int64)
            vcol = np.repeat(cv_col.astype(np.float64), ny)
            fV, fD, fH = (np.where(vcol > 0, cf[low, l], 0) for l in range(3))
            if periodic:
                fmap, valid = np.concatenate([fV, fD, fH]), np.ones(3 * A)
            else:
                fT = np.where(cv_col, cf[nch + ii_c * ny + (ny - 1), 0], 0)
                if d == 0:
                    fL, vL = cf[nch + np.arange(ny), 1], np.ones(ny)
                else:
                    fL, vL = np.zeros(ny, dtype=cf.dtype), np.zeros(ny)
                fmap = np.concatenate([fV, fD, fH, fT, fL])
                valid = np.concatenate([vcol, vcol, vcol, cv_col.astype(np.float64), vL])
            self.cell_maps.append(np.concatenate([low, nch + low]))
            self.facet_maps.append(fmap.astype(np.int64))
            self.facet_valid.append(valid)
            self.cell_valid.append(np.tile(vcol, 2))

        # the local spec: one layout on every rank, local colour k has plus slot k
        colors = ((0, 1, 0, 0, nxl, ny, (1, 0)),   # V
                  (1, 2, 0, 0, nxl, ny, (0, 0)),   # D
                  (2, 0, 0, 0, nxl, ny, (0, -1)))  # H
        bnd = () if periodic else ((1, 0, 0, ny - 1, nxl, 1, 3 * A),  # T
                                   (1, 1, 0, 0, 1, ny, 3 * A + nxl))  # L
        # the Schwarz sweep visits the colours in the global mesh's order
        # (local colour k is the global colour of plus slot k), so the
        # distributed preconditioner is the single-device one
        order = tuple(col[0] for col in spec[4])
        self.local_spec = (nxl, ny, periodic, spec[3], colors, bnd, (comm, n_slabs, order))
        self.fcol_bounds = (0, A, 2 * A, 3 * A)
        uspec = getattr(mesh, "uniform_spec", None)
        if uspec is not None:
            by_slot = {entry[0] // 2: entry for entry in uspec[0]}
            self.local_uniform = (tuple(by_slot[l] for l in range(3)), uspec[1])
        else:
            self.local_uniform = None

        gh = geom_host_arrays(mesh, disc.V1, disc.V0, disc.Vt, disc.degree)
        self.geom = Geom.from_arrays(self.local_geom_arrays(gh, rank), disc.dtype, self.device)
        self.disc = LocalDiscretisation(disc, self.geom, self.device)
        self.cs = self._local_cs(stepper._cs, disc.cs_host, rank)
        proj = stepper._proj
        self.proj = BDMProjection(
            leg=self._dev(proj.leg), vhat=self._dev(proj.vhat), recon=self._dev(proj.recon),
            class_id=self._dev(proj.class_id.cpu().numpy()[self.cell_maps[rank]]),
            n_moments=proj.n_moments, n_interior_dofs=proj.n_interior_dofs)
        self.pc = self._local_pc(stepper._gtmg, mesh, rank)

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------

    def take_facets(self, arr, d, fill=0.0):
        """Slab d's values of a global per-facet array (last axis); ``fill``
        at the dummy positions."""
        a = np.take(np.asarray(arr), self.facet_maps[d], axis=-1)
        v = self.facet_valid[d]
        return (a * v + fill * (1.0 - v)).astype(np.asarray(arr).dtype)

    def local_geom_arrays(self, gh, d):
        """Host geometry tables of slab d (the JAX package's ``_local_geom``):
        cell arrays by the cell map, facet arrays by the facet map, the
        gather-path tables zero (the slab runs the shift path only)."""
        cm = self.cell_maps[d]
        out = dict(gh)
        for name in ("det_jac", "jac_inv", "cfside", "cfsign", "cf_tab", "cf_bnd", "xq",
                     "xnodes1", "xnodes0"):
            out[name] = np.asarray(gh[name])[..., cm]
        out["normal"] = self.take_facets(gh["normal"], d)
        out["flen"] = self.take_facets(gh["flen"], d, fill=1.0)
        out["hF_inv"] = self.take_facets(gh["hF_inv"], d)
        out["ftab"] = np.asarray(gh["ftab"])[:, self.facet_maps[d]] * \
            self.facet_valid[d].astype(np.int64)
        ncol = 3
        for name in ("fcells",):
            out[name] = np.zeros((2, self.nf_loc), np.int64)
        for name in ("cell_facets", "cfassemble"):
            out[name] = np.zeros((3, self.nc_loc), np.int64)
        for name in ("fcol_pos", "fcol_side"):
            out[name] = np.zeros((ncol, self.nc_loc), np.int64)
        out["fcol_mask"] = np.zeros((ncol, self.nc_loc))
        n_int_global = int(gh["n_int"])
        out["fint"] = (self.facet_maps[d] < n_int_global) * self.facet_valid[d]
        out["fvalid"] = self.facet_valid[d]
        out["cvalid"] = self.cell_valid[d] if self.pad else None
        out.update(n_int=3 * self.nxl * self.ny, fcol_bounds=self.fcol_bounds,
                   fcol_orphans=False, shift=self.local_spec, uniform=self.local_uniform)
        return out

    def _local_cs(self, cs, cs_host, d):
        """The slab's condensed system: per-cell Schur blocks by the cell map,
        facet-diagonal inverses by the facet map (identity on dummy
        facets), the unit null vector's slab entries."""
        cm = self.cell_maps[d]
        nt = cs.nt
        Sdiag = self.take_facets(np.asarray(cs_host["Sdiag_inv"]).transpose(1, 2, 0), d)
        v = self.facet_valid[d]
        Sdiag = Sdiag * v + np.eye(nt)[:, :, None] * (1.0 - v)
        return CondensedSystem(
            S=self._dev(np.asarray(cs_host["S"])[cm].transpose(1, 2, 0)),
            Ainv=self._dev(cs.Ainv), AinvB=self._dev(cs.AinvB), CAinv=self._dev(cs.CAinv),
            class_id=self._dev(cs.class_id.cpu().numpy()[cm]),
            Sdiag_inv=self._dev(Sdiag),
            nullvec=self._dev(self.take_facets(cs.nullvec.cpu().numpy(), d)),
            tau=cs.tau, nt=nt)

    def vertex_groups(self, mesh, d):
        """Per facet family of slab d: ``(f0, f1, i0, j0, ni, nj, dlo, dhi)``
        with the constant offsets of its endpoints on the slab's vertex
        canvas (None for a family of dummies only), read off the global
        facet endpoints."""
        nxl, ny = self.nxl, self.ny
        Mx, My = mesh.structured_grid[1:]
        fv = _facet_endpoints(mesh)
        rects = [(0, 0, nxl, ny)] * 3
        if not self.periodic:
            rects += [(0, ny - 1, nxl, 1), (0, 0, 1, ny)]
        groups, f0 = [], 0
        for (i0, j0, ni, nj) in rects:
            n = ni * nj
            fm = self.facet_maps[d][f0:f0 + n]
            use = self.facet_valid[d][f0:f0 + n] > 0
            pi = i0 + np.repeat(np.arange(ni), nj)
            pj = j0 + np.tile(np.arange(nj), ni)
            offs = []
            for e in range(2):
                vids = fv[fm, e]
                di, dj = vids // My - d * nxl - pi, vids % My - pj
                if self.periodic:  # the endpoints sit at p + {0, 1} on the torus
                    di, dj = (di + Mx) % Mx, (dj + My) % My
                if not use.any():
                    offs.append(None)
                    continue
                assert np.all(di[use] == di[use][0]) and np.all(dj[use] == dj[use][0]), \
                    ("non-constant vertex offset", d)
                offs.append((int(di[use][0]), int(dj[use][0])))
            groups.append((f0, f0 + n, i0, j0, ni, nj, offs[0], offs[1]))
            f0 += n
        return groups

    def _local_pc(self, pc, mesh, d):
        """The slab's GTMG: the Chebyshev smoother reads the local
        ``cs.Sdiag_inv``; the transfers move the slab's vertex canvas; the
        coarse spectrum is the global one (the coarse solve runs
        replicated).  Tables only the host set-up reads are placeholders."""
        if pc.coarse_kind not in ("fft_neumann", "fft_periodic"):
            raise ValueError("the slab-local GTMG needs the FFT coarse solve")
        groups = self.vertex_groups(mesh, d)
        owner = self.vertex_groups(mesh, 0) if d else groups  # the L family's offsets
        groups = tuple(g[:6] + (g[6] or o[6], g[7] or o[7]) for g, o in zip(groups, owner))
        Mx, My = pc.grid_shape
        small = torch.zeros((1, 1), dtype=self.dtype, device=self.device)
        ismall = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        return TwoLevelTracePC(
            Sdiag_inv=small, trace_nodes=self._dev(pc.trace_nodes), sign=pc.sign,
            facet_verts=ismall, K_elem=small, cells=ismall, K_diag_inv=small,
            vf=ismall, vf_end=ismall, vf_mask=small, vc=ismall, vc_pos=ismall, vc_mask=small,
            coarse_eig_inv=self._dev(pc.coarse_eig_inv),
            coarse_scale=None if pc.coarse_scale is None else self._dev(pc.coarse_scale),
            n_vertices=pc.n_vertices, coarse_kind=pc.coarse_kind, grid_shape=pc.grid_shape,
            cheb_fine=pc.cheb_fine, cheb_coarse=pc.cheb_coarse, lmax_fine=pc.lmax_fine,
            lmax_coarse=pc.lmax_coarse,
            dist=(self.comm, self.n_slabs, int(Mx), int(My), self.nxl + 1, groups,
                  self.periodic))

    # ------------------------------------------------------------------
    # state movement
    # ------------------------------------------------------------------

    def scatter_cell_field(self, u):
        """This slab's part of a global cell field (..., nc), dummy cells
        zero, on the slab's device."""
        u = u.cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
        cm, cv = self.cell_maps[self.rank], self.cell_valid[self.rank]
        return self._dev(u[..., cm] * cv)

    def scatter_facet_field(self, lam):
        """This slab's part of a global facet field (..., nf), dummy facets zero."""
        lam = lam.cpu().numpy() if isinstance(lam, torch.Tensor) else np.asarray(lam)
        fm, fv = self.facet_maps[self.rank], self.facet_valid[self.rank]
        return self._dev(lam[..., fm] * fv)

    def _gather(self, local, maps, valid, n):
        parts = self.comm.gather(local)
        if parts is None:
            return None
        out = torch.zeros(local.shape[:-1] + (n,), dtype=local.dtype)
        for part, m, v in zip(parts, maps, valid):
            sel = torch.as_tensor(v > 0)
            out[..., torch.as_tensor(m)[sel]] = part[..., sel]
        return out

    def gather_cell_field(self, u):
        """The global cell field on the host of rank 0 from every slab's
        part (a collective; None on the other ranks)."""
        mesh = self.global_disc.mesh
        return self._gather(u, self.cell_maps, self.cell_valid, mesh.n_cells)

    def gather_facet_field(self, lam):
        """The global facet field on the host of rank 0 (a collective)."""
        mesh = self.global_disc.mesh
        return self._gather(lam, self.facet_maps, self.facet_valid, mesh.n_facets)
