"""Cell/facet partition of any mesh over ``torch.distributed`` ranks.

Counterpart of incompressibleeulerhdg_tpu/parallel/sharding.py, the GSPMD
cell/facet sharding the JAX package runs wherever its slab decomposition
does not apply: the unstructured disk, the conforming RT1 x DG0 scheme, a
periodic mesh that N does not divide, a split that leaves a slab empty,
the tracer under HDG or DG implicit.  Where GSPMD inserts the halo
exchanges of the facet<->cell gathers, the port makes them explicit:

- each rank owns a block of cells, a strip of the mesh in x (the cells
  sorted by centroid x, then y, cut into N blocks of sizes differing by
  at most one), and the facets whose plus cell it owns, so a facet's plus
  side is always local; its cell and facet arrays hold the owned entries
  in the mesh's order (so the facet colours and the interior-first order
  stay contiguous ranges);
- every gather table (``fcells``, ``cell_facets``/``cfassemble``, the RT
  ``fslot``, the GTMG star adjacency ``vf``) is renumbered into the rank's
  ``[owned | ghost]`` array, and a :class:`GhostPlan` per table records
  which ghosts the rank reads, grouped by owner, and which of its own
  entries the others read; ``Comm.ghosts`` moves them before each gather
  whose source has changed (ops/fields.py);
- the static tables that gathers read (``jac_inv``, ``flen``, ``hF_inv``,
  ``normal``) carry their ghost entries from the set-up;
- vertex-axis data stays replicated, as under GSPMD: the GTMG coarse
  space, its FFT spectrum, dense pseudo-inverse or Chebyshev operator,
  and the tracer's CG dof vector (each rank adds its own cells into it and
  a sum over the ranks completes it, fem/cg.py).  The GTMG restriction and
  the vertex-star inverses are kept for the vertices the own facets end
  at;
- every structured mesh takes the gather path here (``shift`` None, the
  JAX package's ``_strip_structured``); the tentative solve keeps the
  single device's Krylov method (linalg/tentative.py).

Numerical contract: the distributed solve is the single-device solve, up to
the order of the sums; every Krylov solve takes the single device's
iterations.  Every rank builds the global tables on the host first (as the
slab decomposition does) and keeps its own.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.discretisation import Geom, geom_host_arrays
from ..linalg.condense import CondensedSystem
from ..linalg.gtmg import TwoLevelTracePC, _facet_endpoints
from ..ops.projection import BDMProjection
from ..ops.rt import RTTables, facet_slots
from .slab import LocalDiscretisation, RankTables

__all__ = ["GhostPlan", "PartitionTables", "PartitionTransfers", "Partition", "cell_owners"]

CELL_FIELDS = ("det_jac", "jac_inv", "cfside", "cfsign", "cf_tab", "cf_bnd", "xq", "xnodes1",
               "xnodes0")
FACET_FIELDS = ("normal", "flen", "hF_inv", "ftab")


@dataclass
class GhostPlan:
    """One gather table's ghost exchange on one rank.

    ``send``: (peer, own local ids the peer holds as ghosts, in its order)
    per peer that reads any; ``recv``: (peer, count) per owner of a ghost,
    in ghost order; ``ghost_ids``: the ghosts' global ids (owner-major,
    ascending within an owner)."""

    send: tuple
    recv: tuple
    n_owned: int
    ghost_ids: np.ndarray

    @property
    def n_ghost(self):
        return int(self.ghost_ids.shape[0])

    @property
    def n_ext(self):
        return self.n_owned + self.n_ghost


@dataclass
class PartitionTables:
    """``Geom.part`` of a partition-local geometry."""

    comm: object  # parallel.comm.Comm, or None for tables only
    cells: GhostPlan  # ghost cells of the facet -> cell gathers (fcells)
    facets: GhostPlan  # ghost facets of the cell -> facet gathers (cell_facets)
    tables: dict  # static tables with their ghost entries (ops.fields.table_ext)
    structured: bool  # the global mesh is structured (linalg/tentative.py)


@dataclass
class PartitionTransfers:
    """``TwoLevelTracePC.part`` of a partition-local GTMG (linalg/gtmg.py)."""

    comm: object
    verts: torch.Tensor  # (nvr,) the vertices the own facets end at
    vf: torch.Tensor  # (nvr, Dv) their own facets' ends in [lo | hi] order, global incidence order
    vf_mask: torch.Tensor  # (nvr, Dv) 1.0 where the incident facet is the rank's
    ends: torch.Tensor  # (2, nf) each own facet's ends as positions in ``verts``
    star_plan: GhostPlan = None  # ghost facets of the vertex stars (vertex-star smoother)


def cell_owners(mesh, n_parts):
    """(nc,) owning rank of every cell: the cells sorted by centroid x, then
    y, in ``n_parts`` blocks of sizes differing by at most one."""
    centroid = mesh.cell_coords.mean(axis=1)
    order = np.lexsort((centroid[:, 1], centroid[:, 0]))
    owner = np.empty(mesh.n_cells, np.int64)
    for r, block in enumerate(np.array_split(order, n_parts)):
        owner[block] = r
    return owner


def _ghost_plans(needs, owner, maps, local_pos, rank, device):
    """The :class:`GhostPlan` of ``rank`` and its ``[owned | ghost]``
    renumbering (global id -> local index, -1 where not held), given the
    global ids every rank reads (``needs[r]``)."""
    ghosts = []
    for r, need in enumerate(needs):
        g = np.setdiff1d(need, maps[r])
        ghosts.append(g[np.lexsort((g, owner[g]))])
    mine = ghosts[rank]
    recv = tuple((p, int(np.sum(owner[mine] == p))) for p in np.unique(owner[mine]))
    send = tuple((p, torch.as_tensor(local_pos[g[owner[g] == rank]], device=device))
                 for p, g in enumerate(ghosts) if p != rank and np.any(owner[g] == rank))
    n_own = maps[rank].shape[0]
    ext = np.full(owner.shape[0], -1, np.int64)
    ext[maps[rank]] = np.arange(n_own)
    ext[mine] = n_own + np.arange(mine.shape[0])
    return GhostPlan(send=send, recv=tuple((int(p), n) for p, n in recv), n_owned=n_own,
                     ghost_ids=mine), ext


def _renumber(ext, table):
    """A gather table of global ids in a rank's ``[owned | ghost]`` numbering;
    every entry it reads must be owned or a ghost."""
    out = ext[table]
    assert np.all(out >= 0), "a gather reads an entry the rank neither owns nor holds"
    return out


class Partition(RankTables):
    """Rank ``rank`` of a mesh partitioned ``n_parts`` ways: the ownership
    and index maps of every rank (host numpy) and this rank's tables on
    ``device`` (the same interface as ``parallel.slab.SlabDecomposition``).

    :arg disc: the global HDGDiscretisation (its tables on the host)
    :arg stepper: the global timestepper, whose condensed system, BDM
        projection, GTMG and RT tables (those it has) are localised
    :arg comm: the communicator of the run, or None for tables only
    """

    def __init__(self, disc, stepper, n_parts, rank, comm=None, device="cpu"):
        mesh = disc.mesh
        self.n_parts, self.rank, self.comm = n_parts, rank, comm
        self.device = torch.device(device)
        self.dtype = disc.dtype
        self.global_disc = disc
        nc, nf = mesh.n_cells, mesh.n_facets
        self.cell_owner = cell_owners(mesh, n_parts)
        self.facet_owner = self.cell_owner[mesh.facet_cells[:, 0]]
        self.cell_maps = [np.flatnonzero(self.cell_owner == r) for r in range(n_parts)]
        self.facet_maps = [np.flatnonzero(self.facet_owner == r) for r in range(n_parts)]
        if min(m.shape[0] for m in self.cell_maps) == 0:
            raise ValueError(f"{n_parts} ranks for {nc} cells leave a rank without cells")
        cpos, fpos = np.empty(nc, np.int64), np.empty(nf, np.int64)
        for cm, fm in zip(self.cell_maps, self.facet_maps):
            cpos[cm] = np.arange(cm.shape[0])
            fpos[fm] = np.arange(fm.shape[0])
        self._fpos = fpos

        gh = geom_host_arrays(mesh, disc.V1, disc.V0, disc.Vt, disc.degree)
        # a boundary facet's minus side reads its plus cell (masked by every
        # caller), so no rank reads a cell for it
        fcells = np.array(gh["fcells"])
        n_int = int(gh["n_int"])
        fcells[1, n_int:] = fcells[0, n_int:]
        cell_facets = np.asarray(gh["cell_facets"])
        self.cell_plan, cext = _ghost_plans(
            [np.unique(fcells[:, fm]) for fm in self.facet_maps], self.cell_owner,
            self.cell_maps, cpos, rank, self.device)
        self.facet_plan, fext = _ghost_plans(
            [np.unique(cell_facets[:, cm]) for cm in self.cell_maps], self.facet_owner,
            self.facet_maps, fpos, rank, self.device)
        cm, fm = self.cell_maps[rank], self.facet_maps[rank]
        self.nc_loc, self.nf_loc = cm.shape[0], fm.shape[0]

        cell_ids = np.concatenate([cm, self.cell_plan.ghost_ids])
        facet_ids = np.concatenate([fm, self.facet_plan.ghost_ids])
        tables = {"jac_inv": self._dev(np.asarray(gh["jac_inv"])[..., cell_ids])}
        for name in ("flen", "hF_inv", "normal"):
            tables[name] = self._dev(np.asarray(gh[name])[..., facet_ids])
        self.tables = PartitionTables(comm=comm, cells=self.cell_plan, facets=self.facet_plan,
                                      tables=tables,
                                      structured=getattr(mesh, "shift_spec", None) is not None)

        out = dict(gh)
        for name in CELL_FIELDS:
            out[name] = np.asarray(gh[name])[..., cm]
        for name in FACET_FIELDS:
            out[name] = np.asarray(gh[name])[..., fm]
        out["fcells"] = _renumber(cext, fcells[:, fm])
        out["cell_facets"] = _renumber(fext, cell_facets[:, cm])
        out["cfassemble"] = out["cell_facets"] + out["cfside"] * self.facet_plan.n_ext
        ncol = len(gh["fcol_bounds"]) - 1
        # the colour patches of a partition move through fcells and
        # cfassemble (linalg/preconditioners.py), not these maps
        out["fcol_pos"] = np.zeros((ncol, self.nc_loc), np.int64)
        out["fcol_side"] = np.zeros((ncol, self.nc_loc), np.int64)
        out["fcol_mask"] = np.zeros((ncol, self.nc_loc))
        out.update(n_int=int(np.sum(fm < n_int)),
                   fcol_bounds=tuple(int(b) for b in np.searchsorted(fm, gh["fcol_bounds"])),
                   shift=None, uniform=None)
        self.geom = Geom.from_arrays(out, disc.dtype, self.device)
        self.geom.part = self.tables
        self.disc = LocalDiscretisation(disc, self.geom, self.device)

        proj = stepper._proj
        self.proj = BDMProjection(
            leg=self._dev(proj.leg), vhat=self._dev(proj.vhat), recon=self._dev(proj.recon),
            class_id=self._dev(proj.class_id.cpu().numpy()[cm]),
            n_moments=proj.n_moments, n_interior_dofs=proj.n_interior_dofs)
        cs = getattr(stepper, "_cs", None)
        self.cs = None if cs is None else self._local_cs(cs, disc.cs_host)
        pc = getattr(stepper, "_gtmg", None)
        self.pc = None if pc is None else self._local_pc(pc, mesh)
        rt = getattr(stepper, "_rt", None)
        self.rt = None if rt is None else self._local_rt(rt)

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------

    def _local_cs(self, cs, cs_host):
        """Own cells' Schur blocks, own facets' diagonal inverses and null
        vector entries (unit in the global norm)."""
        cm, fm = self.cell_maps[self.rank], self.facet_maps[self.rank]
        return CondensedSystem(
            S=self._dev(np.asarray(cs_host["S"])[cm].transpose(1, 2, 0)),
            Ainv=self._dev(cs.Ainv), AinvB=self._dev(cs.AinvB), CAinv=self._dev(cs.CAinv),
            class_id=self._dev(cs.class_id.cpu().numpy()[cm]),
            Sdiag_inv=self._dev(np.asarray(cs_host["Sdiag_inv"])[fm].transpose(1, 2, 0)),
            nullvec=self._dev(cs.nullvec.cpu().numpy()[:, fm]),
            tau=cs.tau, nt=cs.nt)

    def _local_pc(self, pc, mesh):
        """The rank's GTMG: facet tables of its own facets, the coarse
        tables replicated, the restriction and the stars of the vertices its
        own facets end at."""
        fm = self.facet_maps[self.rank]
        ends_all = _facet_endpoints(mesh)
        ends = ends_all[fm]  # (nf_loc, 2) global vertex ids
        verts = [np.unique(ends_all[m]) for m in self.facet_maps]
        mine = verts[self.rank]
        vf_g, end_g = pc.vf.cpu().numpy(), pc.vf_end.cpu().numpy()
        mask_g = pc.vf_mask.cpu().numpy() > 0
        own = mask_g[mine] & (self.facet_owner[vf_g[mine]] == self.rank)
        dev = lambda t: None if t is None else self._dev(t)
        small = torch.zeros((1, 1), dtype=self.dtype, device=self.device)
        ismall = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        transfers = PartitionTransfers(
            comm=self.comm, verts=self._dev(mine),
            vf=self._dev(np.where(own, self._fpos[vf_g[mine]] + end_g[mine] * fm.shape[0], 0)),
            vf_mask=self._dev(own.astype(np.float64)),
            ends=self._dev(np.searchsorted(mine, ends).T))
        vf, vf_mask, star_inv, star_pos = ismall, small, None, None
        if pc.star_inv is not None:
            needs = [np.unique(vf_g[v][mask_g[v]]) for v in verts]
            transfers.star_plan, sext = _ghost_plans(needs, self.facet_owner, self.facet_maps,
                                                     self._fpos, self.rank, self.device)
            vf = self._dev(np.where(mask_g[mine], sext[vf_g[mine]], 0))
            assert np.all(vf.cpu().numpy() >= 0)
            vf_mask = self._dev(mask_g[mine].astype(np.float64))
            star_inv = self._dev(pc.star_inv.cpu().numpy()[..., mine])
            star_pos = self._dev(pc.star_pos.cpu().numpy()[:, fm])
        return TwoLevelTracePC(
            Sdiag_inv=self.cs.Sdiag_inv, trace_nodes=dev(pc.trace_nodes), sign=pc.sign,
            facet_verts=self._dev(ends.T), K_elem=dev(pc.K_elem), cells=dev(pc.cells),
            K_diag_inv=dev(pc.K_diag_inv), vf=vf, vf_end=ismall, vf_mask=vf_mask,
            vc=dev(pc.vc), vc_pos=dev(pc.vc_pos), vc_mask=dev(pc.vc_mask),
            coarse_eig_inv=dev(pc.coarse_eig_inv), coarse_scale=dev(pc.coarse_scale),
            star_inv=star_inv, star_pos=star_pos, coarse_dense_inv=dev(pc.coarse_dense_inv),
            part=transfers, n_vertices=pc.n_vertices, coarse_kind=pc.coarse_kind,
            grid_shape=pc.grid_shape, cheb_fine=pc.cheb_fine, cheb_coarse=pc.cheb_coarse,
            lmax_fine=pc.lmax_fine, lmax_coarse=pc.lmax_coarse)

    def _local_rt(self, rt):
        """The conforming scheme's RT tables of the own cells and facets."""
        cm, fm = self.cell_maps[self.rank], self.facet_maps[self.rank]
        c = lambda t: self._dev(t.cpu().numpy()[..., cm])
        f = lambda t: self._dev(t.cpu().numpy()[..., fm])
        return RTTables(P_opp=c(rt.P_opp), area=c(rt.area), mass_elem=c(rt.mass_elem),
                        mass_diag_inv=f(rt.mass_diag_inv), xqf=f(rt.xqf),
                        bnd_mask=f(rt.bnd_mask), int_dof_mask=f(rt.int_dof_mask),
                        fslot=facet_slots(self.geom))

    # ------------------------------------------------------------------
    # state movement
    # ------------------------------------------------------------------

    def scatter_cell_field(self, u):
        """This rank's part of a global cell field (..., nc), on its device."""
        u = u.cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
        return self._dev(u[..., self.cell_maps[self.rank]])

    def scatter_facet_field(self, lam):
        """This rank's part of a global facet field (..., nf)."""
        lam = lam.cpu().numpy() if isinstance(lam, torch.Tensor) else np.asarray(lam)
        return self._dev(lam[..., self.facet_maps[self.rank]])

    def _gather(self, local, maps):
        n_max = max(m.shape[0] for m in maps)  # Comm.gather moves one shape
        pad = local.new_zeros(local.shape[:-1] + (n_max - local.shape[-1],))
        parts = self.comm.gather(torch.cat([local, pad], dim=-1))
        if parts is None:
            return None
        n = sum(m.shape[0] for m in maps)
        out = torch.zeros(local.shape[:-1] + (n,), dtype=local.dtype)
        for part, m in zip(parts, maps):
            out[..., torch.as_tensor(m)] = part[..., :m.shape[0]]
        return out

    def gather_cell_field(self, u):
        """The global cell field on the host of rank 0 from every rank's part
        (a collective; None on the other ranks)."""
        return self._gather(u, self.cell_maps)

    def gather_facet_field(self, lam):
        """The global facet field on the host of rank 0 (a collective)."""
        return self._gather(lam, self.facet_maps)
