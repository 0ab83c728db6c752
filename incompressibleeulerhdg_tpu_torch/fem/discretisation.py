"""Geometry and tabulation tables as PyTorch tensors on one device.

Counterpart of incompressibleeulerhdg_tpu/fem/discretisation.py.  The host
tables are built by the same numpy code (:func:`geom_host_arrays`, a copy of
the JAX package's lines 224-306 without the JAX types) from the port's own
copies of the numpy modules (``mesh/``, ``fem/spaces.py``); :class:`Geom`
holds them as tensors on the discretisation's device.

Layouts are BATCH-LAST, as in the JAX package:

    velocity   Q      (2, d1, n_cells)   nodal DG(k+1), component-major
    pressure   p      (d0, n_cells)      nodal DG(k)
    trace      lam    (nt, n_facets)     nodal DGT(k), single-valued per facet

so one thread per entity reads coalesced, and the parity tests compare the
two packages' arrays without reshapes.
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from .spaces import tabulate_cell_space, tabulate_trace_space

__all__ = ["Geom", "HDGDiscretisation", "geom_host_arrays"]

_INT_FIELDS = {"fcells", "ftab", "cell_facets", "cfside", "cfassemble", "cf_tab",
               "fcol_pos", "fcol_side"}
_BOOL_FIELDS = {"cf_bnd"}
META_FIELDS = ("n_int", "degree", "fcol_bounds", "fcol_orphans", "shift", "uniform")


@dataclass
class Geom:
    """Device-resident geometry/tabulation tables (see module docstring)."""

    # quadrature + reference tabulations
    wq: torch.Tensor  # (nq,) cell quadrature weights
    phi1: torch.Tensor  # (nq, d1) DG(k+1) values
    gphi1: torch.Tensor  # (nq, d1, 2) DG(k+1) reference gradients
    hphi1: torch.Tensor  # (nq, d1, 2, 2) DG(k+1) reference second derivatives
    tgphi1: torch.Tensor  # (6, nqf, d1, 2) facet traces of reference gradients
    phi0: torch.Tensor  # (nq, d0) DG(k)
    gphi0: torch.Tensor  # (nq, d0, 2)
    wqf: torch.Tensor  # (nqf,) facet quadrature weights on [0, 1]
    sqf: torch.Tensor  # (nqf,) facet quadrature points
    tr: torch.Tensor  # (nqf, nt) DGT(k) basis at facet quadrature
    tphi1: torch.Tensor  # (6, nqf, d1) facet traces, index 2*local+flip
    tphi0: torch.Tensor  # (6, nqf, d0)
    # per-cell geometry
    det_jac: torch.Tensor  # (nc,)
    jac_inv: torch.Tensor  # (2, 2, nc): d/dx_a phi = gphi[..., b] jac_inv[b, a]
    # per-facet data (interior facets first)
    normal: torch.Tensor  # (2, nf) outward from the plus cell
    flen: torch.Tensor  # (nf,)
    hF_inv: torch.Tensor  # (nf,)
    fcells: torch.Tensor  # (2, nf) int64; [1] clamped to 0 on boundary facets
    ftab: torch.Tensor  # (2, nf) int64 trace-table index per side
    # cell -> facet maps
    cell_facets: torch.Tensor  # (3, nc) int64
    cfside: torch.Tensor  # (3, nc) int64 0 plus / 1 minus
    cfsign: torch.Tensor  # (3, nc) +1 if the facet normal is outward
    cfassemble: torch.Tensor  # (3, nc) int64
    cf_tab: torch.Tensor  # (3, nc) int64 trace-table index of the cell's side
    cf_bnd: torch.Tensor  # (3, nc) bool
    # physical coordinates
    xq: torch.Tensor  # (2, nq, nc)
    xnodes1: torch.Tensor  # (2, d1, nc)
    xnodes0: torch.Tensor  # (2, d0, nc)
    # reference mass matrices and inverses
    m1: torch.Tensor
    m0: torch.Tensor
    m1inv: torch.Tensor
    m0inv: torch.Tensor
    mtinv: torch.Tensor
    # facet-colour patch maps
    fcol_pos: torch.Tensor  # (ncol, nc) int64
    fcol_side: torch.Tensor  # (ncol, nc) int64
    fcol_mask: torch.Tensor  # (ncol, nc)
    # slab-local layouts only (parallel/slab.py), else None: interior facet
    # mask (boundary facets sit inside the colour rectangles there), the
    # real facet positions of the uniform layout, the real cells of an
    # uneven split
    fint: torch.Tensor = None  # (nf,)
    fvalid: torch.Tensor = None  # (nf,)
    cvalid: torch.Tensor = None  # (nc,)
    # static metadata
    n_int: int = 0
    degree: int = 1
    fcol_bounds: tuple = ()
    fcol_orphans: bool = False
    shift: tuple = None
    uniform: tuple = None
    # not a field: set on partition-local geometries only
    # (parallel/partition.py), the communicator, the ghost plans of the
    # gather tables and the static tables with their ghost entries (a
    # ``PartitionTables``)
    part = None

    @property
    def n_cells(self):
        return self.det_jac.shape[0]

    @property
    def n_facets(self):
        return self.normal.shape[1]

    @property
    def d1(self):
        return self.phi1.shape[1]

    @property
    def d0(self):
        return self.phi0.shape[1]

    @property
    def nt(self):
        return self.tr.shape[1]

    @property
    def device(self):
        return self.det_jac.device

    @property
    def dtype(self):
        return self.det_jac.dtype

    @classmethod
    def from_arrays(cls, arrays, dtype, device):
        """Build from host arrays (a dict or an object with the field names):
        floats to ``dtype``, index tables to int64, on ``device``."""
        get = arrays.get if isinstance(arrays, dict) else (lambda k: getattr(arrays, k, None))
        kw = {}
        for f in fields(cls):
            v = get(f.name)
            if f.name in META_FIELDS or v is None:
                kw[f.name] = v
            elif f.name in _INT_FIELDS:
                kw[f.name] = torch.as_tensor(np.asarray(v, np.int64), device=device)
            elif f.name in _BOOL_FIELDS:
                kw[f.name] = torch.as_tensor(np.asarray(v, bool), device=device)
            else:
                kw[f.name] = torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                             device=device)
        return cls(**kw)


def geom_host_arrays(mesh, V1, V0, Vt, degree):
    """Host (numpy float64/int) geometry tables of a mesh -- the numpy part of
    the JAX package's HDGDiscretisation.__init__."""
    m = mesh
    fcells = m.facet_cells.copy()
    fcells[fcells < 0] = 0
    ftab = 2 * m.facet_local + m.facet_flip
    cfsign = np.where(m.cell_facet_side == 0, 1.0, -1.0)
    cf_tab = ftab[m.cell_facets, m.cell_facet_side]
    cf_bnd = m.cell_facets >= m.n_interior_facets
    xq = m.map_to_physical(V1.qp)
    xnodes1 = m.map_to_physical(V1.nodes)
    xnodes0 = m.map_to_physical(V0.nodes)

    bounds = m.facet_color_bounds
    ncol = len(bounds) - 1
    nc = m.n_cells
    fcol_pos = np.zeros((ncol, nc), dtype=np.int64)
    fcol_side = np.zeros((ncol, nc), dtype=np.int64)
    fcol_mask = np.zeros((ncol, nc))
    for kc in range(ncol):
        fk = np.arange(bounds[kc], bounds[kc + 1])
        for s in (0, 1):
            cks = m.facet_cells[fk, s]
            fcol_pos[kc, cks] = fk - bounds[kc]
            fcol_side[kc, cks] = s
            fcol_mask[kc, cks] = 1.0
    return dict(
        wq=V1.qw, phi1=V1.phi, gphi1=V1.gphi, hphi1=V1.hphi, tgphi1=V1.tgphi,
        phi0=V0.phi, gphi0=V0.gphi, wqf=Vt.wq, sqf=Vt.sq, tr=Vt.tr,
        tphi1=V1.tphi, tphi0=V0.tphi,
        det_jac=m.det_jac, jac_inv=m.jac_inv.transpose(1, 2, 0),
        normal=m.normals.T, flen=m.facet_lengths, hF_inv=1.0 / m.facet_lengths,
        fcells=fcells.T, ftab=ftab.T, cell_facets=m.cell_facets.T,
        cfside=m.cell_facet_side.T, cfsign=cfsign.T,
        cfassemble=(m.cell_facets + m.cell_facet_side * m.n_facets).T,
        cf_tab=cf_tab.T, cf_bnd=cf_bnd.T,
        xq=xq.transpose(2, 1, 0), xnodes1=xnodes1.transpose(2, 1, 0),
        xnodes0=xnodes0.transpose(2, 1, 0),
        m1=V1.mass_ref, m0=V0.mass_ref, m1inv=V1.mass_ref_inv,
        m0inv=V0.mass_ref_inv, mtinv=Vt.mass_ref_inv,
        fcol_pos=fcol_pos, fcol_side=fcol_side, fcol_mask=fcol_mask,
        n_int=int(m.n_interior_facets), degree=int(degree),
        fcol_bounds=tuple(int(b) for b in bounds),
        fcol_orphans=bool(np.any(fcol_mask.sum(axis=0) == 0.0)),
        shift=getattr(m, "shift_spec", None),
        uniform=getattr(m, "uniform_spec", None),
    )


class HDGDiscretisation:
    """Host-side bundle: mesh + tabulations + the device :class:`Geom`.

    :arg mesh: a ``TriangleMesh`` (``incompressibleeulerhdg_tpu_torch.mesh``)
    :arg degree: polynomial degree k of the pressure space (velocity k+1)
    :arg dtype: floating dtype of every table and field
    :arg device: device every tensor is created on: the card unless the
        caller asks for the CPU (``device="cpu"``)
    """

    def __init__(self, mesh, degree, dtype=torch.float64, device="cuda"):
        self.mesh = mesh
        self.degree = int(degree)
        self.dtype = dtype
        self.device = torch.device(device)
        k = self.degree
        self.Vt = tabulate_trace_space(k, 3 * k + 6)
        self.V1 = tabulate_cell_space(k + 1, 3 * k + 5, self.Vt.sq)
        self.V0 = tabulate_cell_space(k, 3 * k + 5, self.Vt.sq)
        self.geom = Geom.from_arrays(
            geom_host_arrays(mesh, self.V1, self.V0, self.Vt, k), dtype, self.device
        )
        self.domain_volume = mesh.domain_volume

    def interpolate_velocity(self, fn):
        """Nodal interpolation of ``fn(x, y) -> (fx, fy)`` into V_Q: (2, d1, nc)."""
        x = self.geom.xnodes1
        fx, fy = fn(x[0], x[1])
        fx, fy = torch.broadcast_tensors(torch.as_tensor(fx), torch.as_tensor(fy))
        return torch.stack([fx, fy]).to(self.dtype)

    def interpolate_pressure(self, fn):
        """Nodal interpolation of scalar ``fn(x, y)`` into V_p: (d0, nc)."""
        x = self.geom.xnodes0
        return torch.as_tensor(fn(x[0], x[1])).broadcast_to(x.shape[1:]).to(self.dtype)
