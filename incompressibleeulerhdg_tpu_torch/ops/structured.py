"""Shift-structured facet<->cell data movement for [lowers; uppers] grid meshes.

Counterpart of incompressibleeulerhdg_tpu/ops/structured.py.
On the structured square meshes every facet<->cell map is a shift map: with
cells ordered [all lower triangles; all upper triangles] each facet colour is
a row-major rectangle of the lower-cell grid whose minus cells sit at a fixed
grid offset.  Every move is then a reshape, ``narrow``/``pad`` or
``torch.roll`` -- no index gathers.

``geom.shift`` is the static spec ``(nx, ny, periodic, slot_off, colors, bnd)``
of mesh/triangle_mesh.py:attach_shift_structure; ``roll2(geom, a, off)[p] =
a[p + off]`` with zero fill (Neumann) or wraparound (periodic).  A
slab-local spec (parallel/slab.py) appends ``(comm, n_slabs, sweep
order)``: the i axis is cut across ranks, and an i shift brings one grid row
from the neighbouring rank (:func:`_dist_shift_i`).  Slab-local geometries also mask
the dummy facet positions of their uniform layout (``geom.fvalid``) and the
dummy cells of an uneven split (``geom.cvalid``) to zero in every move.
"""

import torch
import torch.nn.functional as F

__all__ = [
    "grid_halves",
    "grid_join",
    "shift2",
    "roll2",
    "rect_slice",
    "rect_flat",
    "rect_pad",
    "dist_axis",
    "gather_plus",
    "gather_minus",
    "scatter_sides_sum",
    "slot_gather",
    "slot_scatter",
]


def grid_halves(geom, u):
    """Split a cell field (..., nc) into lower/upper (..., nx, ny) grids."""
    nx, ny = geom.shift[0], geom.shift[1]
    nch = nx * ny
    shape = u.shape[:-1] + (nx, ny)
    return u[..., :nch].reshape(shape), u[..., nch:].reshape(shape)


def grid_join(geom, lo, up):
    """Inverse of :func:`grid_halves`: two (..., nx, ny) -> (..., nc)."""
    shape = lo.shape[:-2] + (-1,)
    return torch.cat([lo.reshape(shape), up.reshape(shape)], dim=-1)


def _shift_axis(a, d, axis, wrap):
    """out[..., i, ...] = a[..., i + d, ...] along axis -1 or -2; zero fill
    unless ``wrap``."""
    if d == 0:
        return a
    if wrap:
        return torch.roll(a, -d, dims=axis)
    n = a.shape[axis]
    if abs(d) >= n:
        return torch.zeros_like(a)
    # negative padding crops: drop |d| entries at one end, zero-fill the other
    pad = (-d, d) if axis == -1 else (0, 0, -d, d)
    return F.pad(a, pad)


def shift2(a, off, wrap):
    """Neighbour lookup on (..., nx, ny): out[p] = a[p + off]."""
    return _shift_axis(_shift_axis(a, off[0], -2, wrap), off[1], -1, wrap)


def dist_axis(geom):
    """The communicator of a slab-local (parallel/slab.py) or partition-local
    (parallel/partition.py) geometry, or None."""
    if geom.part is not None:
        return geom.part.comm
    s = geom.shift
    if s is not None and len(s) > 6 and s[6] is not None:
        return s[6][0]
    return None


def sweep_order(geom):
    """The colours in the order of the multiplicative Schwarz sweep: as
    stored, or on a slab-local layout (which stores its colours by plus
    slot) in the global mesh's order."""
    s = geom.shift
    if s is not None and len(s) > 6 and s[6] is not None:
        return s[6][2]
    return range(len(geom.fcol_bounds) - 1)


def _dist_shift_i(a, d, wrap, comm):
    """Distributed i shift: the local shift plus one grid row from the
    neighbouring rank (the only i offsets of any spec are +-1).  A rank that
    receives from nobody (the global Neumann end) gets zeros, the zero fill
    of the local shift; a periodic mesh wraps between the last and the first
    rank."""
    assert d in (1, -1), d
    r, n = comm.rank, comm.size
    left = r - 1 if r > 0 else (n - 1 if wrap else None)
    right = r + 1 if r < n - 1 else (0 if wrap else None)
    if d == 1:
        # out[i] = a[i + 1]: my row 0 is my left neighbour's last row
        recv = comm.halo(a[..., :1, :], left, right)
        return torch.cat([a[..., 1:, :], recv], dim=-2)
    recv = comm.halo(a[..., -1:, :], right, left)
    return torch.cat([recv, a[..., :-1, :]], dim=-2)


def roll2(geom, a, off):
    """:func:`shift2` with the mesh's wrap mode; on a slab-local spec the i
    shift exchanges one row with the neighbouring rank."""
    spec = geom.shift
    wrap = spec[2]
    comm = dist_axis(geom)
    if comm is not None and off[0] != 0:
        a = _dist_shift_i(a, off[0], wrap, comm)
    else:
        a = _shift_axis(a, off[0], -2, wrap)
    return _shift_axis(a, off[1], -1, wrap)


def _neg(off):
    return (-off[0], -off[1])


def rect_slice(a, rect):
    """(..., nx, ny) -> (..., ni, nj) at rect = (i0, j0, ni, nj)."""
    i0, j0, ni, nj = rect
    return a[..., i0 : i0 + ni, j0 : j0 + nj]


def rect_flat(a, rect):
    """rect_slice flattened to the facet axis: (..., ni * nj)."""
    s = rect_slice(a, rect)
    return s.reshape(s.shape[:-2] + (-1,))


def rect_pad(geom, a, rect):
    """(..., ni * nj) -> zero-padded (..., nx, ny) at rect."""
    nx, ny = geom.shift[0], geom.shift[1]
    i0, j0, ni, nj = rect
    a = a.reshape(a.shape[:-1] + (ni, nj))
    return F.pad(a, (j0, ny - j0 - nj, i0, nx - i0 - ni))


def _fvalid(geom, x):
    """Zero the dummy facet positions of a slab-local layout."""
    return x if geom.fvalid is None else x * geom.fvalid


def _cvalid(geom, x):
    """Zero the dummy cells of an uneven slab split.  The seam facet between
    the last real column and the first dummy column is a global boundary
    facet, but the dummy cell at its minus side exists locally and would
    catch its contributions: masking every move that makes a cell field
    keeps the dummy cells zero for the whole step."""
    return x if geom.cvalid is None else x * geom.cvalid


def gather_plus(geom, u):
    """Plus-cell values of a cell field at every facet: (..., nc) -> (..., nf)."""
    colors, bnd = geom.shift[4], geom.shift[5]
    lo, up = grid_halves(geom, u)
    parts = [rect_flat(lo, col[2:6]) for col in colors]
    parts += [rect_flat(lo if h == 0 else up, (i0, j0, ni, nj))
              for (h, l, i0, j0, ni, nj, f0) in bnd]
    return _fvalid(geom, torch.cat(parts, dim=-1))


def gather_minus(geom, u):
    """Minus-cell values at every facet; zero on boundary facets."""
    colors, bnd = geom.shift[4], geom.shift[5]
    _, up = grid_halves(geom, u)
    parts = [rect_flat(roll2(geom, up, col[6]), col[2:6]) for col in colors]
    if bnd:
        nbnd = sum(ni * nj for (_, _, _, _, ni, nj, _) in bnd)
        parts.append(u.new_zeros(up.shape[:-2] + (nbnd,)))
    return _fvalid(geom, torch.cat(parts, dim=-1))


def scatter_sides_sum(geom, c0, c1):
    """Accumulate per-facet contributions into cells: 2 x (..., nf) -> (..., nc).

    c0 targets each facet's plus cell, c1 its minus cell (interior facets
    only; boundary entries of c1 are ignored).
    """
    colors, bnd = geom.shift[4], geom.shift[5]
    c0, c1 = _fvalid(geom, c0), _fvalid(geom, c1)
    b = geom.fcol_bounds
    acc_lo = 0.0
    acc_up = 0.0
    for k, (l, lu, i0, j0, ni, nj, off) in enumerate(colors):
        rect = (i0, j0, ni, nj)
        acc_lo = acc_lo + rect_pad(geom, c0[..., b[k] : b[k + 1]], rect)
        acc_up = acc_up + roll2(
            geom, rect_pad(geom, c1[..., b[k] : b[k + 1]], rect), _neg(off)
        )
    for (h, l, i0, j0, ni, nj, f0) in bnd:
        pad = rect_pad(geom, c0[..., f0 : f0 + ni * nj], (i0, j0, ni, nj))
        if h == 0:
            acc_lo = acc_lo + pad
        else:
            acc_up = acc_up + pad
    return _cvalid(geom, grid_join(geom, acc_lo, acc_up))


def slot_gather(geom, gf):
    """Facet values per local cell slot: (..., nf) -> 3-list of (..., nc).

    Slot l of cell c holds ``gf[..., cell_facets[l, c]]`` -- the cell-major
    layout of the condensed trace system (linalg/condense.py).
    """
    colors, bnd = geom.shift[4], geom.shift[5]
    gf = _fvalid(geom, gf)
    b = geom.fcol_bounds
    lo_blocks = [0.0] * 3
    up_blocks = [0.0] * 3
    for k, (l, lu, i0, j0, ni, nj, off) in enumerate(colors):
        pad = rect_pad(geom, gf[..., b[k] : b[k + 1]], (i0, j0, ni, nj))
        lo_blocks[l] = lo_blocks[l] + pad
        up_blocks[lu] = up_blocks[lu] + roll2(geom, pad, _neg(off))
    for (h, l, i0, j0, ni, nj, f0) in bnd:
        pad = rect_pad(geom, gf[..., f0 : f0 + ni * nj], (i0, j0, ni, nj))
        if h == 0:
            lo_blocks[l] = lo_blocks[l] + pad
        else:
            up_blocks[l] = up_blocks[l] + pad
    return [_cvalid(geom, grid_join(geom, lo_blocks[l], up_blocks[l])) for l in range(3)]


def slot_scatter(geom, y_slots):
    """Adjoint of :func:`slot_gather`: 3-list of (..., nc) -> (..., nf)."""
    colors, bnd = geom.shift[4], geom.shift[5]
    halves = [grid_halves(geom, y) for y in y_slots]
    parts = []
    for (l, lu, i0, j0, ni, nj, off) in colors:
        rect = (i0, j0, ni, nj)
        parts.append(rect_flat(halves[l][0], rect)
                     + rect_flat(roll2(geom, halves[lu][1], off), rect))
    parts += [rect_flat(halves[l][h], (i0, j0, ni, nj))
              for (h, l, i0, j0, ni, nj, f0) in bnd]
    return _fvalid(geom, torch.cat(parts, dim=-1))
