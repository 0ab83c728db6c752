"""Minimal VTK output: .vtu unstructured-grid files + .pvd time-series index.

The port's own copy of incompressibleeulerhdg_tpu/utils/vtk.py: the driver's
``solution.vtu`` and the ``--animation`` series (``evolution.pvd`` with one
``evolution_<index>.vtu`` a step).  DG fields are written on a disconnected
triangulation (each cell contributes its own three corner points), which
renders DG discontinuities faithfully in ParaView.
"""

import os

import numpy as np

__all__ = ["write_vtu", "VTKTimeSeries", "sample_dg_at_corners"]

_CORNERS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def sample_dg_at_corners(disc, u):
    """Sample a batch-last DG coefficient array at the 3 cell corners.

    (2, d1, nc) velocity -> (nc, 3, 2);  (d0, nc) scalar -> (nc, 3)
    (batch-major outputs: the VTK writer is host-side numpy).
    """
    u = np.asarray(u)
    if u.ndim == 3:  # velocity in V1
        tab = disc.V1.basis.tabulate(_CORNERS)  # (3, d1)
        return np.einsum("pi,aic->cpa", tab, u)
    tab = disc.V0.basis.tabulate(_CORNERS)
    return np.einsum("pi,ic->cp", tab, u)


def write_vtu(filename, mesh, point_data=None):
    """Write a .vtu with per-cell disconnected points.

    :arg point_data: dict name -> (nc, 3) scalar or (nc, 3, 2) vector samples
    """
    nc = mesh.n_cells
    pts = mesh.cell_coords.reshape(-1, 2)
    npts = pts.shape[0]
    lines = []
    a = lines.append
    a('<?xml version="1.0"?>')
    a('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">')
    a("<UnstructuredGrid>")
    a(f'<Piece NumberOfPoints="{npts}" NumberOfCells="{nc}">')
    a("<Points>")
    a('<DataArray type="Float64" NumberOfComponents="3" format="ascii">')
    coords3 = np.concatenate([pts, np.zeros((npts, 1))], axis=1)
    a(" ".join(f"{v:.12g}" for v in coords3.ravel()))
    a("</DataArray>")
    a("</Points>")
    a("<Cells>")
    a('<DataArray type="Int32" Name="connectivity" format="ascii">')
    a(" ".join(str(i) for i in range(npts)))
    a("</DataArray>")
    a('<DataArray type="Int32" Name="offsets" format="ascii">')
    a(" ".join(str(3 * (i + 1)) for i in range(nc)))
    a("</DataArray>")
    a('<DataArray type="UInt8" Name="types" format="ascii">')
    a(" ".join("5" for _ in range(nc)))  # VTK_TRIANGLE
    a("</DataArray>")
    a("</Cells>")
    a("<PointData>")
    for name, data in (point_data or {}).items():
        data = np.asarray(data)
        if data.ndim == 3:  # vector
            flat = np.concatenate(
                [data.reshape(-1, 2), np.zeros((npts, 1))], axis=1
            ).ravel()
            a(
                f'<DataArray type="Float64" Name="{name}" NumberOfComponents="3" format="ascii">'
            )
        else:
            flat = data.ravel()
            a(f'<DataArray type="Float64" Name="{name}" format="ascii">')
        a(" ".join(f"{v:.12g}" for v in flat))
        a("</DataArray>")
    a("</PointData>")
    a("</Piece>")
    a("</UnstructuredGrid>")
    a("</VTKFile>")
    with open(filename, "w") as f:
        f.write("\n".join(lines))


class VTKTimeSeries:
    """.pvd collection of timestamped .vtu files (Firedrake VTKFile analogue)."""

    def __init__(self, filename):
        if not filename.endswith(".pvd"):
            raise ValueError(f"a VTK time series is a .pvd file, got {filename!r}")
        self.filename = filename
        self.base = filename[:-4]
        self.entries = []
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)

    def write(self, mesh, point_data, time=None):
        idx = len(self.entries)
        vtu = f"{self.base}_{idx:05d}.vtu"
        write_vtu(vtu, mesh, point_data)
        self.entries.append((time if time is not None else float(idx), os.path.basename(vtu)))
        self._write_pvd()

    def _write_pvd(self):
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
            "<Collection>",
        ]
        for t, name in self.entries:
            lines.append(f'<DataSet timestep="{t}" group="" part="0" file="{name}"/>')
        lines += ["</Collection>", "</VTKFile>"]
        with open(self.filename, "w") as f:
            f.write("\n".join(lines))
