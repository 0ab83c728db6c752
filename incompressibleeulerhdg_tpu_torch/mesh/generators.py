"""Mesh generator of the port: the structured unit square.

The port's own copy of ``unit_square_mesh`` from
incompressibleeulerhdg_tpu/mesh/generators.py (the periodic square and the
unit disk wait for ROADMAP M9).
"""

import numpy as np

from .triangle_mesh import build_mesh, attach_shift_structure

__all__ = ["unit_square_mesh"]


def unit_square_mesh(nx, ny=None, L=1.0, use_native=True):
    """Structured triangulation of [0, L]^2 with 2*nx*ny cells.

    Each grid square is split along the (i, j) -> (i+1, j+1) diagonal.
    Cells are ordered [all lower triangles (i-major); all upper triangles]:
    every lower cell's neighbours are upper cells at fixed grid offsets (and
    vice versa), which turns all facet<->cell data movement into static
    slices/rolls (see :func:`attach_shift_structure`).  ``use_native``
    selects the C++ connectivity kernel (the default) or its numpy plain
    version.
    """
    if ny is None:
        ny = nx
    xs = np.linspace(0.0, L, nx + 1)
    ys = np.linspace(0.0, L, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return i * (ny + 1) + j

    lowers, uppers = [], []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            lowers.append([v00, v10, v11])
            uppers.append([v00, v11, v01])
    m = build_mesh(vertices, np.asarray(lowers + uppers, dtype=np.int32), use_native=use_native)
    m.structured_grid = ("neumann", nx + 1, ny + 1)
    attach_shift_structure(m, nx, ny, periodic=False)
    return m
