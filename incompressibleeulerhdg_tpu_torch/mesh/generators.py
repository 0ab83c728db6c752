"""Mesh generators of the port: unit square, periodic square, unit disk.

The port's own copies of ``unit_square_mesh``, ``periodic_square_mesh`` and
``unit_disk_mesh`` from incompressibleeulerhdg_tpu/mesh/generators.py (equal
arrays, tests/test_torch_shared.py).  ``use_native`` selects the C++
connectivity kernel (the default) or its numpy plain version.
"""

from collections import Counter

import numpy as np

from .triangle_mesh import build_mesh, attach_shift_structure

__all__ = ["unit_square_mesh", "periodic_square_mesh", "unit_disk_mesh"]


def unit_square_mesh(nx, ny=None, L=1.0, use_native=True):
    """Structured triangulation of [0, L]^2 with 2*nx*ny cells.

    Each grid square is split along the (i, j) -> (i+1, j+1) diagonal.
    Cells are ordered [all lower triangles (i-major); all upper triangles]:
    every lower cell's neighbours are upper cells at fixed grid offsets (and
    vice versa), which turns all facet<->cell data movement into static
    slices/rolls (see :func:`attach_shift_structure`).
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


def periodic_square_mesh(nx, ny=None, L=2.0 * np.pi, use_native=True):
    """Doubly periodic structured triangulation of [0, L]^2.

    Vertices are identified modulo nx/ny; per-cell coordinates are stored
    unwrapped so every cell stays affine.  Needs nx, ny >= 3 so that no two
    distinct facets share the same vertex pair.  The cell order is
    :func:`unit_square_mesh`'s, so the shift structure wraps instead of
    ending at a boundary.
    """
    if ny is None:
        ny = nx
    if nx < 3 or ny < 3:
        raise ValueError("periodic mesh requires nx, ny >= 3")
    xs = np.arange(nx) * (L / nx)
    ys = np.arange(ny) * (L / ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return (i % nx) * ny + (j % ny)

    def coord(i, j):
        return np.array([i * (L / nx), j * (L / ny)])

    lowers, lcoords, uppers, ucoords = [], [], [], []
    for i in range(nx):
        for j in range(ny):
            lowers.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            lcoords.append([coord(i, j), coord(i + 1, j), coord(i + 1, j + 1)])
            uppers.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
            ucoords.append([coord(i, j), coord(i + 1, j + 1), coord(i, j + 1)])
    m = build_mesh(
        vertices,
        np.asarray(lowers + uppers, dtype=np.int32),
        cell_coords=np.asarray(lcoords + ucoords, dtype=np.float64),
        periodic=True,
        use_native=use_native,
    )
    m.structured_grid = ("periodic", nx, ny)
    attach_shift_structure(m, nx, ny, periodic=True)
    return m


def unit_disk_mesh(refinement_level=2, use_native=True):
    """Triangulation of the unit disk by uniform refinement of a hexagon.

    Six triangles around the origin are refined ``refinement_level`` times
    by 4-way edge-midpoint splitting; each new boundary vertex is projected
    onto the unit circle.  The result has no shift structure: every
    facet<->cell move on it is an index gather.
    """
    angles = np.arange(6) * (np.pi / 3.0)
    ring = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    vertices = np.concatenate([[[0.0, 0.0]], ring], axis=0)
    cells = np.array([[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)], dtype=np.int32)

    for _ in range(refinement_level):
        verts = list(vertices)
        edge_mid = {}
        new_cells = []

        # boundary edges are the edges of one cell only
        edge_count = Counter()
        for c in cells:
            for a, b in ((c[0], c[1]), (c[1], c[2]), (c[2], c[0])):
                edge_count[(min(a, b), max(a, b))] += 1

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                pm = 0.5 * (vertices[a] + vertices[b])
                if edge_count[key] == 1:
                    pm = pm / np.linalg.norm(pm)
                edge_mid[key] = len(verts)
                verts.append(pm)
            return edge_mid[key]

        for c in cells:
            m01 = midpoint(c[0], c[1])
            m12 = midpoint(c[1], c[2])
            m20 = midpoint(c[2], c[0])
            new_cells += [
                [c[0], m01, m20],
                [c[1], m12, m01],
                [c[2], m20, m12],
                [m01, m12, m20],
            ]
        vertices = np.asarray(verts)
        cells = np.asarray(new_cells, dtype=np.int32)

    return build_mesh(vertices, cells, use_native=use_native)
