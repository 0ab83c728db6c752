"""Triangle meshes as flat index arrays.

The port's own copy of incompressibleeulerhdg_tpu/mesh/triangle_mesh.py
(numpy only; equal arrays, tests/test_torch_shared.py).  The connectivity
runs in the port's copy of the C++ mesh kernel (``native``), or in its numpy
plain version when ``use_native=False``; a native kernel that fails to build
raises.  A mesh is a plain container of numpy arrays; all connectivity (interior/boundary facet tables,
facet -> (cell, local facet, flip) maps, cell -> facet maps) is derived once at
setup and later shipped to the device as static integer tables.

Conventions
-----------
- Cells are triangles with counter-clockwise vertex order ``(v0, v1, v2)``.
- Local facet ``l`` is opposite local vertex ``l``:
      facet 0 = (v1, v2), facet 1 = (v2, v0), facet 2 = (v0, v1).
  Traversed in this canonical order the outward normal of a CCW triangle is
  the edge direction rotated by -90 degrees.
- Every global facet has a canonical orientation: from its endpoint with the
  smaller global vertex id to the larger.  A (cell, local facet) pair matches
  the canonical orientation (``flip = 0``) or reverses it (``flip = 1``).
- The facet normal ``normals[f]`` is the outward normal of the "plus" cell
  (``facet_cells[f, 0]``); the minus cell (if any) sees ``-normals[f]``.
- Interior facets are numbered first: ``f < n_interior_facets`` iff interior.
- Periodic meshes identify vertices topologically; per-cell *unwrapped*
  coordinates are stored in ``cell_coords`` so geometry is always local and
  affine.  All downstream geometry uses ``cell_coords``, never ``vertices``.
"""

from dataclasses import dataclass, field
import numpy as np

__all__ = [
    "TriangleMesh",
    "build_mesh",
    "color_cells",
    "color_facets",
    "attach_shift_structure",
]

# local facet l of cell (v0,v1,v2) is (LOCAL_FACET_VERTS[l][0], LOCAL_FACET_VERTS[l][1])
LOCAL_FACET_VERTS = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int32)

# reference coordinates of the three vertices
REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


@dataclass
class TriangleMesh:
    """Immutable triangle mesh with full facet connectivity (all numpy, host-side)."""

    vertices: np.ndarray  # (nv, 2) float64 — topological vertex positions
    cells: np.ndarray  # (nc, 3) int32 — CCW vertex ids (topological)
    cell_coords: np.ndarray  # (nc, 3, 2) float64 — per-cell (unwrapped) vertex coords

    # facet tables (interior facets first)
    facet_cells: np.ndarray = field(default=None)  # (nf, 2) int32, -1 for missing minus
    facet_local: np.ndarray = field(default=None)  # (nf, 2) int32 local facet ids
    facet_flip: np.ndarray = field(default=None)  # (nf, 2) int32 0/1 orientation
    n_interior_facets: int = 0

    # cell -> facet maps
    cell_facets: np.ndarray = field(default=None)  # (nc, 3) int32 global facet id
    cell_facet_side: np.ndarray = field(default=None)  # (nc, 3) int32 0 = plus, 1 = minus

    # geometry
    normals: np.ndarray = field(default=None)  # (nf, 2) outward from plus cell
    facet_lengths: np.ndarray = field(default=None)  # (nf,)
    jac: np.ndarray = field(default=None)  # (nc, 2, 2) d x / d xhat
    jac_inv: np.ndarray = field(default=None)  # (nc, 2, 2)
    det_jac: np.ndarray = field(default=None)  # (nc,) > 0
    periodic: bool = False
    # ("neumann", Mx, My) vertex grid of a structured square mesh, or
    # ("periodic", nx, ny); None for unstructured meshes.  Vertex id layout
    # must be i * My + j.  Enables the FFT coarse solver in linalg/gtmg.py.
    structured_grid: tuple = None
    # interior facets are sorted by conflict-free color (same-color facets
    # share no cell); facet_color_bounds[k]:facet_color_bounds[k+1] slices
    # color k.  Enables multiplicative facet-patch Schwarz sweeps.
    facet_color_bounds: tuple = None
    # shift topology of a [lowers; uppers]-ordered structured grid (see
    # attach_shift_structure); None for unstructured meshes.  When present,
    # every facet<->cell map is a static slice/roll on the (nx, ny) grid
    # (slices/rolls stream at full bandwidth, gathers do not).
    shift_spec: tuple = None
    # per-family geometric constants of a uniform structured mesh (see
    # _attach_uniform_structure); None when any facet family is not
    # congruent.  Enables the factored (Kronecker-structured) tentative
    # operator tables of linalg/preconditioners.py.
    uniform_spec: tuple = None

    @property
    def n_cells(self):
        return self.cells.shape[0]

    @property
    def n_vertices(self):
        return self.vertices.shape[0]

    @property
    def n_facets(self):
        return self.facet_cells.shape[0]

    @property
    def n_boundary_facets(self):
        return self.n_facets - self.n_interior_facets

    def map_to_physical(self, ref_pts):
        """Map reference points (np_, 2) into every cell: (nc, np_, 2)."""
        lam = np.stack(
            [1.0 - ref_pts[:, 0] - ref_pts[:, 1], ref_pts[:, 0], ref_pts[:, 1]], axis=-1
        )  # barycentric (np_, 3)
        return np.einsum("pl,cld->cpd", lam, self.cell_coords)

    @property
    def domain_volume(self):
        return float(np.sum(self.det_jac) / 2.0)


def color_cells(mesh, use_native=True):
    """Greedy coloring of the cell adjacency graph (cells sharing a facet).

    Structured triangulations 2-color (up/down triangles); general meshes get
    <= 4 colors.  ``use_native`` runs the C++ kernel, else the numpy plain
    version.  Returns (colors (nc,), n_colors).
    """
    if use_native:
        from .native import native_color_cells

        return native_color_cells(mesh.n_cells, mesh.n_interior_facets, mesh.facet_cells)
    nc = mesh.n_cells
    nbrs = [[] for _ in range(nc)]
    for f in range(mesh.n_interior_facets):
        a, b = mesh.facet_cells[f]
        nbrs[a].append(b)
        nbrs[b].append(a)
    colors = np.full(nc, -1, dtype=np.int32)
    for c in range(nc):
        used = {colors[n] for n in nbrs[c] if colors[n] >= 0}
        k = 0
        while k in used:
            k += 1
        colors[c] = k
    return colors, int(colors.max()) + 1


def color_facets(mesh):
    """Color interior facets so same-color facets share no cell.

    Each color is then a set of disjoint facet-pair patches, enabling
    *multiplicative* Schwarz sweeps (colored block Gauss-Seidel over
    facet-pair patches, the tentative preconditioner).

    On structured triangulations the facets fall into 3 families by normal
    direction, each a perfect matching of cells (every triangle has exactly
    one edge of each family) — 3 colors.  General meshes fall back to a
    greedy coloring (<= 5 colors: each facet conflicts with at most 4).

    Returns (colors (n_interior_facets,), n_colors).
    """
    nfi = mesh.n_interior_facets
    fc = mesh.facet_cells[:nfi]

    # normal-family coloring: exact for structured meshes
    d = np.round(mesh.normals[:nfi], 9)
    d = np.where((d[:, :1] < 0) | ((d[:, :1] == 0) & (d[:, 1:] < 0)), -d, d)
    fams, fam_id = np.unique(d, axis=0, return_inverse=True)
    if fams.shape[0] <= 4:
        ok = True
        for k in range(fams.shape[0]):
            cells_k = fc[fam_id == k].ravel()
            if np.bincount(cells_k, minlength=mesh.n_cells).max() > 1:
                ok = False
                break
        if ok:
            return fam_id.astype(np.int32), int(fams.shape[0])

    # greedy: smallest color unused by either endpoint cell
    colors = np.full(nfi, -1, dtype=np.int32)
    cell_used = np.zeros((mesh.n_cells, 8), dtype=bool)
    for f in range(nfi):
        a, b = fc[f]
        used = cell_used[a] | cell_used[b]
        k = int(np.argmin(used))
        colors[f] = k
        cell_used[a, k] = True
        cell_used[b, k] = True
    return colors, int(colors.max()) + 1


def _orient_ccw(cells, coords):
    """Flip cells with negative orientation so all are CCW (in unwrapped coords)."""
    e1 = coords[:, 1] - coords[:, 0]
    e2 = coords[:, 2] - coords[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    flip = det < 0
    cells = cells.copy()
    coords = coords.copy()
    cells[flip, 1], cells[flip, 2] = cells[flip, 2], cells[flip, 1].copy()
    coords[flip, 1], coords[flip, 2] = coords[flip, 2], coords[flip, 1].copy()
    return cells, coords


def build_mesh(vertices, cells, cell_coords=None, periodic=False, use_native=True):
    """Construct a TriangleMesh with full connectivity from vertices + cells.

    :arg vertices: (nv, 2) vertex positions (topological; representative coords
        for periodic meshes)
    :arg cells: (nc, 3) vertex ids
    :arg cell_coords: optional (nc, 3, 2) unwrapped per-cell coordinates;
        defaults to ``vertices[cells]``
    :arg periodic: purely informational flag
    :arg use_native: use the C++ connectivity kernel (built on first use;
        a failed build raises), else the numpy plain version
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int32)
    if cell_coords is None:
        cell_coords = vertices[cells]
    cell_coords = np.asarray(cell_coords, dtype=np.float64)
    cells, cell_coords = _orient_ccw(cells, cell_coords)

    nc = cells.shape[0]
    if use_native:
        from .native import native_connectivity

        (facet_cells, facet_local, facet_flip, cell_facets, cell_facet_side,
         n_interior) = native_connectivity(vertices.shape[0], cells)
    else:
        # numpy plain version (identical enumeration to the native kernel)
        half_v = cells[:, LOCAL_FACET_VERTS]  # (nc, 3, 2) endpoint gids
        lo = np.minimum(half_v[..., 0], half_v[..., 1])
        hi = np.maximum(half_v[..., 0], half_v[..., 1])
        keys = lo.astype(np.int64) * (vertices.shape[0] + 1) + hi.astype(np.int64)
        flat_keys = keys.ravel()  # index = 3*cell + local
        uniq, inverse, counts = np.unique(
            flat_keys, return_inverse=True, return_counts=True
        )
        nf = uniq.shape[0]

        facet_cells = np.full((nf, 2), -1, dtype=np.int32)
        facet_local = np.zeros((nf, 2), dtype=np.int32)
        facet_flip = np.zeros((nf, 2), dtype=np.int32)
        seen = np.zeros(nf, dtype=np.int32)
        flips_flat = (half_v[..., 0] > half_v[..., 1]).astype(np.int32).ravel()
        order = np.argsort(inverse, kind="stable")  # group by facet id
        for idx in order:
            f = inverse[idx]
            side = seen[f]
            facet_cells[f, side] = idx // 3
            facet_local[f, side] = idx % 3
            facet_flip[f, side] = flips_flat[idx]
            seen[f] += 1
        assert np.all(counts <= 2), "non-manifold edge detected"

        # reorder: interior first
        interior = counts == 2
        perm = np.concatenate([np.nonzero(interior)[0], np.nonzero(~interior)[0]])
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(nf)
        facet_cells = facet_cells[perm]
        facet_local = facet_local[perm]
        facet_flip = facet_flip[perm]
        n_interior = int(interior.sum())

        # cell -> facets
        cell_facets = inv_perm[inverse].reshape(nc, 3).astype(np.int32)
        cell_facet_side = np.zeros((nc, 3), dtype=np.int32)
        for l in range(3):
            f = cell_facets[:, l]
            cell_facet_side[:, l] = (facet_cells[f, 1] == np.arange(nc)).astype(
                np.int32
            )

    # ---- geometric canonical orientation ---------------------------------
    # Connectivity orients each facet lo->hi by VERTEX GID.  On periodic
    # meshes gids wrap, so the gid order reverses the geometric direction on
    # seam facets — breaking the per-family constancy that the structured
    # GTMG transfers and the slab decomposition rely on.  Re-canonicalize to
    # the coordinate-lexicographic direction of the UNWRAPPED plus-cell
    # endpoints (identical to gid order on non-periodic generated meshes,
    # where gid = i * My + j is itself coordinate-lexicographic); all
    # orientation consumers (ftab trace tables, facet endpoints, trace-node
    # parameterization) read the flip bits, so the swap is self-consistent.
    cp = facet_cells[:, 0]
    lp = facet_local[:, 0]
    pa_ = cell_coords[cp, LOCAL_FACET_VERTS[lp, 0]]
    pb_ = cell_coords[cp, LOCAL_FACET_VERTS[lp, 1]]
    fl_ = facet_flip[:, 0].astype(bool)
    s_ = np.where(fl_[:, None], pb_, pa_)  # current canonical start coords
    e_ = np.where(fl_[:, None], pa_, pb_)
    swap = (s_[:, 0] > e_[:, 0]) | ((s_[:, 0] == e_[:, 0]) & (s_[:, 1] > e_[:, 1]))
    facet_flip[swap, 0] ^= 1
    interior_f = facet_cells[:, 1] >= 0
    facet_flip[swap & interior_f, 1] ^= 1

    # geometry (from unwrapped per-cell coords)
    e1 = cell_coords[:, 1] - cell_coords[:, 0]
    e2 = cell_coords[:, 2] - cell_coords[:, 0]
    jac = np.stack([e1, e2], axis=-1)  # columns are edge vectors
    det = jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0]
    assert np.all(det > 0)
    jac_inv = (
        np.stack(
            [
                np.stack([jac[:, 1, 1], -jac[:, 0, 1]], axis=-1),
                np.stack([-jac[:, 1, 0], jac[:, 0, 0]], axis=-1),
            ],
            axis=1,
        )
        / det[:, None, None]
    )

    # facet geometry from the plus cell, in the canonical orientation above
    cp = facet_cells[:, 0]
    lp = facet_local[:, 0]
    a_loc = LOCAL_FACET_VERTS[lp, 0]
    b_loc = LOCAL_FACET_VERTS[lp, 1]
    pa = cell_coords[cp, a_loc]  # local canonical start (in plus cell)
    pb = cell_coords[cp, b_loc]
    # canonical global direction: local order if flip == 0 else reversed
    fl = facet_flip[:, 0].astype(bool)
    start = np.where(fl[:, None], pb, pa)
    end = np.where(fl[:, None], pa, pb)
    tang = end - start
    lengths = np.linalg.norm(tang, axis=-1)
    # outward normal of plus cell: local edge direction (pa -> pb) rotated -90
    edge = pb - pa
    normals = np.stack([edge[:, 1], -edge[:, 0]], axis=-1) / lengths[:, None]

    mesh = TriangleMesh(
        vertices=vertices,
        cells=cells,
        cell_coords=cell_coords,
        facet_cells=facet_cells,
        facet_local=facet_local,
        facet_flip=facet_flip,
        n_interior_facets=n_interior,
        cell_facets=cell_facets,
        cell_facet_side=cell_facet_side,
        normals=normals,
        facet_lengths=lengths,
        jac=jac,
        jac_inv=jac_inv,
        det_jac=det,
        periodic=periodic,
    )
    return _sort_interior_facets_by_color(mesh)


def _permute_facets(mesh, perm):
    """Renumber facets by ``perm`` (new index f holds old facet perm[f])."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(mesh.n_facets)
    mesh.facet_cells = mesh.facet_cells[perm]
    mesh.facet_local = mesh.facet_local[perm]
    mesh.facet_flip = mesh.facet_flip[perm]
    mesh.normals = mesh.normals[perm]
    mesh.facet_lengths = mesh.facet_lengths[perm]
    mesh.cell_facets = inv[mesh.cell_facets].astype(np.int32)
    return mesh


def _sort_interior_facets_by_color(mesh):
    """Reorder interior facets so each color is a contiguous slice, sorted
    within each color by plus-cell index.

    Per-color patch tables then come from static slices of the assembled
    operator tables — no runtime gathers (cell_facet_side is a property of
    the (cell, facet) pair and is invariant under facet renumbering).  The
    within-color plus-cell sort makes each color of a [lowers; uppers]
    structured mesh a row-major rectangle of the lower-cell grid (the basis
    of the shift fast path, attach_shift_structure).
    """
    colors, ncol = color_facets(mesh)
    nfi = mesh.n_interior_facets
    order = np.lexsort((mesh.facet_cells[:nfi, 0], colors))
    perm = np.concatenate([order, np.arange(nfi, mesh.n_facets)])
    counts = np.bincount(colors, minlength=ncol)
    bounds = tuple(int(x) for x in np.concatenate([[0], np.cumsum(counts)]))
    _permute_facets(mesh, perm)
    mesh.facet_color_bounds = bounds
    return mesh


def attach_shift_structure(mesh, nx, ny, periodic):
    """Detect + record the shift topology of a [lowers; uppers] grid mesh.

    Cell layout contract: cell c < nch = nx*ny is the lower triangle of grid
    square (c // ny, c % ny); cell nch + q is the upper triangle of square q.
    Then (verified below, fallback to ``shift_spec = None`` if any check
    fails):

    - every interior facet has plus = a lower cell, minus = an upper cell,
      with constant plus/minus local slots per facet color and a constant
      grid offset between the two squares;
    - each color's facets are exactly a row-major rectangle of lower cells
      (after the within-color plus-cell sort of build_mesh);
    - boundary facets are re-sorted into contiguous (half, slot) groups,
      each a row-major rectangle (grid line) of its half.

    Records ``mesh.shift_spec`` =
        (nx, ny, periodic,
         slot_off,   # ((3 lower (di,dj) offsets), (3 upper offsets))
         colors,     # per color: (l_plus, l_minus, i0, j0, ni, nj, (di,dj))
         bnd)        # per boundary group: (half, local, i0, j0, ni, nj, f0)
    """
    nch = nx * ny
    mesh.shift_spec = None
    if mesh.n_cells != 2 * nch:
        return mesh
    nfi = mesh.n_interior_facets

    # boundary facets: contiguous (half, slot) groups sorted by cell
    if mesh.n_boundary_facets:
        bl = mesh.facet_local[nfi:, 0]
        bc = mesh.facet_cells[nfi:, 0]
        half = (bc >= nch).astype(np.int64)
        order = np.lexsort((bc, bl, half)) + nfi
        _permute_facets(mesh, np.concatenate([np.arange(nfi), order]))

    fc = mesh.facet_cells
    bounds = mesh.facet_color_bounds
    ncol = len(bounds) - 1
    colors = []
    slot_off = [[None] * 3, [None] * 3]
    for k in range(ncol):
        f0, f1 = bounds[k], bounds[k + 1]
        pc, mc = fc[f0:f1, 0], fc[f0:f1, 1]
        lp, lm = mesh.facet_local[f0:f1, 0], mesh.facet_local[f0:f1, 1]
        if f1 == f0 or not (np.all(pc < nch) and np.all(mc >= nch)):
            return mesh
        l, lu = int(lp[0]), int(lm[0])
        if not (np.all(lp == l) and np.all(lm == lu)):
            return mesh
        pi, pj = pc // ny, pc % ny
        i0, j0 = int(pi.min()), int(pj.min())
        ni, nj = int(pi.max()) - i0 + 1, int(pj.max()) - j0 + 1
        expect = ((i0 + np.arange(ni))[:, None] * ny + (j0 + np.arange(nj))).ravel()
        if (f1 - f0) != ni * nj or not np.array_equal(pc, expect):
            return mesh
        mq = mc - nch
        di, dj = (mq // ny) - pi, (mq % ny) - pj
        if periodic:
            di = (di + nx // 2) % nx - nx // 2
            dj = (dj + ny // 2) % ny - ny // 2
        if not (np.all(di == di[0]) and np.all(dj == dj[0])):
            return mesh
        off = (int(di[0]), int(dj[0]))
        if slot_off[0][l] is not None or slot_off[1][lu] is not None:
            return mesh
        slot_off[0][l] = off
        slot_off[1][lu] = (-off[0], -off[1])
        colors.append((l, lu, i0, j0, ni, nj, off))

    bnd = []
    if mesh.n_boundary_facets:
        bc = mesh.facet_cells[nfi:, 0]
        bl = mesh.facet_local[nfi:, 0]
        half = (bc >= nch).astype(np.int64)
        q = bc - half * nch
        key = half * 3 + bl
        splits = np.flatnonzero(np.diff(key)) + 1
        for seg in np.split(np.arange(bc.size), splits):
            h, l = int(half[seg[0]]), int(bl[seg[0]])
            gi, gj = q[seg] // ny, q[seg] % ny
            i0, j0 = int(gi.min()), int(gj.min())
            ni, nj = int(gi.max()) - i0 + 1, int(gj.max()) - j0 + 1
            expect = ((i0 + np.arange(ni))[:, None] * ny + (j0 + np.arange(nj))).ravel()
            if seg.size != ni * nj or not np.array_equal(q[seg], expect):
                return mesh
            bnd.append((h, l, i0, j0, ni, nj, int(nfi + seg[0])))

    if any(s is None for s in slot_off[0]) or any(s is None for s in slot_off[1]):
        return mesh
    mesh.shift_spec = (
        nx,
        ny,
        bool(periodic),
        (tuple(slot_off[0]), tuple(slot_off[1])),
        tuple(colors),
        tuple(bnd),
    )
    return _attach_uniform_structure(mesh)


def _attach_uniform_structure(mesh):
    """Detect + canonicalize geometric uniformity of a shift-structured mesh.

    On the generated square meshes every facet family (interior color or
    boundary group) consists of congruent facets, but the floating-point
    geometry pipeline produces values differing in the last ulps across a
    family.  This pass verifies near-uniformity (rtol 1e-12), REWRITES the
    per-facet normals / lengths to the family representative (making them
    bitwise-constant per family — which is also what the exact geometry of
    the uniform mesh prescribes), and records

        mesh.uniform_spec = (colors_u, halves_u)
        colors_u[k]    = (t_plus, t_minus, flen, n_x, n_y)  per interior color
        halves_u[h][l] = (t_own, flen, n_x, n_y)   per (cell half, local slot)

    as static Python scalars (t_* are trace-tabulation indices 2*local+flip).
    These let the tentative-operator build factor its facet penalty blocks
    into per-family CONSTANT (nu, nu) matrices on top of scalar (d1, d1, .)
    advection tables — a ~4x HBM-traffic cut on the assembled matvec
    (linalg/preconditioners.py).  Meshes failing any check keep
    ``uniform_spec = None`` and nothing is rewritten.
    """
    spec = mesh.shift_spec
    if spec is None:
        return mesh
    nx, ny, periodic, _slot_off, colors, bnd = spec[:6]
    nch = nx * ny
    rtol = 1.0e-12
    ftab = 2 * mesh.facet_local + mesh.facet_flip  # (nf, 2)
    bounds = mesh.facet_color_bounds

    def rep(a):
        """Representative value of a near-constant array, or None."""
        a = np.asarray(a)
        r = a[0]
        tol = rtol * max(1.0, float(np.max(np.abs(a))))
        return r if np.all(np.abs(a - r) <= tol) else None

    # families: interior colors then boundary groups, each a facet slice
    fams = [(slice(bounds[k], bounds[k + 1]), True) for k in range(len(colors))]
    fams += [
        (slice(f0, f0 + ni * nj), False) for (_h, _l, _i0, _j0, ni, nj, f0) in bnd
    ]

    colors_u = []
    canon_n = mesh.normals.copy()
    canon_len = mesh.facet_lengths.copy()
    for fam, interior in fams:
        # the LOCAL slot must be constant per family; the flip bit may vary
        # (periodic wrap seams) as long as both sides flip TOGETHER — a
        # joint flip mirrors the facet quadrature, under which the penalty
        # mass products (all that the uniform constants feed) are invariant
        t0 = ftab[fam, 0]
        if not np.all(t0 // 2 == t0[0] // 2):
            return mesh
        if interior:
            t1 = ftab[fam, 1]
            if not np.all(t1 // 2 == t1[0] // 2):
                return mesh
            if not np.all((t0 % 2) == (t1 % 2) ^ (t0[0] % 2) ^ (t1[0] % 2)):
                return mesh
        ln = rep(mesh.facet_lengths[fam])
        n0 = rep(canon_n[fam, 0])
        n1 = rep(canon_n[fam, 1])
        if ln is None or n0 is None or n1 is None:
            return mesh
        canon_len[fam] = ln
        canon_n[fam, 0] = n0
        canon_n[fam, 1] = n1
        if interior:
            colors_u.append(
                (int(t0[0]), int(t1[0]), float(ln), float(n0), float(n1))
            )

    # per (half, slot) own-cell constants, spanning interior AND boundary
    # facets of the slot (their canonicalized geometry must agree; normal
    # sign is irrelevant — only n (x) n enters the penalty)
    halves_u = []
    for h in (0, 1):
        cells = np.arange(h * nch, (h + 1) * nch)
        slots = []
        for l in range(3):
            fl = mesh.cell_facets[cells, l]
            side = mesh.cell_facet_side[cells, l]
            t = ftab[fl, side]
            # flip-insensitive (see the color check above): the own-cell
            # penalty products Pt[2l] == Pt[2l+1] under symmetric quadrature
            if not np.all(t // 2 == t[0] // 2):
                return mesh
            # a slot can span two families (interior color + boundary group)
            # whose canonical representatives differ in the last ulp —
            # tolerance-compare, the ~1e-16 slack only perturbs the factored
            # operator at the level of a single rounding
            if rep(canon_len[fl]) is None:
                return mesh
            nn = canon_n[fl]  # (nch, 2), constant up to sign within the slot
            s = np.where(nn @ canon_n[fl[0]] >= 0.0, 1.0, -1.0)
            if rep(s[:, None] * nn - canon_n[fl[0]][None, :] + 1.0) is None:
                return mesh
            slots.append(
                (
                    int(t[0]),
                    float(canon_len[fl[0]]),
                    float(canon_n[fl[0], 0]),
                    float(canon_n[fl[0], 1]),
                )
            )
        halves_u.append(tuple(slots))

    mesh.normals = canon_n
    mesh.facet_lengths = canon_len
    mesh.uniform_spec = (tuple(colors_u), tuple(halves_u))
    return mesh
