"""ctypes loader of the port's C++ mesh kernel (``meshkernel.cpp``).

Compiles the source with ``g++ -O3 -shared -fPIC`` on first use into
``build/mesh/libmeshkernel-<hash>.so`` at the repository root (keyed by the
hash of the source and the flags, as the CUDA kernels in ``kernels.py``).
No ``-march=native``: the library runs on any x86-64 host that builds it or
shares its build directory.  Nothing is committed and nothing falls back: a
failed build raises.  The numpy enumeration in ``triangle_mesh.py``
(``use_native=False``) is the plain version the tests compare against.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "native_connectivity", "native_color_cells", "lib_path"]

_SRC = Path(__file__).resolve().parent / "meshkernel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mesh"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_LIB = None
_LOCK = threading.Lock()


def lib_path():
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmeshkernel-{h.hexdigest()[:12]}.so"


def _build(so):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name} (exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)


def get_lib():
    """The loaded shared library, compiled first if needed (raises on a
    failed build)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = lib_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.build_connectivity.restype = ctypes.c_int64
            lib.build_connectivity.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                                               i32p, i32p, i32p, i32p, i64p]
            lib.color_cells.restype = ctypes.c_int32
            lib.color_cells.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p]
            _LIB = lib
        return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_connectivity(n_vertices, cells):
    """Run the C++ connectivity build.

    :returns: (facet_cells, facet_local, facet_flip, cell_facets,
               cell_facet_side, n_interior)
    """
    lib = get_lib()
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc = cells.shape[0]
    cap = 3 * nc
    facet_cells = np.empty((cap, 2), dtype=np.int32)
    facet_local = np.zeros((cap, 2), dtype=np.int32)
    facet_flip = np.zeros((cap, 2), dtype=np.int32)
    cell_facets = np.empty((nc, 3), dtype=np.int32)
    cell_side = np.empty((nc, 3), dtype=np.int32)
    n_int = np.zeros(1, dtype=np.int64)
    nf = int(lib.build_connectivity(
        int(n_vertices), int(nc), _ptr(cells), _ptr(facet_cells), _ptr(facet_local),
        _ptr(facet_flip), _ptr(cell_facets), _ptr(cell_side),
        n_int.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    ))
    return (
        facet_cells[:nf].copy(),
        facet_local[:nf].copy(),
        facet_flip[:nf].copy(),
        cell_facets,
        cell_side,
        int(n_int[0]),
    )


def native_color_cells(n_cells, n_interior_facets, facet_cells):
    """Run the C++ greedy coloring.  Returns (colors, n_colors)."""
    lib = get_lib()
    fc = np.ascontiguousarray(facet_cells, dtype=np.int32)
    colors = np.empty(int(n_cells), dtype=np.int32)
    ncol = lib.color_cells(int(n_cells), int(n_interior_facets), _ptr(fc), _ptr(colors))
    return colors, int(ncol)
