"""The port's own copies of the JAX package's numpy modules equal the
originals on the same inputs: the unit-square, periodic-square and unit-disk
meshes (C++ kernel and numpy plain version, colourings included), the shear
problem's Fourier coefficients, the IMEX tableaus, the quadrature rules,
Lagrange bases and space tabulations, the checkpoint format, the VTK time
series and the grid spacing."""

import dataclasses

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu.fem import lagrange as JL
from incompressibleeulerhdg_tpu.fem import quadrature as JQ
from incompressibleeulerhdg_tpu.fem import spaces as JS
from incompressibleeulerhdg_tpu.mesh import triangle_mesh as JTM
from incompressibleeulerhdg_tpu.mesh import generators as JG
from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh as j_unit_square
from incompressibleeulerhdg_tpu.timesteppers import tableaus as JT
from incompressibleeulerhdg_tpu.utils import checkpoint as JC
from incompressibleeulerhdg_tpu.utils import grid as JGr
from incompressibleeulerhdg_tpu.utils import vtk as JV
from incompressibleeulerhdg_tpu_torch.fem import lagrange as TL
from incompressibleeulerhdg_tpu_torch.fem import quadrature as TQ
from incompressibleeulerhdg_tpu_torch.fem import spaces as TS
from incompressibleeulerhdg_tpu_torch.mesh import generators as TG
from incompressibleeulerhdg_tpu_torch.mesh import native as TN
from incompressibleeulerhdg_tpu_torch.mesh import triangle_mesh as TTM
from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh as t_unit_square
from incompressibleeulerhdg_tpu_torch.timesteppers import tableaus as TT
from incompressibleeulerhdg_tpu_torch.utils import checkpoint as TC
from incompressibleeulerhdg_tpu_torch.utils import grid as TGr
from incompressibleeulerhdg_tpu_torch.utils import vtk as TV

torch.set_num_threads(1)

MESH_ARRAYS = ("vertices", "cells", "cell_coords", "facet_cells", "facet_local", "facet_flip",
               "cell_facets", "cell_facet_side", "normals", "facet_lengths", "jac", "jac_inv",
               "det_jac")
MESH_META = ("n_interior_facets", "periodic", "structured_grid", "facet_color_bounds",
             "shift_spec", "uniform_spec")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("nx", [4, 5, 8])
def test_unit_square_mesh_equals_jax(nx, native):
    jm = j_unit_square(nx)
    tm = t_unit_square(nx, use_native=native)
    for name in MESH_ARRAYS:
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in MESH_META:
        assert getattr(jm, name) == getattr(tm, name), name
    jc, jn = JTM.color_cells(jm)
    tc, tn = TTM.color_cells(tm, use_native=native)
    assert jn == tn
    np.testing.assert_array_equal(jc, tc)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("gen, arg", [("periodic_square_mesh", 6), ("periodic_square_mesh", 8),
                                      ("unit_disk_mesh", 2), ("unit_disk_mesh", 3)])
def test_periodic_and_disk_meshes_equal_jax(gen, arg, native):
    """Arrays, colour bounds, shift and uniform specs (None on the disk) and
    the cell colourings equal."""
    jm = getattr(JG, gen)(arg)
    tm = getattr(TG, gen)(arg, use_native=native)
    for name in MESH_ARRAYS:
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in MESH_META:
        assert getattr(jm, name) == getattr(tm, name), name
    assert (tm.shift_spec is None) == (gen == "unit_disk_mesh")
    jc, jn = JTM.color_cells(jm)
    tc, tn = TTM.color_cells(tm, use_native=native)
    assert jn == tn
    np.testing.assert_array_equal(jc, tc)


def test_periodic_mesh_refuses_fewer_than_three_cells():
    with pytest.raises(ValueError, match=">= 3"):
        TG.periodic_square_mesh(2)


def test_shear_fourier_coefficients_equal_jax():
    """The 28 QUADPACK coefficients of the shear layer's initial pressure."""
    from incompressibleeulerhdg_tpu.models.problems import DoubleLayerShearFlow as JShear
    from incompressibleeulerhdg_tpu_torch.models.problems import DoubleLayerShearFlow as TShear

    jc, tc = JShear(None)._coeffs, TShear(None).coeffs
    assert tc.shape == (28,) and np.all(np.isfinite(tc))
    np.testing.assert_array_equal(tc, jc)


def test_mesh_kernel_builds_into_build_dir():
    """The native kernel is built from the port's source with g++ into the
    repository's build directory, keyed by the source hash, without
    -march=native."""
    TN.get_lib()
    so = TN.lib_path()
    assert so.exists() and so.parent == TN.BUILD_DIR
    assert so.parent.parent.name == "build"
    assert "-march=native" not in TN.CXX_FLAGS


@pytest.mark.parametrize("name", sorted(JT.TABLEAUS))
def test_tableaus_equal_jax(name):
    ja, ta = JT.TABLEAUS[name], TT.TABLEAUS[name]
    for f in dataclasses.fields(ja):
        np.testing.assert_array_equal(getattr(ja, f.name), getattr(ta, f.name), err_msg=f.name)
    for a, b in zip(JT.unroll_residual_coefficients(ja), TT.unroll_residual_coefficients(ta)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 5])
def test_quadrature_and_lagrange_equal_jax(degree):
    for fn in ("triangle_quadrature", "edge_quadrature"):
        for a, b in zip(getattr(JQ, fn)(degree + 3), getattr(TQ, fn)(degree + 3)):
            np.testing.assert_array_equal(a, b, err_msg=fn)
    pts = np.random.default_rng(degree).random((7, 2)) * 0.5
    jb, tb = JL.triangle_basis(degree), TL.triangle_basis(degree)
    for fn in ("tabulate", "tabulate_grad", "tabulate_hess"):
        np.testing.assert_array_equal(getattr(jb, fn)(pts), getattr(tb, fn)(pts), err_msg=fn)
    np.testing.assert_array_equal(JL.edge_basis(degree).tabulate(pts[:, 0]),
                                  TL.edge_basis(degree).tabulate(pts[:, 0]))
    np.testing.assert_array_equal(JL.shifted_legendre(degree, pts[:, 0]),
                                  TL.shifted_legendre(degree, pts[:, 0]))


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_space_tabulations_equal_jax(k):
    jt, tt = JS.tabulate_trace_space(k, 3 * k + 6), TS.tabulate_trace_space(k, 3 * k + 6)
    for sj, st in ((jt, tt),
                   (JS.tabulate_cell_space(k + 1, 3 * k + 5, jt.sq),
                    TS.tabulate_cell_space(k + 1, 3 * k + 5, tt.sq))):
        for f in dataclasses.fields(sj):
            a, b = getattr(sj, f.name), getattr(st, f.name)
            if f.name == "basis":
                continue
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_format_shared(tmp_path, writer):
    """A checkpoint written by either package loads with the other's loader,
    arrays, time and configuration equal."""
    rng = np.random.default_rng(7)
    state = {"Q": [rng.standard_normal((2, 3, 8)) for _ in range(3)],
             "p": rng.standard_normal((3, 8)).astype(np.float32), "lam": None}
    config = {"nx": 4, "degree": 1, "scheme": "imex_ssp2_332"}
    path = tmp_path / "ck.npz"
    save, load = (TC.save_checkpoint, JC.load_checkpoint) if writer == "port" else \
        (JC.save_checkpoint, TC.load_checkpoint)
    save(str(path), state, 0.25, config)
    got, t, cfg = load(str(path), expect_config=config)
    assert t == 0.25 and cfg == config and set(got) == {"Q", "p"}
    for a, b in zip(got["Q"], state["Q"]):
        np.testing.assert_array_equal(a, b)
    assert got["p"].dtype == np.float32
    np.testing.assert_array_equal(got["p"], state["p"])
    with pytest.raises(ValueError, match="mismatch"):
        load(str(path), expect_config={"nx": 8})


def test_vtk_time_series_equals_jax(tmp_path):
    """Both packages' VTKTimeSeries write the same .pvd index and the same
    .vtu files, byte for byte, for the same fields and times (the default
    time is the entry's index)."""
    mesh = t_unit_square(3)
    rng = np.random.default_rng(3)
    frames = [({"velocity": rng.standard_normal((mesh.n_cells, 3, 2)),
                "pressure": rng.standard_normal((mesh.n_cells, 3))}, t) for t in (0.0, 0.05, None)]
    for pkg, name in ((JV, "jax"), (TV, "port")):
        series = pkg.VTKTimeSeries(str(tmp_path / name / "evolution.pvd"))
        for fields, t in frames:
            series.write(mesh, fields, time=t)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["evolution.pvd"] + [f"evolution_{i:05d}.vtu" for i in range(3)]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert 'timestep="2.0"' in (tmp_path / "port" / "evolution.pvd").read_text()
    with pytest.raises(ValueError, match=".pvd"):
        TV.VTKTimeSeries(str(tmp_path / "evolution.vtu"))


@pytest.mark.parametrize("gen, arg", [("unit_square_mesh", 5), ("periodic_square_mesh", 6),
                                      ("unit_disk_mesh", 2)])
def test_gridspacing_equals_jax(gen, arg):
    jm, tm = getattr(JG, gen)(arg), getattr(TG, gen)(arg)
    h = TGr.gridspacing(tm)
    assert h == JGr.gridspacing(jm) and 0 < h[0] <= h[1]
