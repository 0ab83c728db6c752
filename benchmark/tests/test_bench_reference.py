"""The plain reference (reference.py) on the CPU, at tiny sizes."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cell as C
from benchmark import manifest, reference as R

HERE = Path(__file__).resolve().parents[1]


def test_reference_imports_numpy_only():
    tree = ast.parse((HERE / "reference.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names == {"numpy"}


@pytest.mark.parametrize("m", [0, 1, 2, 3, 5])
def test_lagrange_bases_are_nodal(m):
    b = R.TriangleLagrange(m)
    np.testing.assert_allclose(b(b.nodes), np.eye(len(b.nodes)), atol=1e-10)
    e = R.EdgeLagrange(m)
    np.testing.assert_allclose(e(e.nodes), np.eye(m + 1), atol=1e-10)


def test_rules_integrate_polynomials():
    pts, w = R.triangle_rule(5)
    assert w.sum() == pytest.approx(0.5)
    # int_T x^2 y^3 = 2! 3! / 7!
    assert np.sum(w * pts[:, 0] ** 2 * pts[:, 1] ** 3) == pytest.approx(2 * 6 / 5040)
    s, ws = R.edge_rule(4)
    assert np.sum(ws * s ** 7) == pytest.approx(1 / 8)


def test_wrong_facet_list_is_refused():
    vertices, cells = R.unit_square(3)
    edges = np.concatenate([cells[:, [1, 2]], cells[:, [2, 0]], cells[:, [0, 1]]])
    uniq = np.unique(np.sort(edges, axis=1), axis=0)
    R.check_facets(uniq[::-1], vertices, cells)
    with pytest.raises(ValueError):
        R.check_facets(uniq[1:], vertices, cells)
    with pytest.raises(ValueError):
        R.check_facets(np.concatenate([uniq[:-1], uniq[:1]]), vertices, cells)


@pytest.fixture(scope="module")
def tiny_cell():
    spec = manifest.cell_spec("tg-k2-512")
    traffic = dict(spec.traffic, nx=8, dt=1 / 16)
    cell = C.set_up(spec.config, traffic, spec.problem, {"kappa": 0.5}, torch.device("cpu"))
    return spec, traffic, cell


def test_program_interpolant_of_a_polynomial_is_exact(tiny_cell):
    _, traffic, cell = tiny_cell
    disc = cell.stepper.disc
    fn = lambda x, y: (x ** 3 - 2 * x * y ** 2 + y, x * y + y ** 3)  # noqa: E731
    Q = disc.interpolate_velocity(fn).to(torch.float64).numpy()
    vertices, cells = R.unit_square(traffic["nx"])
    np.testing.assert_array_equal(cell.mesh.cells, cells)
    err = R._cell_sq_error(Q, R.TriangleLagrange(3), R.triangle_rule(7), vertices[cells], fn, 50)
    assert err < 1e-12  # float32 nodal values: a squared error at its rounding


def test_errors_agree_with_the_program_and_see_a_flipped_trace(tiny_cell):
    spec, traffic, cell = tiny_cell
    from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen

    Q, p, lam, cells, ends = C.state_arrays(cell)
    t = cell.steps_done * cell.dt
    errs = R.state_errors(Q, p, lam, cells, ends, traffic["nx"], 2, 0.5, t)
    Qe, _ = TaylorGreen(cell.stepper.disc, kappa=0.5).solution(t)
    own = cell.stepper.velocity_error_norm(cell.state[0][0], Qe)
    # the program measures against the interpolant, the reference against
    # the solution itself: they differ by the interpolation error
    assert errs["velocity_l2"] == pytest.approx(own, rel=0.05)
    assert errs["trace_rms"] < 1e-3 and errs["pressure_l2"] < 1e-3
    flipped = R.state_errors(Q, p, lam[::-1].copy(), cells, ends, traffic["nx"], 2, 0.5, t)
    assert flipped["trace_rms"] > 30 * errs["trace_rms"]
    with pytest.raises(ValueError):
        R.state_errors(Q, p, lam, cells[::-1].copy(), ends, traffic["nx"], 2, 0.5, t)
