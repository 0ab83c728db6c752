"""CUDA graphs of the Krylov loops' preconditioners at k = 7 in float64.

At k = 7 (d1 = 45, blocks of n = 90) the launches cut out of a capture
(``kernels.graph_cut``) are K1w, K2c and K3w on their float64 plans, and
the tentative operator's inverses run on K5w: the widths and the dtype of
the benchmark's cell ``tg-k7-128-f64``.  On the card (marked ``cuda``;
``python -m pytest tests/test_torch_graphs_k7.py -m cuda``), at 16^2:

- one step from the state after a warm-up step, with the graphs and with
  the bare preconditioners: equal iteration counts and kernel launches,
  states within one ulp (bitwise expected), a replay in every solve;
- the fused sweep's graph replayed on fresh vectors: each pair the eager
  sweep's, and later replays leave an earlier result as it was.

On the CPU every case skips: CUDA graphs and the kernels have no CPU mode.
"""

import pytest
import torch

from incompressibleeulerhdg_tpu_torch import kernels
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg_tpu_torch.linalg import krylov
from incompressibleeulerhdg_tpu_torch.linalg import pressure as TPr
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg import tentative as TT
from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields
from incompressibleeulerhdg_tpu_torch.timesteppers import hdg_imex as TH

NX, DEGREE = 16, 7
WIDE = {"fact_apply_wide", "cross_pair_cluster", "patch_solve_wide", "gauss_jordan_wide"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _taylor_green(device):
    disc = HDGDiscretisation(unit_square_mesh(NX), DEGREE, dtype=torch.float64, device=device)
    stepper = TH.IncompressibleEulerHDGIMEXSSP2_332(disc, 0.5 / NX)
    problem = TaylorGreen(disc)
    return stepper, problem, stepper.initial_state(*problem.initial_condition())


def _within_one_ulp(a, b):
    """Every entry of ``a`` equals ``b``'s or its neighbour in ``b``'s dtype."""
    up = torch.nextafter(b, torch.full_like(b, float("inf")))
    down = torch.nextafter(b, torch.full_like(b, float("-inf")))
    return bool(((a == b) | (a == up) | (a == down)).all())


def _launches():
    torch.cuda.synchronize()
    return {n: c for n, c in kernels.LAUNCHES.items() if c}


def _replays_per_solve(monkeypatch):
    """Count the graph replays in every tentative and pressure solve."""
    replays, per_solve = [0], []
    real_call = krylov._Graph.__call__

    def call(self, v):
        replays[0] += 1
        return real_call(self, v)

    monkeypatch.setattr(krylov._Graph, "__call__", call)
    for module, name in ((TT, "gmres_right"), (TPr, "gmres")):
        solve = getattr(module, name)

        def counted(*args, _solve=solve, **kwargs):
            before = replays[0]
            out = _solve(*args, **kwargs)
            per_solve.append(replays[0] - before)
            return out

        monkeypatch.setattr(module, name, counted)
    return per_solve


@pytest.mark.cuda
def test_cuda_k7_f64_graphed_step_equals_the_eager_step(cuda, monkeypatch):
    """One float64 step at k = 7 with the graphs and with the bare
    preconditioners from the same state: equal counts of iterations and
    of kernel launches (the wide kernels among them), states within one
    ulp, a replay in every solve."""
    stepper, problem, state = _taylor_green(cuda)
    f = problem.f_rhs()
    state = stepper.step(*state, 0.0, f)[:3]
    with monkeypatch.context() as m:
        per_solve = _replays_per_solve(m)
        kernels.reset_launches()
        got = stepper.step(*state, stepper._dt, f)
        launched = _launches()
    assert len(per_solve) == 10 and min(per_solve) >= 1  # 4 tentative, 6 pressure
    assert WIDE <= set(launched)
    with monkeypatch.context() as m:
        m.setattr(TT, "graphed", lambda fn, graphs, key: fn)
        m.setattr(stepper, "_precond", stepper._vcycle)
        kernels.reset_launches()
        ref = stepper.step(*state, stepper._dt, f)
        assert launched == _launches()
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        assert all(_within_one_ulp(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_cuda_k7_f64_sweep_replays_equal_the_eager_sweep(cuda):
    """The fused sweep of a k = 7 float64 operator, warmed, captured and
    replayed: each replay's pair is the eager sweep's, and a result
    survives the replays after it."""
    stepper, problem, state = _taylor_green(cuda)
    geom = stepper.geom
    op = TP.build_tentative_operator(geom, star_fields(geom, state[0][0]), 0.5 / NX)
    nu = 2 * geom.d1
    fn = lambda v: tuple(t.reshape(-1) for t in TP._colored_apply_fused_bl(  # noqa: E731
        geom, op, v.reshape(nu, -1)))
    sweep = krylov.graphed(fn, op.graphs, "fused-sweep")
    gen = torch.Generator(device=cuda).manual_seed(11)
    ws = [torch.randn(nu * geom.n_cells, generator=gen, device=cuda, dtype=torch.float64)
          for _ in range(4)]
    pairs = [sweep(w) for w in ws]
    assert op.graphs
    for (z, az), w in zip(pairs, ws):
        z0, az0 = fn(w)
        assert _within_one_ulp(z, z0) and _within_one_ulp(az, az0)
