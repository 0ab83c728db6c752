"""CUDA graphs of the Krylov loops' preconditioners (``krylov.graphed``)
and the cuts around the hand-written kernels' launches
(``kernels.graph_cut``).

On the CPU, where no graph is captured:

- ``graphed`` calls its function unchanged for a CPU tensor (no span
  opened, nothing captured or warmed); the tentative solve wraps its
  sweep only without a communicator, and a distributed stepper's
  preconditioner is the bare V-cycle;
- on one card it warms up once a key and layout in the process, captures
  on the next call and replays from then on, a capture and a replay each
  under their spans (the capture stood in by a fake);
- a capture cuts its graph around a marked launch wrapper: the wrapper's
  body does not run there, its vectors are made contiguous and its
  outputs allocated; a replay calls the wrapper by its name in its module
  (a wrapper set there after the capture is the one called), which writes
  into those outputs, and a wrapper that writes elsewhere is refused;
- the operator's ``graphs`` is no dataclass field, so the operator's
  tables copy field by field as before;
- an SSP2(3,3,2) step through the graphed preconditioners equals the step
  through the bare ones bit for bit, and with ``IEHDG_PHASE_TIMING=1``
  records no ``krylov.capture`` or ``krylov.replay``.

On the card (marked ``cuda``; ``python -m pytest tests/test_torch_graphs.py
-m cuda``): one step at 64^2, k = 2 and at 32^2, k = 4 in float32 with the
graphs and with the bare preconditioners from the same state: equal
iteration counts, equal kernel launch counts, states within one ulp
(bitwise expected), at least one replay in every solve; returned results
unchanged by later calls; a V-cycle's and a sweep's captures in one memory
pool, replayed in turn, each result the eager application's; and forty
steps' captures at 64^2 held in the memory of the first few.
"""

import dataclasses
import sys
from types import SimpleNamespace

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
from incompressibleeulerhdg_tpu_torch.utils import logging as L


def _bare(fn, graphs, key):
    return fn


@pytest.fixture
def spans_on(monkeypatch):
    """Every span records its host seconds into PerformanceLog (a step sets
    the flag from ``IEHDG_PHASE_TIMING``)."""
    monkeypatch.setattr(L, "_mode", L.TIME)
    monkeypatch.setenv("IEHDG_PHASE_TIMING", "1")
    L.PerformanceLog.reset()
    yield L.PerformanceLog.data
    L.PerformanceLog.reset()


def test_graphed_calls_fn_unchanged_on_the_cpu(spans_on):
    """A CPU tensor: ``fn`` itself runs, nothing is warmed or captured."""
    out = object()
    seen = []

    def fn(v):
        seen.append(v)
        return out

    graphs, warm = {}, set(krylov._WARM)
    v = torch.ones(4)
    g = krylov.graphed(fn, graphs, "k")
    assert all(g(v) is out for _ in range(3))
    assert seen == [v] * 3 and graphs == {} and krylov._WARM == warm
    assert not {"krylov.capture", "krylov.replay"} & set(spans_on)


@pytest.mark.parametrize("comm", [None, "a communicator"])
def test_tentative_solve_graphs_only_on_one_card(monkeypatch, comm):
    """The fused sweep is handed to ``graphed`` without a communicator
    only: a slab or partition rank keeps its eager sweep."""
    wrapped = []
    monkeypatch.setattr(TT, "graphed", lambda fn, graphs, key: wrapped.append(key) or fn)
    monkeypatch.setattr(TT, "dist_axis", lambda geom: comm)
    monkeypatch.setattr(TT, "gmres_right", lambda M, A, b, **kw: (b, 0, 0.0))
    geom = SimpleNamespace(shift=(), part=None)
    op = SimpleNamespace(graphs={}, Sown=None, Dinv0=torch.zeros(1))
    TT.tentative_solve(geom, op, torch.zeros(2, 3, 4))
    assert len(wrapped) == (1 if comm is None else 0)


def test_distributed_stepper_keeps_the_bare_vcycle():
    """One card replays the V-cycle's graphs; a rank of a distributed run
    (``dec`` set by ``distribute``) runs the bare V-cycle, whose sums run
    over the ranks."""
    stepper, _, _ = _taylor_green(4, 1, torch.float64, "cpu")
    stepper._graphed_vcycle = lambda v: ("graphed", v)
    stepper._vcycle = lambda v: ("bare", v)
    assert stepper._precond(1) == ("graphed", 1)
    stepper.dec = object()
    assert stepper._precond(1) == ("bare", 1)


class _FakeGraph:
    """Stands in for ``krylov._Graph`` on the CPU: records its capture and
    replays, replays by calling the function."""

    made = []

    def __init__(self, fn, v):
        self.fn, self.calls = fn, 0
        _FakeGraph.made.append(self)

    def __call__(self, v):
        self.calls += 1
        return self.fn(v)


def test_graphed_warms_captures_then_replays(monkeypatch, spans_on):
    """One card: the first call of a key and layout runs eagerly (once in
    the process, whichever owner), the next captures and replays, later
    calls replay; another key warms up again."""
    monkeypatch.setattr(krylov, "_Graph", _FakeGraph)
    monkeypatch.setattr(krylov, "_WARM", set())
    _FakeGraph.made = []
    v = SimpleNamespace(is_cuda=True, shape=(6,), dtype=torch.float32, device="card")
    calls = []
    fn = lambda x: calls.append(x) or len(calls)
    graphs = {}
    g = krylov.graphed(fn, graphs, "k")
    assert [g(v) for _ in range(4)] == [1, 2, 3, 4]
    assert len(_FakeGraph.made) == 1 and _FakeGraph.made[0].calls == 3
    assert list(graphs) == [("k", (6,), torch.float32, "card")]
    assert len(spans_on["krylov.capture"]) == 1 and len(spans_on["krylov.replay"]) == 3
    # a second owner of the same key and layout captures at once
    other = {}
    krylov.graphed(fn, other, "k")(v)
    assert len(_FakeGraph.made) == 2 and len(other) == 1
    # another key warms up first
    krylov.graphed(fn, other, "k2")(v)
    assert len(_FakeGraph.made) == 2 and len(other) == 1


# a launch wrapper of this module, as preconditioners.py marks its three
@kernels.graph_cut(("x", "y"), 2)
def _launch_pair(x, y, scale=2.0):
    a, b = kernels.launch_outputs(x, 2)
    torch.mul(x, scale, out=a)
    torch.add(x, y, out=b)
    return a, b


class _FakeCUDAGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: records its
    capture's begin and end and its replays."""

    log = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        _FakeCUDAGraph.log.append("begin")

    def capture_end(self):
        _FakeCUDAGraph.log.append("end")

    def replay(self):
        _FakeCUDAGraph.log.append("replay")


def _capture(monkeypatch, fn, v):
    """A ``krylov._Graph`` of ``fn`` built as its constructor builds it,
    on fake CUDA graphs."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    _FakeCUDAGraph.log = []
    g = object.__new__(krylov._Graph)
    g.device, g.inp, g.pool, g.parts = v.device, v.clone(), None, []
    kernels.CAPTURE.graph = g
    g._begin()
    try:
        g.out = fn(g.inp)
    finally:
        kernels.CAPTURE.graph = None
        g.parts[-1].capture_end()
    return g


def test_capture_cuts_around_a_launch_wrapper(monkeypatch):
    """Inside a capture the wrapper's body does not run: the call ends the
    graph, its vectors become contiguous, its outputs are new tensors
    shaped like the first vector, and the next graph begins.  A replay
    runs the graphs and calls the wrapper set in the module at that time,
    with the capture's arguments, into the capture's outputs; outside a
    capture the wrapper is a plain call."""
    x = torch.arange(6.0).reshape(3, 2).t()  # not contiguous
    y = torch.ones(2, 3)

    def fn(v):
        a, b = _launch_pair(v * 1.0, y)
        return a + b

    g = _capture(monkeypatch, fn, x)
    assert _FakeCUDAGraph.log == ["begin", "end", "begin", "end"]
    first, call, last = g.parts
    module, name, args, kwargs, outs = call
    assert module is sys.modules[__name__] and name == "_launch_pair"
    assert args[0].is_contiguous() and args[1] is y and kwargs == {}
    assert len(outs) == 2 and all(o.shape == (2, 3) and o.is_contiguous() for o in outs)

    seen = []
    real = _launch_pair

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(sys.modules[__name__], "_launch_pair", spy)
    args[0].copy_(x)  # what the first graph computes at a replay
    g(x)
    assert _FakeCUDAGraph.log[4:] == ["replay", "replay"]
    assert seen == [args]
    assert torch.equal(outs[0], 2 * x) and torch.equal(outs[1], x + y)
    assert kernels.CAPTURE.outs is None
    a, b = real(x, y)  # outside a capture: new outputs every call
    assert a is not outs[0] and torch.equal(a, 2 * x) and torch.equal(b, x + y)


def test_replay_refuses_a_wrapper_that_writes_elsewhere(monkeypatch):
    """A wrapper that ignores the capture's outputs would leave the next
    graph reading stale values: the replay raises."""
    g = _capture(monkeypatch, lambda v: _launch_pair(v, v)[0] + 1.0, torch.ones(4))
    monkeypatch.setattr(sys.modules[__name__], "_launch_pair",
                        lambda x, y, scale=2.0: (x * scale, x + y))
    with pytest.raises(RuntimeError, match="outside the outputs of its capture"):
        g(torch.ones(4))
    assert kernels.CAPTURE.outs is None


def test_operator_graphs_is_no_field():
    """``TentativeOperator.graphs``: one dict per operator, outside the
    dataclass fields that copies of the tables walk."""
    t = torch.zeros(1, 1, 1)
    a, b = TP.TentativeOperator(Dinv=t, Sinv=t, Dinv0=t), TP.TentativeOperator(t, t, t)
    assert a.graphs == {} and a.graphs is not b.graphs
    assert "graphs" not in {f.name for f in dataclasses.fields(a)}


def _taylor_green(nx, k, dtype, device):
    disc = HDGDiscretisation(unit_square_mesh(nx), k, dtype=dtype, device=device)
    stepper = TH.IncompressibleEulerHDGIMEXSSP2_332(disc, 0.5 / nx)
    problem = TaylorGreen(disc)
    return stepper, problem, stepper.initial_state(*problem.initial_condition())


def test_cpu_step_equals_the_bare_step(monkeypatch, spans_on):
    """The CPU keeps the eager path: the graphed step's state and counts
    equal those of the step through the bare preconditioners bit for bit,
    and no capture or replay span opens."""
    stepper, problem, state = _taylor_green(4, 1, torch.float64, "cpu")
    got = stepper.step(*state, 0.0, problem.f_rhs())
    assert not {"krylov.capture", "krylov.replay"} & set(spans_on)
    assert spans_on["krylov.precond"]
    monkeypatch.setattr(TT, "graphed", _bare)
    monkeypatch.setattr(stepper, "_precond", stepper._vcycle)
    ref = stepper.step(*state, 0.0, problem.f_rhs())
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert stepper._graphs == {}


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (CUDA graphs and the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _within_one_ulp(a, b):
    """Every entry of ``a`` equals ``b``'s or its neighbour in ``b``'s dtype."""
    up = torch.nextafter(b, torch.full_like(b, float("inf")))
    down = torch.nextafter(b, torch.full_like(b, float("-inf")))
    return bool(((a == b) | (a == up) | (a == down)).all())


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


def _launches():
    torch.cuda.synchronize()
    return {n: c for n, c in kernels.LAUNCHES.items() if c}


@pytest.mark.cuda
@pytest.mark.parametrize("nx, k", [(64, 2), (32, 4)])
def test_cuda_graphed_step_equals_the_eager_step(cuda, monkeypatch, nx, k):
    """One float32 step from the state after a warm-up step, with the
    graphs and with the bare preconditioners: equal counts of iterations
    and of kernel launches, states within one ulp, a replay in every
    solve."""
    stepper, problem, state = _taylor_green(nx, k, torch.float32, cuda)
    f = problem.f_rhs()
    state = stepper.step(*state, 0.0, f)[:3]
    with monkeypatch.context() as m:
        per_solve = _replays_per_solve(m)
        kernels.reset_launches()
        got = stepper.step(*state, stepper._dt, f)
        launched = _launches()
    assert len(per_solve) == 10 and min(per_solve) >= 1  # 4 tentative, 6 pressure
    with monkeypatch.context() as m:
        m.setattr(TT, "graphed", _bare)
        m.setattr(stepper, "_precond", stepper._vcycle)
        kernels.reset_launches()
        ref = stepper.step(*state, stepper._dt, f)
        assert launched == _launches() and launched
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        assert all(_within_one_ulp(x, y) for x, y in zip(a, b))


def _graphed_sweep(geom, op):
    nu = 2 * geom.d1
    fn = lambda v: tuple(t.reshape(-1) for t in TP._colored_apply_fused_bl(
        geom, op, v.reshape(nu, -1)))
    return fn, krylov.graphed(fn, op.graphs, "fused-sweep")


@pytest.mark.cuda
def test_cuda_graphed_results_survive_later_calls(cuda):
    """A replayed result is a copy: later calls leave it as it was, and it
    equals the eager application; the fused sweep's pair too."""
    stepper, problem, state = _taylor_green(32, 2, torch.float32, cuda)
    geom = stepper.geom
    gen = torch.Generator(device=cuda).manual_seed(5)
    vs = [torch.randn(stepper._cs.nt * geom.n_facets, generator=gen, device=cuda)
          for _ in range(4)]
    out = [stepper._precond(v) for v in vs]
    for o, v in zip(out, vs):
        assert _within_one_ulp(o, stepper._vcycle(v))

    op = TP.build_tentative_operator(geom, star_fields(geom, state[0][0]), 0.5 / 32)
    fn, g = _graphed_sweep(geom, op)
    ws = [torch.randn(2 * geom.d1 * geom.n_cells, generator=gen, device=cuda)
          for _ in range(4)]
    pairs = [g(w) for w in ws]
    assert op.graphs
    for (z, az), w in zip(pairs, ws):
        z0, az0 = fn(w)
        assert _within_one_ulp(z, z0) and _within_one_ulp(az, az0)


@pytest.mark.cuda
def test_cuda_two_owners_replay_in_turn(cuda):
    """The V-cycle's capture and a sweep's capture share one memory pool
    and are replayed in turn: every result is the eager application's,
    and the sweep's kernel launches are counted at each replay."""
    stepper, problem, state = _taylor_green(32, 2, torch.float32, cuda)
    geom = stepper.geom
    op = TP.build_tentative_operator(geom, star_fields(geom, state[0][0]), 0.5 / 32)
    fn, sweep = _graphed_sweep(geom, op)
    gen = torch.Generator(device=cuda).manual_seed(7)
    nt = stepper._cs.nt * geom.n_facets
    nz = 2 * geom.d1 * geom.n_cells
    for _ in range(2):  # warm up, then capture
        stepper._precond(torch.randn(nt, generator=gen, device=cuda))
        sweep(torch.randn(nz, generator=gen, device=cuda))
    (vg,), (sg,) = stepper._graphs.values(), op.graphs.values()
    assert vg.pool == sg.pool
    kernels.reset_launches()
    fn(torch.randn(nz, generator=gen, device=cuda))
    per_sweep = _launches()
    for i in range(3):
        v = torch.randn(nt, generator=gen, device=cuda)
        w = torch.randn(nz, generator=gen, device=cuda)
        kernels.reset_launches()
        p, (z, az) = stepper._precond(v), sweep(w)
        assert _launches() == per_sweep
        z0, az0 = fn(w)
        assert _within_one_ulp(p, stepper._vcycle(v))
        assert _within_one_ulp(z, z0) and _within_one_ulp(az, az0)


@pytest.mark.cuda
def test_cuda_captures_reuse_their_memory(cuda):
    """Two sweep captures a step, each dropped with its stage's operator:
    forty steps at 64^2 reserve no more than 32 MiB beyond the fifth (each
    capture takes the pool of the live V-cycle capture, where a dropped
    capture's memory serves the next; a pool of its own each would keep
    every dropped capture's memory reserved)."""
    stepper, problem, state = _taylor_green(64, 2, torch.float32, cuda)
    f = problem.f_rhs()
    reserved = []
    for i in range(40):
        state = stepper.step(*state, i * stepper._dt, f)[:3]
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert reserved[-1] <= reserved[4] + 32 * 2 ** 20, [r / 2 ** 20 for r in reserved]
