"""The spans of the port's HDG IMEX step (utils/logging.py) on the CPU.

Off, a step leaves ``PerformanceLog`` empty and computes what a traced step
computes; under ``IEHDG_PHASE_TIMING=1`` each solve and each blocking read
of the device has its samples; under torch.profiler the chrome trace holds
every span as ``iehdg.<label>``, nested under ``iehdg.step``.
"""

import json

import pytest
import torch

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg_tpu_torch.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)
from incompressibleeulerhdg_tpu_torch.utils import logging as L

PHASES = {"forcing", "star+build", "residual", "sweep", "final", "reconstruct"}
SPANS = {"step", "bdm_projection", "tentative_build", "tentative_inverse", "solve.tentative",
         "solve.pressure", "krylov.precond", "krylov.matvec", "krylov.orthogonalise", "host.read"}
# the tensor methods that hand a value to the host: a blocking read on a card
READS = ("cpu", "item", "tolist", "__float__", "__int__", "__index__", "__bool__")


def _stepper(nx=4, degree=1):
    disc = HDGDiscretisation(unit_square_mesh(nx), degree, device="cpu")
    stepper, problem = IncompressibleEulerHDGIMEXSSP2_332(disc, 0.1), TaylorGreen(disc)
    return stepper, stepper.initial_state(*problem.initial_condition()), problem.f_rhs()


def _step(stepper, state, f_rhs):
    return stepper.step(*state, 0.0, f_rhs)


def _same(a, b):
    return a[3] == b[3] and all(torch.equal(x, y) for x, y in
                                zip(a[0] + a[1] + a[2], b[0] + b[1] + b[2]))


def test_off_the_log_stays_empty_and_the_step_matches_a_traced_one(monkeypatch):
    stepper, state, f_rhs = _stepper()
    monkeypatch.delenv("IEHDG_PHASE_TIMING", raising=False)
    L.PerformanceLog.reset()
    off = _step(stepper, state, f_rhs)
    assert not L.PerformanceLog.data
    monkeypatch.setenv("IEHDG_PHASE_TIMING", "1")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _step(stepper, state, f_rhs)
    assert L.PerformanceLog.data["host.read"]
    assert _same(off, traced)
    L.PerformanceLog.reset()


def test_off_a_span_is_one_shared_object_and_the_flag_clears_after_a_step(monkeypatch):
    assert L.span("a") is L.span("b")
    stepper, state, f_rhs = _stepper(2)
    monkeypatch.setenv("IEHDG_PHASE_TIMING", "1")
    _step(stepper, state, f_rhs)
    assert L._mode == 0 and L.span("a") is L.span("b")
    L.PerformanceLog.reset()


@pytest.mark.parametrize("degree", [1, 2])
def test_phase_timing_samples_each_solve(degree, monkeypatch):
    stepper, state, f_rhs = _stepper(4, degree)
    monkeypatch.setenv("IEHDG_PHASE_TIMING", "1")
    L.PerformanceLog.reset()
    _, _, _, counts = _step(stepper, state, f_rhs)
    data = L.PerformanceLog.data
    n = stepper.n_richardson * (stepper.nstages - 1)
    assert set(data) == PHASES | SPANS
    assert len(data["solve.tentative"]) == n
    assert len(data["solve.pressure"]) == n + 2
    assert len(data["sweep"]) == n and len(data["step"]) == 1
    assert len(data["bdm_projection"]) == len(data["tentative_build"]) == stepper.nstages - 1
    # every Arnoldi step reads one Hessenberg column, besides the norms
    arnoldi = sum(counts["tentative"]) + sum(counts["pressure"]) + \
        counts["final_pressure"] + counts["reconstruction"]
    assert len(data["krylov.orthogonalise"]) == arnoldi < len(data["host.read"])
    solves = sum(data["solve.tentative"]) + sum(data["solve.pressure"])
    assert solves <= sum(data["sweep"]) + sum(data["final"]) + sum(data["reconstruct"])
    assert sum(data["host.read"]) <= solves
    L.PerformanceLog.reset()


@pytest.mark.parametrize("degree", [1, 2])
def test_host_read_spans_every_read(degree, monkeypatch):
    """A spy on every tensor method that hands a value to the host counts as
    many reads in one step as ``host.read`` has samples, each inside one."""
    stepper, state, f_rhs = _stepper(4, degree)
    monkeypatch.setenv("IEHDG_PHASE_TIMING", "1")
    L.PerformanceLog.reset()
    reads = []

    def spy(name):
        method = getattr(torch.Tensor, name)

        def read(self, *args, **kwargs):
            reads.append(len(L.PerformanceLog.data["host.read"]))
            return method(self, *args, **kwargs)

        return read

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    _step(stepper, state, f_rhs)
    monkeypatch.undo()
    n = len(L.PerformanceLog.data["host.read"])
    assert n > 0 and len(reads) == n
    # the k-th read happens while the k-th span is open: k samples before it
    assert reads == list(range(n))
    L.PerformanceLog.reset()


def test_profiler_trace_nests_the_spans_under_the_step(tmp_path, monkeypatch):
    stepper, state, f_rhs = _stepper(2)
    monkeypatch.delenv("IEHDG_PHASE_TIMING", raising=False)
    L.PerformanceLog.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, _, _, counts = _step(stepper, state, f_rhs)
    assert not L.PerformanceLog.data  # the profiler alone records no host seconds
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(L.SPAN_PREFIX)]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len("iehdg."):])
                    for e in events), key=lambda s: (s[0], -s[1]))
    assert {s[2] for s in spans} == PHASES | SPANS
    assert len({e["tid"] for e in events}) == 1
    (step,) = [s for s in spans if s[2] == "step"]
    assert spans[0] == step
    # properly nested: each span lies inside every span still open at its start
    parent_of, stack = {}, []
    for a, b, name in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        assert all(b <= s[1] for s in stack), name
        parent_of.setdefault(name, set()).add(stack[-1][2] if stack else None)
        stack.append((a, b, name))
    assert parent_of["step"] == {None}
    assert parent_of["forcing"] == parent_of["sweep"] == parent_of["final"] == {"step"}
    assert parent_of["bdm_projection"] == parent_of["tentative_build"] == {"star+build"}
    assert parent_of["tentative_inverse"] == {"tentative_build"}
    assert parent_of["solve.tentative"] == {"sweep"}
    assert parent_of["solve.pressure"] == {"sweep", "final", "reconstruct"}
    assert parent_of["krylov.orthogonalise"] <= {"solve.tentative", "solve.pressure"}
    assert parent_of["host.read"] <= {"solve.tentative", "solve.pressure"}
    assert sum(s[2] == "solve.tentative" for s in spans) == len(counts["tentative"])
