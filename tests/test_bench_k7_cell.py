"""The benchmark's cell ``tg-k7-128-f64`` on the CPU at reduced meshes.

The cell runs the HDG IMEX SSP2(3,3,2) scheme at k = 7 in float64 on the
128^2 unit square; here its configuration and traffic load through the
manifest, and the cell runs through ``benchmark/cell.py`` at 2^2 and 4^2
(the traffic's dt, k = 7, a warm-up step and one more), held to the plain
reference (``benchmark/reference.py``).  The same run in float32 reads a
velocity error many times larger (on the card the cell's float32 and
bfloat16 controls are ``benchmark/control.py``'s).  The program's span
``tentative_inverse`` gives one sample a tentative operator build under
``IEHDG_PHASE_TIMING=1`` and none without it; the cell's five new readers
read made-up records.
"""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import cell as C
from benchmark import manifest, run
from benchmark.trace import TraceSummary
from incompressibleeulerhdg_tpu_torch.linalg.preconditioners import width_kernels
from incompressibleeulerhdg_tpu_torch.linalg.smallinv import kernel_for
from incompressibleeulerhdg_tpu_torch.utils import logging as L

CELL = "tg-k7-128-f64"
KERNELS = ("patch_solve_wide", "cross_pair_cluster", "fact_apply_wide", "gauss_jordan_wide")
READERS = ("phase_ms.inverse",) + tuple(f"kernel_roofline.{k}" for k in KERNELS)
KAPPA = 0.5
# The float64 state against the closed form after two steps at the
# traffic's dt = 1/256: the time error of two steps is far below the space
# error of P_8 / P_7 on these meshes, which the readings show (velocity,
# pressure, trace: 1.36e-7, 1.39e-7, 1.39e-7 at 2^2; 2.6e-9, 3.3e-9, 3.6e-9
# at 4^2).  Each tolerance leaves about 7x room above them and lies below
# every float32 reading of the same run (5.4e-6 .. 2.3e-5 at both sizes).
TOL = {2: 1e-6, 4: 3e-8}


@pytest.fixture(scope="module")
def spec():
    return manifest.cell_spec(CELL)


_RUNS = {}


def _two_steps(spec, nx, dtype):
    """(errors, counts, steps taken) of the cell at ``nx``^2 in ``dtype``:
    the warm-up step and one more; memoised over the module."""
    key = (nx, dtype)
    if key not in _RUNS:
        config = dict(spec.config, dtype=dtype)
        traffic = dict(spec.traffic, nx=nx)
        cell = C.set_up(config, traffic, spec.problem, {"kappa": KAPPA}, torch.device("cpu"))
        _, counts, _ = C.run_steps(cell, 0.0, max_steps=1)
        t = cell.steps_done * cell.dt
        errs = spec.problem.errors(C.state_arrays(cell), config, traffic, {"kappa": KAPPA}, t)
        _RUNS[key] = (errs, counts, cell.steps_done)
    return _RUNS[key]


def test_the_cell_loads_through_the_manifest(spec):
    assert spec.name == CELL and spec.chips == 1
    assert spec.config["name"] == "hdg-imex-ssp2-k7-f64"
    assert (spec.config["degree"], spec.config["dtype"], spec.config["tf32"]) == (7, "float64",
                                                                                  False)
    assert spec.config["reduced"] == []
    assert spec.traffic["nx"] == 128 and spec.traffic["dt"] == 1 / 256
    assert spec.traffic["kappa"] == [0.4, 0.6]
    assert set(spec.limits) == {"velocity_l2", "pressure_l2", "trace_rms", "failed_steps"}
    assert spec.limits["failed_steps"] == 0
    assert [m["name"] for m in spec.end_to_end] == ["step_s", "setup_s"]
    assert tuple(m["name"] for m in spec.per_layer) == READERS
    assert all(m["moves"] == "step_s" and m["workloads"] == [CELL] for m in spec.per_layer)


def test_krylov_relres_max_is_the_programs_float64_stall_threshold(spec):
    """20 x the larger of the stepper's float64 GMRES tolerances, with no
    eps floor (``hdg_imex.py``'s stall warning)."""
    cell = C.build(spec.config, dict(spec.traffic, nx=2), spec.problem, torch.device("cpu"))
    st = cell.stepper
    assert st.disc.dtype == torch.float64
    assert spec.config["krylov_relres_max"] == 20.0 * max(st.rtol_pressure, st.rtol_tentative)


def test_the_readers_are_named_after_the_dispatched_kernels():
    """At d1 = 45 and n = 90 in float64 the dispatch launches the kernels
    the readers read: K1w, K2c, K3w and K5w (no blocked K5b)."""
    assert set(width_kernels(45, torch.float64)) | {kernel_for(90, torch.float64)} == \
        set(KERNELS)


@pytest.mark.parametrize("nx", [2, 4])
def test_float64_cell_is_held_to_the_reference(spec, nx):
    errs, counts, steps = _two_steps(spec, nx, "float64")
    assert steps == 2
    for name in ("velocity_l2", "pressure_l2", "trace_rms"):
        assert errs[name] < TOL[nx], (name, errs[name])
    assert max(float(c["max_relres"]) for c in counts) <= spec.config["krylov_relres_max"]
    assert run._failed(counts, spec.config["krylov_relres_max"]) == 0


@pytest.mark.parametrize("nx", [2, 4])
def test_float32_reads_a_larger_velocity_error(spec, nx):
    """The same run in float32, the precision below the configuration's:
    its velocity error is over 100x the float64 run's and past the
    tolerance, and its residuals pass the float64 stall threshold."""
    e64, _, _ = _two_steps(spec, nx, "float64")
    e32, counts, _ = _two_steps(spec, nx, "float32")
    assert e32["velocity_l2"] > 100 * e64["velocity_l2"]
    assert e32["velocity_l2"] > TOL[nx]
    assert run._failed(counts, spec.config["krylov_relres_max"]) > 0


@pytest.mark.parametrize("timing", [True, False])
def test_tentative_inverse_samples_each_build(spec, timing):
    """A k = 7 float64 step at 2^2: with ``IEHDG_PHASE_TIMING=1`` one
    ``tentative_inverse`` sample a tentative operator build (one a stage),
    inside the build; without it, none."""
    cell = C.set_up(spec.config, dict(spec.traffic, nx=2), spec.problem, {"kappa": KAPPA},
                    torch.device("cpu"))
    L.PerformanceLog.reset()
    try:
        C.run_steps(cell, 0.0, max_steps=1, phase_timing=timing)
        data = {k: list(v) for k, v in L.PerformanceLog.data.items()}
    finally:
        L.PerformanceLog.reset()
    if not timing:
        assert data == {}
        return
    builds = cell.stepper.nstages - 1
    assert len(data["tentative_inverse"]) == len(data["tentative_build"]) == builds
    assert all(0.0 <= a <= b for a, b in zip(data["tentative_inverse"],
                                             data["tentative_build"]))
    got = manifest.load_reader("phase_ms.inverse").read(
        SimpleNamespace(phases=data, phase_steps=1))
    assert got == pytest.approx(1e3 * sum(data["tentative_inverse"]))


def test_traced_cpu_run_reports_the_span_and_no_kernel_share(spec, monkeypatch):
    """``run.run_cell`` with ``--trace 1`` at 2^2 on the CPU: the span's
    reader reads, the kernel shares (no device trace) are left out."""
    monkeypatch.setattr(run, "TRACE_STEPS", 1)
    tiny = manifest.cell_spec(CELL)
    tiny.traffic = dict(tiny.traffic, nx=2)
    result, checks, _ = run.run_cell(tiny, 2 ** 31 + 17, 0.0, True, torch.device("cpu"))
    assert result["metrics"]["phase_ms.inverse"]["value"] > 0.0
    assert result["metrics"]["phase_ms.inverse"]["unit"] == "ms/step"
    assert not any(k.startswith("kernel_roofline.") for k in result["metrics"])
    assert checks["max_relres"]["limit"] == spec.config["krylov_relres_max"]
    assert checks["failed_steps"]["value"] == 0


# ----------------------------------------------------------------------
# the readers on made-up records
# ----------------------------------------------------------------------

# launches as benchmark/probe.py records them, with (bytes, operations) by
# benchmark/roofline.py's formulas, float64, worked out by hand
LAUNCHES = {
    # K3w, one colour of 16,256 facets, d1 = 45, nu = 90
    "patch_solve_wide": (dict(d1=45, m=16256, nseg=1, dtype="float64", factors="float64"),
                         8 * 2 * 90 * 90 * 16256 + 8 * (2 * 45 * 45 * 16256 + 2 * 90 * 90
                                                        + 4 * 90 * 16256),
                         2 * (5 * 90 * 90 + 4 * 45 * 45) * 16256),
    # K2c, full field of 49,408 facets in 4 segments
    "cross_pair_cluster": (dict(d1=45, m=49408, nseg=4, dtype="float64", factors=None),
                           8 * (2 * 45 * 45 * 49408 + 2 * 4 * 90 * 90 + 4 * 90 * 49408),
                           4 * (2 * 45 * 45 + 90 * 90) * 49408),
    # K1w, 32,768 cells in 2 halves
    "fact_apply_wide": (dict(d1=45, m=32768, nseg=2, dtype="float64", factors=None),
                        8 * (45 * 45 * 32768 + 2 * 90 * 90 + 2 * 90 * 32768),
                        2 * (2 * 45 * 45 + 90 * 90) * 32768),
    # K5w, 32,768 blocks of n = 90
    "gauss_jordan_wide": (dict(n=90, m=32768, dtype="float64", factors=None),
                          8 * 2 * 90 * 90 * 32768, 2 * 90 ** 3 * 32768),
}
HBM, PEAK = 3.35e12, 67e12


def _bound(kernel):
    _, nbytes, flops = LAUNCHES[kernel]
    return max(nbytes / HBM, flops / PEAK)


def _rec(launches, launch_s):
    trace = TraceSummary(window_s=1.0, busy_s=0.5, launch_s=launch_s)
    return SimpleNamespace(trace=trace, launches=launches, phases={}, phase_steps=0,
                           counts=[], spans={}, trace_steps=1)


def _all_kernels(times):
    """A record with one launch of each kernel (index order: KERNELS) and
    its device seconds from ``times``, plus an unknown launch."""
    launches = [dict(LAUNCHES[k][0], name=k) for k in KERNELS] + [{"name": "other"}]
    return _rec(launches, {i: times[k] for i, k in enumerate(KERNELS)})


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_share_is_its_bound_over_its_own_time(kernel):
    """Each reader takes its own kernel's launches only: 40% where its
    launch took 2.5 bounds, whatever the other kernels took."""
    times = {k: 10.0 * _bound(k) for k in KERNELS}
    times[kernel] = 2.5 * _bound(kernel)
    got = manifest.load_reader(f"kernel_roofline.{kernel}").read(_all_kernels(times))
    assert got == pytest.approx(40.0)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_share_sums_over_its_launches(kernel):
    """Two launches of the kernel at 1 and 3 bounds: 50%; one recorded
    with no device time leaves the share as it was."""
    args = dict(LAUNCHES[kernel][0], name=kernel)
    b = _bound(kernel)
    rec = _rec([args, dict(args), dict(args)], {0: b, 1: 3 * b, 2: 0.0})
    got = manifest.load_reader(f"kernel_roofline.{kernel}").read(rec)
    assert got == pytest.approx(50.0)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_share_is_none_without_its_launches(kernel):
    reader = manifest.load_reader(f"kernel_roofline.{kernel}")
    others = [k for k in KERNELS if k != kernel]
    launches = [dict(LAUNCHES[k][0], name=k) for k in others]
    assert reader.read(_rec(launches, {i: 1e-3 for i in range(len(others))})) is None
    # the kernel launched, but no launch of it has device time
    args = dict(LAUNCHES[kernel][0], name=kernel)
    assert reader.read(_rec([args], {})) is None
    assert reader.read(_rec([args], {0: 0.0})) is None
    # no device trace at all (a CPU run, or a profiler session that saw none)
    assert reader.read(SimpleNamespace(trace=None, launches=[args])) is None


def test_kernel_share_is_none_for_a_shape_the_table_does_not_know():
    rec = _rec([{"name": "gauss_jordan_wide"}], {0: 1e-3})
    assert manifest.load_reader("kernel_roofline.gauss_jordan_wide").read(rec) is None


def test_phase_ms_inverse_divides_by_the_phase_timed_steps():
    reader = manifest.load_reader("phase_ms.inverse")
    rec = SimpleNamespace(phases={"tentative_inverse": [0.25, 0.125, 0.125, 0.5],
                                  "star+build": [2.0]}, phase_steps=2)
    assert reader.read(rec) == pytest.approx(500.0)


@pytest.mark.parametrize("phases,steps", [
    ({}, 3),
    ({"star+build": [1.0], "tentative_build": [0.5]}, 3),  # a program without the span
    ({"tentative_inverse": [1.0]}, 0),
])
def test_phase_ms_inverse_is_none_without_samples(phases, steps):
    reader = manifest.load_reader("phase_ms.inverse")
    assert reader.read(SimpleNamespace(phases=phases, phase_steps=steps)) is None


def test_the_worked_bounds_match_the_roofline_table():
    """The hand-worked bounds above agree with ``benchmark/roofline.py``,
    so each reader's share is that table's arithmetic."""
    from benchmark.roofline import bound_s, work

    for kernel, (args, nbytes, flops) in LAUNCHES.items():
        got = work(kernel, args["dtype"], d1=args.get("d1"), m=args["m"],
                   nseg=args.get("nseg", 1), n=args.get("n"), factors=args.get("factors"))
        assert got == (nbytes, flops), kernel
        assert math.isclose(bound_s("float64", nbytes, flops)[0], _bound(kernel))
