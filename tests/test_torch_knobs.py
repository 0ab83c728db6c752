"""The JAX package's ``IEHDG_*`` knobs in the PyTorch port, against the JAX
package on the CPU in float64.

- ``tentative_solve`` with two sweeps, a forward-only sweep, the
  left-preconditioned composition (``IEHDG_TENT_FUSED=0``), the fused
  sweep's free ``A z`` (``IEHDG_TENT_FUSED=2``), the additive patch
  preconditioner (``colored=False``), a short restart, and dense tables on
  a structured mesh (``IEHDG_FACT=0``), on the 8^2 square and the 8^2
  periodic square, k=1: the operators' tables at 1e-12 relative, equal
  iteration counts and solutions within 1e-10;
- ``tentative_patch_apply`` and ``tentative_colored_apply`` on factored and
  dense tables;
- ``build_tentative_operator(reuse_factors=...)`` on factored and dense
  tables: fresh matvec tables, the earlier build's factors;
- the stepper reads ``IEHDG_TENT_RESTART/SWEEPS/SYM`` as the JAX stepper
  does;
- a CLI run under ARS2(2,3,2) with ``IEHDG_LAG_PC=1`` against the JAX
  package's composite step: equal counts step by step, the state within
  1e-10, and half the Gauss-Jordan inversions;
- ``IEHDG_PHASE_TIMING=1``: the JAX labels, as often as the JAX composite
  step records them, and besides them exactly the port's own spans;
- a CLI run with ``IEHDG_TENT_FUSED=2`` against the JAX driver and the JAX
  step: equal counts step by step, the state within 1e-10;
- over ranks, as the JAX package's slab and GSPMD steps: the slab
  decomposition (2 ranks, 8^2) and the cell/facet partition (3 ranks, the
  periodic 8^2) with the sweep, symmetry, fused and factored knobs set
  take the single rank's counts and state under the same knobs (within
  1e-10 in float64; in float32, under ``IEHDG_PC_BF16=1`` on the slab and
  on the partition of the refinement-2 disk, within 1e-5, readings of
  2.1e-6 (slab) and 1.0e-6 (partition) and below).  On the partition ``IEHDG_TENT_FUSED=2``
  keeps the route's exact ``A z`` (linalg/tentative.py): its run equals
  the partition's run under ``IEHDG_TENT_FUSED=1`` exactly.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.cli import driver as JH_driver
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.linalg import tentative as JT
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops.forms import star_fields as j_star_fields
from incompressibleeulerhdg_tpu.timesteppers import hdg_imex as JH
from incompressibleeulerhdg_tpu.utils.logging import PerformanceLog as JLog

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg import tentative as TT
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields as t_star_fields
from incompressibleeulerhdg_tpu_torch.timesteppers import hdg_imex as TH
from incompressibleeulerhdg_tpu_torch.utils.diagnostics import averaged_counts
from incompressibleeulerhdg_tpu_torch.utils.logging import PerformanceLog as TLog
from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks

import partition_jobs
import slab_jobs

torch.set_num_threads(1)

C_STAGE = 0.025
OP_FIELDS = ("D", "Bx", "Cx", "Dinv", "Sinv", "Dinv0", "Sown", "Pcell", "Ks01", "Ks10",
             "Bp", "Cp")
MESHES = {"square": "unit_square_mesh", "periodic": "periodic_square_mesh"}


def close(got, ref, rtol):
    got = np.asarray(got.detach()) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


def same_tables(top, jop):
    """Every table of the port's operator equals the JAX package's, and
    the two hold the same set of tables."""
    for name in OP_FIELDS:
        a, b = getattr(top, name), getattr(jop, name)
        assert (a is None) == (b is None), name
        if a is not None:
            close(a, b, 1e-12)


class Mesh:
    """One 8^2 mesh, k=1, built by both packages, with seeded fields."""

    def __init__(self, kind):
        name = MESHES[kind]
        self.jd = JDisc(getattr(JM, name)(8), 1)
        self.td = TDisc(getattr(TM, name)(8), 1, device="cpu")
        self.jg, self.tg = self.jd.geom, self.td.geom
        rng = np.random.default_rng(8 if kind == "square" else 9)
        shape = (2, self.jg.d1, self.jg.n_cells)
        self.Q, self.Q2, self.u = (rng.standard_normal(shape) for _ in range(3))

    def ops(self, Q, **kw):
        """(JAX, port) operators of the stage built on star(Q)."""
        jop = JP.build_tentative_operator(self.jg, j_star_fields(self.jg, jnp.asarray(Q)),
                                          C_STAGE, **{k: v[0] for k, v in kw.items()})
        top = TP.build_tentative_operator(self.tg, t_star_fields(self.tg, torch.as_tensor(Q)),
                                          C_STAGE, **{k: v[1] for k, v in kw.items()})
        return jop, top


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh(request):
    return Mesh(request.param)


@pytest.mark.parametrize("fact", ["1", "0"], ids=["factored", "dense"])
def test_operator_tables(mesh, monkeypatch, fact):
    """``IEHDG_FACT`` chooses the tables of a structured mesh in both
    packages: factored by default, dense with ``IEHDG_FACT=0``."""
    monkeypatch.setenv("IEHDG_FACT", fact)
    jop, top = mesh.ops(mesh.Q)
    assert (top.Sown is None) == (fact == "0") and top.Dinv0.shape[2] == mesh.tg.n_facets
    same_tables(top, jop)


SOLVES = {
    "sweeps2": dict(sweeps=2),
    "forward": dict(symmetric=False),
    "forward_sweeps2": dict(symmetric=False, sweeps=2),
    "left": dict(fused=0),
    "left_sweeps2_forward": dict(fused=0, sweeps=2, symmetric=False),
    "fused2": dict(fused=2),
    "fused2_sweeps2_forward": dict(fused=2, sweeps=2, symmetric=False),
    "additive": dict(colored=False),
    "restart4": dict(restart=4),
}


@pytest.mark.parametrize("fact", ["1", "0"], ids=["factored", "dense"])
@pytest.mark.parametrize("knob", sorted(SOLVES))
def test_tentative_solve_knobs(mesh, monkeypatch, knob, fact):
    monkeypatch.setenv("IEHDG_FACT", fact)
    jop, top = mesh.ops(mesh.Q)
    kw = dict(SOLVES[knob])
    restart = kw.pop("restart", 28)
    ju, jit, _ = JT.tentative_solve(mesh.jg, None, jnp.asarray(mesh.u), C_STAGE, op=jop,
                                    restart=restart, **kw)
    tu, tit, trel = TT.tentative_solve(mesh.tg, top, torch.as_tensor(mesh.u), restart=restart,
                                       **kw)
    assert tit == int(jit) and tit > 0 and trel < 1e-9
    close(tu, ju, 1e-10)


def test_fused_env_selects_the_composition(mesh, monkeypatch):
    """``IEHDG_TENT_FUSED=0`` and ``=2`` in the environment are ``fused=0``
    and ``fused=2``, each with the JAX package's count under the same
    environment."""
    jop, top = mesh.ops(mesh.Q)
    u = torch.as_tensor(mesh.u)
    for mode in ("0", "2"):
        by_arg = TT.tentative_solve(mesh.tg, top, u, fused=int(mode))
        monkeypatch.setenv("IEHDG_TENT_FUSED", mode)
        by_env = TT.tentative_solve(mesh.tg, top, u)
        assert by_env[1] == by_arg[1] and torch.equal(by_env[0], by_arg[0])
        ju, jit, _ = JT.tentative_solve(mesh.jg, None, jnp.asarray(mesh.u), C_STAGE, op=jop)
        assert by_env[1] == int(jit)
        monkeypatch.delenv("IEHDG_TENT_FUSED")


@pytest.mark.parametrize("fact", ["1", "0"], ids=["factored", "dense"])
def test_free_Az_skips_the_matvec(mesh, monkeypatch, fact):
    """``exact_Az=False``: the same ``z``, no matvec (no K1, no full-field
    cross pair on factored tables), and ``v - r`` within 1e-12 of the exact
    ``A z``, as in the JAX package."""
    monkeypatch.setenv("IEHDG_FACT", fact)
    jop, top = mesh.ops(mesh.Q)
    rb = torch.as_tensor(mesh.u.reshape(2 * mesh.jg.d1, -1))
    calls = []
    real = TP._matvec_bl
    monkeypatch.setattr(TP, "_matvec_bl", lambda *a: calls.append(1) or real(*a))
    z1, Az1 = TP._colored_apply_fused_bl(mesh.tg, top, rb, exact_Az=True)
    assert len(calls) == 1
    z2, Az2 = TP._colored_apply_fused_bl(mesh.tg, top, rb, exact_Az=False)
    assert len(calls) == 1 and torch.equal(z1, z2)
    close(Az2, Az1, 1e-12)
    jz, jAz = JP._colored_apply_fused_bl(mesh.jg, jop, jnp.asarray(rb.numpy()), symmetric=True,
                                         exact_Az=False)
    close(z2, jz, 1e-12)
    close(Az2, jAz, 1e-12)


@pytest.mark.parametrize("fact", ["1", "0"], ids=["factored", "dense"])
def test_patch_and_colored_apply(mesh, monkeypatch, fact):
    monkeypatch.setenv("IEHDG_FACT", fact)
    jop, top = mesh.ops(mesh.Q)
    r = mesh.u
    close(TP.tentative_patch_apply(mesh.tg, top, torch.as_tensor(r)),
          JP.tentative_patch_apply(mesh.jg, jop, jnp.asarray(r)), 1e-12)
    for sym in (False, True):
        close(TP.tentative_colored_apply(mesh.tg, top, torch.as_tensor(r), symmetric=sym),
              JP.tentative_colored_apply(mesh.jg, jop, jnp.asarray(r), symmetric=sym), 1e-12)
    rb = r.reshape(2 * mesh.jg.d1, -1)
    for sym in (False, True):
        tz, tAz = TP._colored_apply_fused_bl(mesh.tg, top, torch.as_tensor(rb), symmetric=sym)
        jz, jAz = JP._colored_apply_fused_bl(mesh.jg, jop, jnp.asarray(rb), symmetric=sym)
        close(tz, jz, 1e-12)
        close(tAz, jAz, 1e-12)


@pytest.mark.parametrize("fact", ["1", "0"], ids=["factored", "dense"])
def test_reuse_factors(mesh, monkeypatch, fact):
    """The lagged build: the matvec tables of the new star, the patch
    factors of the earlier build (the very tensors), in both packages."""
    monkeypatch.setenv("IEHDG_FACT", fact)
    jprev, tprev = mesh.ops(mesh.Q)
    jop, top = mesh.ops(mesh.Q2, reuse_factors=(jprev, tprev))
    same_tables(top, jop)
    same_tables(convert.tentative_operator_from_jax(jop), jop)
    assert top.Sinv is tprev.Sinv and top.Dinv0 is tprev.Dinv0 and top.Dinv is tprev.Dinv
    jfresh, tfresh = mesh.ops(mesh.Q2)
    matvec = [n for n in OP_FIELDS if n not in ("Dinv", "Sinv", "Dinv0")]
    for name in matvec:
        a = getattr(top, name)
        if a is not None:
            assert torch.equal(a, getattr(tfresh, name)), name
    assert not torch.allclose(top.Sinv, tfresh.Sinv)


def test_stepper_reads_the_tentative_knobs(monkeypatch):
    jd = JDisc(JM.unit_square_mesh(2), 1)
    td = TDisc(TM.unit_square_mesh(2), 1, device="cpu")
    for env in ({}, {"IEHDG_TENT_RESTART": "12", "IEHDG_TENT_SWEEPS": "2",
                     "IEHDG_TENT_SYM": "0"}):
        for k in ("IEHDG_TENT_RESTART", "IEHDG_TENT_SWEEPS", "IEHDG_TENT_SYM"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        js, ts = JH.IncompressibleEulerHDGIMEXSSP2_332(jd, 0.1), TH.IncompressibleEulerHDGIMEXSSP2_332(td, 0.1)
        for a in ("tentative_restart", "tentative_sweeps", "tentative_symmetric"):
            assert getattr(ts, a) == getattr(js, a)
        assert (ts.tentative_restart, ts.tentative_sweeps, ts.tentative_symmetric) == \
            ((12, 2, False) if env else (28, 1, True))


def _jax_composite_steps(cls_name, nx, dt, n):
    """The JAX package's composite step, ``n`` steps from the Taylor-Green
    initial state; returns [(stage_Q, counts)] per step."""
    jd = JDisc(JM.unit_square_mesh(nx), 1)
    js = getattr(JH, cls_name)(jd, dt)
    js.composite_step_cells = 1
    jp = JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    z = lambda a: [a] + [jnp.zeros_like(a)] * (s - 1)
    state = (z(Q), z(p), z(lam))
    step = js._get_step(jp.f_rhs(), False)
    out = []
    for k in range(n):
        sQ, sp, sl, _, counts = step(jd.geom, js._proj, js._cs, js._gtmg, *state,
                                     jnp.asarray(k * dt), jnp.zeros_like(p), None)
        state = (sQ, sp, sl)
        out.append((sQ, counts))
    return out


def _counts(c):
    return dict(tentative=[int(n) for n in np.asarray(c["tentative"])],
                pressure=[int(n) for n in np.asarray(c["pressure"])],
                final_pressure=int(c["final_pressure"]), reconstruction=int(c["reconstruction"]))


@pytest.mark.parametrize("lag", ["0", "1"])
def test_lagged_preconditioner_cli_matches_jax_composite(tmp_path, monkeypatch, capsys, lag):
    """ARS2(2,3,2): both implicit stages have a_ii = gamma, so with
    ``IEHDG_LAG_PC=1`` the second stage reuses the first one's patch
    factors: 4 Gauss-Jordan inversions a step (own cells and 3 colours'
    Schur blocks) instead of 8, and the JAX composite step's counts."""
    monkeypatch.setenv("IEHDG_LAG_PC", lag)
    monkeypatch.chdir(tmp_path)
    calls = []
    real = TP.gauss_jordan_inv_bl

    def counting(A):
        calls.append(A.shape)
        return real(A)

    monkeypatch.setattr(TP, "gauss_jordan_inv_bl", counting)
    res = tdriver.main(["--nx", "4", "--degree", "1", "--dt", "0.1", "--tfinal", "0.2",
                        "--timestepper", "imex_ars2_232", "--use_projection_method",
                        "--device", "cpu"])
    steps = res["timestepper"].step_counts
    assert len(steps) == 2 and len(calls) == 2 * (4 if lag == "1" else 8)
    ref = _jax_composite_steps("IncompressibleEulerHDGIMEXARS2_232", 4, 0.1, 2)
    for tc, (_, jc) in zip(steps, ref):
        assert {k: v for k, v in tc.items() if k != "max_relres"} == _counts(jc)
    close(res["Q"], ref[-1][0][0], 1e-10)


# the port's spans that the JAX package has no label for (utils/logging.py)
PORT_SPANS = {"step", "bdm_projection", "tentative_build", "tentative_inverse", "solve.tentative",
              "solve.pressure", "krylov.precond", "krylov.matvec", "krylov.orthogonalise",
              "host.read"}


def test_phase_timing_fills_the_jax_labels(monkeypatch):
    """One step with ``IEHDG_PHASE_TIMING=1``: the labels of the JAX
    composite step, each as often, and besides them exactly the port's own
    spans; without the knob, none."""
    monkeypatch.setenv("IEHDG_PHASE_TIMING", "1")
    JLog.reset()
    _jax_composite_steps("IncompressibleEulerHDGIMEXSSP2_332", 2, 0.1, 1)
    jlabels = {k: len(v) for k, v in JLog.data.items()}
    JLog.reset()
    td = TDisc(TM.unit_square_mesh(2), 1, device="cpu")
    ts, tp = TH.IncompressibleEulerHDGIMEXSSP2_332(td, 0.1), TTG(td)
    state = ts.initial_state(*tp.initial_condition())
    TLog.reset()
    ts.step(*state, 0.0, tp.f_rhs())
    tlabels = {k: len(v) for k, v in TLog.data.items()}
    assert {k: tlabels.get(k) for k in jlabels} == jlabels
    assert set(jlabels) == {"forcing", "star+build", "residual", "sweep", "final", "reconstruct"}
    assert set(tlabels) == set(jlabels) | PORT_SPANS
    assert all(t >= 0.0 for v in TLog.data.values() for t in v)
    monkeypatch.delenv("IEHDG_PHASE_TIMING")
    TLog.reset()
    ts.step(*state, 0.0, tp.f_rhs())
    assert not TLog.data


def _jax_steps(nx, dt, n):
    """The JAX package's jitted SSP2(3,3,2) step, ``n`` steps from the
    Taylor-Green initial state; returns [(stage_Q, counts)] per step."""
    jd = JDisc(JM.unit_square_mesh(nx), 1)
    js = JH.IncompressibleEulerHDGIMEXSSP2_332(jd, dt)
    jp = JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    z = lambda a: [a] + [jnp.zeros_like(a)] * (js.nstages - 1)
    state = (z(Q), z(p), z(lam))
    step = js._get_step(jp.f_rhs(), False)
    out = []
    for k in range(n):
        sQ, sp, sl, _, counts = step(jd.geom, js._proj, js._cs, js._gtmg, *state,
                                     jnp.asarray(k * dt), jnp.zeros_like(p), None)
        state = (sQ, sp, sl)
        out.append((sQ, counts))
    return out


def test_free_Az_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """``IEHDG_TENT_FUSED=2`` through the CLI, two SSP2(3,3,2) steps at 4^2:
    the JAX step's counts step by step and its state within 1e-10, and the
    JAX driver's printed averages and errors."""
    monkeypatch.setenv("IEHDG_TENT_FUSED", "2")
    monkeypatch.chdir(tmp_path)
    argv = ["--nx", "4", "--degree", "1", "--dt", "0.1", "--tfinal", "0.2",
            "--timestepper", "imex_ssp2_332", "--use_projection_method"]
    capsys.readouterr()
    res = tdriver.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    JH_driver.main(argv)
    jout = capsys.readouterr().out
    steps = res["timestepper"].step_counts
    ref = _jax_steps(4, 0.1, 2)
    assert len(steps) == 2
    for tc, (_, jc) in zip(steps, ref):
        assert {k: v for k, v in tc.items() if k != "max_relres"} == _counts(jc)
    close(res["Q"], ref[-1][0][0], 1e-10)
    assert averaged_counts(out) == averaged_counts(jout) and averaged_counts(out)
    for name in ("velocity error", "pressure error"):
        got, want = (float(re.search(rf"^{name} = (\S+)$", o, re.M).group(1))
                     for o in (out, jout))
        assert abs(got - want) <= 1e-8 * abs(want), name


DIST = {  # name: (jobs module, run, ranks, knobs)
    "slab_sweeps2_forward": (slab_jobs, ("imex", "taylorgreen", 8), 2,
                             {"IEHDG_TENT_SWEEPS": "2", "IEHDG_TENT_SYM": "0"}),
    "slab_fact0_left": (slab_jobs, ("imex", "taylorgreen", 8), 2,
                        {"IEHDG_FACT": "0", "IEHDG_TENT_FUSED": "0"}),
    "partition_sweeps2_left": (partition_jobs, ("shear", 8, "imex", 0.05, 1, False), 3,
                               {"IEHDG_TENT_SWEEPS": "2", "IEHDG_TENT_FUSED": "0"}),
    "slab_fused2": (slab_jobs, ("imex", "taylorgreen", 8), 2, {"IEHDG_TENT_FUSED": "2"}),
    "slab_bf16": (slab_jobs, ("imex_f32", "taylorgreen", 8), 2, {"IEHDG_PC_BF16": "1"}),
    # the disk: one rank and the partition take the same route there (dense
    # tables, the left-preconditioned sweep); on the periodic square the
    # partition's dense tables and the single rank's factored ones count
    # differently in float32 with or without the knob (shear at 10^2, 3
    # ranks: tentative 2, 2, 2, 3 against 6, 2, 3, 3)
    "partition_bf16": (partition_jobs, ("kelvinhelmholtz", 2, "imex_f32", 0.05, 1, False), 2,
                       {"IEHDG_PC_BF16": "1"}),
}
F32_DIST_TOL = 1e-5  # float32 runs over ranks against one rank


@pytest.mark.parametrize("name", sorted(DIST))
def test_knobs_over_ranks(tmp_path, monkeypatch, name):
    """The knobs reach every rank (spawned with this environment) and give
    the single rank's counts, and its state to 1e-10, under the same knobs."""
    jobs, run, n, env = DIST[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    single = (jobs.run_scheme(*run) if jobs is slab_jobs else jobs.run_case(run))
    dist = run_ranks(jobs.job, n, args=((run,),), device="cpu", timeout=300,
                     rendezvous_dir=tmp_path)[0][run]
    assert dist["counts"] == single["counts"]
    assert min(v for c in single["counts"] for v in c["tentative"]) > 0
    tol = F32_DIST_TOL if "imex_f32" in run else 1e-10
    for a, b in zip(dist["states"], single["states"]):
        for x, y in zip(a, b):
            close(x, y, tol)


def test_free_Az_on_the_partition_keeps_its_route(tmp_path, monkeypatch):
    """The partition's route under ``IEHDG_TENT_FUSED=2`` is its route under
    ``=1`` (the exact ``A z``): the same counts and states, bit for bit."""
    run = ("shear", 8, "imex", 0.05, 1, False)
    out = {}
    for mode in ("1", "2"):
        monkeypatch.setenv("IEHDG_TENT_FUSED", mode)
        out[mode] = run_ranks(partition_jobs.job, 3, args=((run,),), device="cpu",
                              timeout=300, rendezvous_dir=tmp_path)[0][run]
    assert out["1"]["counts"] == out["2"]["counts"]
    for a, b in zip(out["1"]["states"], out["2"]["states"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
