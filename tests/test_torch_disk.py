"""The PyTorch port on the unstructured unit disk (Kelvin-Helmholtz) against
the JAX package, on the CPU in float64.

Every facet<->cell move on the disk is an index gather, the tentative
operator has dense (nu, nu, n) tables, the BDM and condensation tables are
applied per cell (more than 16 geometry classes) and the GTMG smoother is
the vertex-star one.  At refinements 2 (k = 1) and 3 (k = 2):

- forms, fields, projection and condensation: <= 1e-12 relative;
- the dense tentative operator, its matvec, each colour's patch solve and
  the colored sweeps: <= 1e-12 (and the sweep refuses a cell without an
  interior facet);
- the two-level preconditioner's tables and its application, with the
  dense coarse solve and with the Chebyshev one: <= 1e-12;
- the tentative and pressure solves: equal iteration counts, <= 1e-10;
- one SSP2(3,3,2) projection step: equal counts, <= 1e-10;
- the driver with projection SSP2, the monolithic default and HDG implicit:
  equal averaged counts and final states (<= 1e-10);
- the port's counterpart of test_integration_extra.py's Kelvin-Helmholtz run.

The generic tests here also run on the periodic square
(tests/test_torch_periodic.py imports them with its own ``case`` fixture).
"""

import dataclasses
from functools import cached_property

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.cli import driver as jdriver
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.linalg import condense as JC
from incompressibleeulerhdg_tpu.linalg import gtmg as JG
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.linalg import tentative as JT
from incompressibleeulerhdg_tpu.linalg.pressure import pressure_solve as j_pressure_solve
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.models import problems as JPB
from incompressibleeulerhdg_tpu.ops import fields as JFd
from incompressibleeulerhdg_tpu.ops import forms as JF
from incompressibleeulerhdg_tpu.ops import projection as JPr
from incompressibleeulerhdg_tpu.ops import reconstruction as JR
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
from incompressibleeulerhdg_tpu_torch.fem.discretisation import Geom, HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.linalg import condense as TC
from incompressibleeulerhdg_tpu_torch.linalg import gtmg as TG
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg import tentative as TT
from incompressibleeulerhdg_tpu_torch.linalg.pressure import pressure_solve as t_pressure_solve
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models import problems as TPB
from incompressibleeulerhdg_tpu_torch.ops import fields as TFd
from incompressibleeulerhdg_tpu_torch.ops import forms as TF
from incompressibleeulerhdg_tpu_torch.ops import projection as TPr
from incompressibleeulerhdg_tpu_torch.ops import reconstruction as TR
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)
from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint
from incompressibleeulerhdg_tpu_torch.utils.diagnostics import (
    averaged_counts,
    divergence_norm,
    kinetic_energy,
)

torch.set_num_threads(1)

C_STAGE = 0.01  # a_ii * dt of the operator tests (well-posed Schur blocks)


def close(got, ref, rtol=1e-12):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rtol * float(np.max(np.abs(ref))), err


class Case:
    """One mesh and degree, built by both packages from the same generator
    arguments, with seeded fields and (on first use) each layer's objects."""

    def __init__(self, mesh_name, mesh_arg, k, problem):
        self.mesh_name, self.mesh_arg, self.k, self.problem = mesh_name, mesh_arg, k, problem
        self.jd = JDisc(getattr(JM, mesh_name)(mesh_arg), k)
        self.td = TDisc(getattr(TM, mesh_name)(mesh_arg), k, device="cpu")
        self.jg, self.tg = self.jd.geom, self.td.geom
        g = self.jg
        rng = np.random.default_rng(17 * mesh_arg + k)
        self.Q = rng.standard_normal((2, g.d1, g.n_cells))
        self.u = rng.standard_normal((2, g.d1, g.n_cells))
        self.p = rng.standard_normal((g.d0, g.n_cells))
        self.lam = rng.standard_normal((g.nt, g.n_facets))
        self.jstar = JF.star_fields(g, jnp.asarray(self.Q))
        self.tstar = TF.star_fields(self.tg, torch.as_tensor(self.Q))

    def both(self, jfn, tfn, *arrays):
        """(port result, JAX result) of one function on the same arrays."""
        return (tfn(self.tg, *map(torch.as_tensor, arrays)),
                jfn(self.jg, *map(jnp.asarray, arrays)))

    @cached_property
    def cs(self):
        return JC.build_condensed_system(self.jd), TC.build_condensed_system(self.td)

    @cached_property
    def pc(self):
        jcs, tcs = self.cs
        return JG.build_gtmg(self.jd, jcs), TG.build_gtmg(self.td, tcs)

    @cached_property
    def op(self):
        return (JP.build_tentative_operator(self.jg, self.jstar, C_STAGE),
                TP.build_tentative_operator(self.tg, self.tstar, C_STAGE))


@pytest.fixture(scope="module", params=[2, 3], ids=["ref2k1", "ref3k2"])
def case(request):
    return Case("unit_disk_mesh", request.param, request.param - 1, "kelvinhelmholtz")


@pytest.fixture(scope="module")
def step_case():
    """The smallest case, for the whole-step comparison (its JAX step is
    compiled as one program)."""
    return Case("unit_disk_mesh", 2, 1, "kelvinhelmholtz")


# ----------------------------------------------------------------------
# geometry, forms, fields, projection, condensation
# ----------------------------------------------------------------------


def test_geom_equals_jax(case):
    """The port's Geom from its own mesh equals the JAX package's host
    tables, index tables and metadata included."""
    host = case.jd._geom_host
    for f in dataclasses.fields(Geom):
        a, b = getattr(case.tg, f.name), getattr(host, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                          err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["facet_traces_plus", "facet_traces_minus",
                                  "scatter_facets", "facet_grad_traces"])
def test_fields_match_jax(case, name):
    if name.startswith("facet_traces"):
        side = int(name.endswith("minus"))
        got, ref = case.both(lambda g, u: JFd.facet_traces(g, g.tphi1, u)[side],
                             lambda g, u: TFd.facet_traces(g, g.tphi1, u)[side], case.u)
    elif name == "scatter_facets":
        g0 = np.random.default_rng(3).standard_normal((2, case.jg.wqf.shape[0], case.jg.n_facets))
        got, ref = case.both(lambda g, a, b: JFd.scatter_facets(g, g.tphi1, a, b),
                             lambda g, a, b: TFd.scatter_facets(g, g.tphi1, a, b), g0, 2.0 * g0)
    else:
        (t0, t1), (j0, j1) = case.both(JR.facet_grad_traces, TR.facet_grad_traces, case.u)
        close(t1, j1)
        got, ref = t0, j0
    close(got, ref)


@pytest.mark.parametrize("name", ["f_impl_apply", "pressure_gradient_apply",
                                  "weak_divergence_apply", "gamma_apply", "project_bdm",
                                  "pressure_reconstruction_rhs"])
def test_forms_match_jax(case, name):
    if name == "f_impl_apply":
        got = TF.f_impl_apply(case.tg, case.tstar, torch.as_tensor(case.u))
        ref = JF.f_impl_apply(case.jg, case.jstar, jnp.asarray(case.u))
    elif name == "pressure_gradient_apply":
        got, ref = case.both(JF.pressure_gradient_apply, TF.pressure_gradient_apply,
                             case.p, case.lam)
    elif name == "weak_divergence_apply":
        got, ref = case.both(JF.weak_divergence_apply, TF.weak_divergence_apply, case.u)
    elif name == "gamma_apply":
        (tp, tl), (jp, jl) = case.both(JF.gamma_apply, TF.gamma_apply, case.u, case.p, case.lam)
        close(tl, jl)
        got, ref = tp, jp
    elif name == "project_bdm":
        jproj, tproj = JPr.build_bdm_projection(case.jd), TPr.build_bdm_projection(case.td)
        close(tproj.recon, jproj.recon)
        np.testing.assert_array_equal(tproj.class_id.numpy(), np.asarray(jproj.class_id))
        got = TPr.project_bdm(case.tg, tproj, torch.as_tensor(case.Q))
        ref = JPr.project_bdm(case.jg, jproj, jnp.asarray(case.Q))
    else:
        (tp, tl), (jp, jl) = case.both(JR.pressure_reconstruction_rhs,
                                       TR.pressure_reconstruction_rhs, case.Q, case.u)
        close(tl, jl)
        got, ref = tp, jp
    close(got, ref)


def test_condense_matches_jax(case):
    jcs, tcs = case.cs
    for name in ("S", "Ainv", "AinvB", "CAinv", "Sdiag_inv", "nullvec"):
        close(getattr(tcs, name), getattr(jcs, name))
    close(TC.trace_matvec(case.tg, tcs, torch.as_tensor(case.lam)),
          JC.trace_matvec(case.jg, jcs, jnp.asarray(case.lam)))
    args = (case.u, case.p, case.lam)
    close(TC.condense_rhs(case.tg, tcs, *map(torch.as_tensor, args)),
          JC.condense_rhs(case.jg, jcs, *map(jnp.asarray, args)))
    for a, b in zip(TC.back_substitute(case.tg, tcs, *map(torch.as_tensor, args)),
                    JC.back_substitute(case.jg, jcs, *map(jnp.asarray, args))):
        close(a, b)


# ----------------------------------------------------------------------
# the tentative operator and its Schwarz preconditioners
# ----------------------------------------------------------------------


def test_tentative_operator_tables(case):
    jop, top = case.op
    names = [f.name for f in dataclasses.fields(top) if getattr(top, f.name) is not None]
    assert ("D" in names) == (case.tg.shift is None)
    for name in names:
        close(getattr(top, name), getattr(jop, name))
    conv = convert.tentative_operator_from_jax(jop)
    assert [f.name for f in dataclasses.fields(conv) if getattr(conv, f.name) is not None] == names


@pytest.mark.parametrize("name", ["matvec", "colored_symmetric", "colored", "orphans_refused"])
def test_tentative_operator_applies(case, name):
    jop, top = case.op
    nu = 2 * case.jg.d1
    v = case.u.reshape(nu, -1)
    tv, jv = torch.as_tensor(v), jnp.asarray(v)
    if name == "matvec":
        got, ref = TP._matvec_bl(case.tg, top, tv), JP._matvec_bl(case.jg, jop, jv)
        weak = JT.tentative_matvec(case.jg, case.jstar, jnp.asarray(case.u), C_STAGE)
        close(got.reshape(case.u.shape), weak)
    elif name.startswith("colored"):
        sym = name.endswith("symmetric")
        got = TP._colored_apply_bl(case.tg, top, tv, symmetric=sym)
        ref = JP._colored_apply_bl(case.jg, jop, jv, symmetric=sym)
    else:  # a cell without an interior facet (only the 1x1 square has one)
        orphaned = dataclasses.replace(case.tg, fcol_orphans=True)
        with pytest.raises(ValueError, match="interior facet"):
            TP._colored_apply_bl(orphaned, top, tv, symmetric=True)
        return
    close(got, ref)


def test_patch_color_each_colour(case):
    jop, top = case.op
    nu = 2 * case.jg.d1
    v = case.u.reshape(nu, -1)
    structured = case.tg.shift is not None
    tpatch = TP._patch_color_structured if structured else TP._patch_color
    jpatch = JP._patch_color_structured if structured else JP._patch_color
    ncol = len(case.tg.fcol_bounds) - 1
    assert ncol == (3 if structured else 5)
    for k in range(ncol):
        close(tpatch(case.tg, top, k, torch.as_tensor(v)), jpatch(case.jg, jop, k, jnp.asarray(v)))


def test_tentative_solve(case):
    jop, top = case.op
    ju, jit, _ = JT.tentative_solve(case.jg, case.jstar, jnp.asarray(case.u), C_STAGE, op=jop,
                                    restart=28)
    tu, tit, trel = TT.tentative_solve(case.tg, top, torch.as_tensor(case.u), restart=28)
    assert tit == int(jit) and tit > 0 and trel < 1e-9
    close(tu, ju, 1e-10)


# ----------------------------------------------------------------------
# the two-level preconditioner and the pressure solve
# ----------------------------------------------------------------------


def test_gtmg_tables(case):
    jpc, tpc = case.pc
    assert tpc.coarse_kind == jpc.coarse_kind and tpc.vshift == jpc.vshift
    assert tpc.sign == float(jpc.sign) and tpc.n_vertices == jpc.n_vertices
    np.testing.assert_allclose(tpc.lmax_fine, jpc.lmax_fine, rtol=1e-12)
    if tpc.coarse_kind == "cheb":
        np.testing.assert_allclose(tpc.lmax_coarse, jpc.lmax_coarse, rtol=1e-12)
    for name in ("Sdiag_inv", "trace_nodes", "facet_verts", "K_elem", "cells", "K_diag_inv",
                 "vf", "vf_end", "vf_mask", "vc", "vc_pos", "vc_mask", "star_inv", "star_pos",
                 "coarse_dense_inv", "coarse_eig_inv"):
        a = getattr(tpc, name)
        if a is None:
            assert name in ("star_inv", "star_pos", "coarse_dense_inv", "coarse_eig_inv")
            continue
        close(a, getattr(jpc, name))


@pytest.mark.parametrize("coarse", ["as_built", "chebyshev"])
def test_gtmg_apply(case, coarse):
    """The V-cycle with the coarse solve as built, and with the Chebyshev
    coarse solve (the dense pseudo-inverse or the FFT dropped from both
    packages' objects)."""
    jcs, tcs = case.cs
    jpc, tpc = case.pc
    if coarse == "chebyshev":  # with the gather transfers on every mesh
        kw = dict(coarse_dense_inv=None, coarse_kind="cheb", vshift=None,
                  lmax_coarse=float(jpc.lmax_coarse))
        jpc, tpc = dataclasses.replace(jpc, **kw), dataclasses.replace(tpc, **kw)
    rng = np.random.default_rng(9)
    zc = rng.standard_normal(jpc.n_vertices)
    close(TG.prolong(tpc, torch.as_tensor(zc)), JG.prolong(jpc, jnp.asarray(zc)))
    close(TG.restrict(tpc, torch.as_tensor(case.lam)), JG.restrict(jpc, jnp.asarray(case.lam)))
    close(TG._coarse_solve(tpc, torch.as_tensor(zc)), JG._coarse_solve(jpc, jnp.asarray(zc)))
    r = case.lam.ravel()
    close(TG.gtmg_apply(case.tg, tcs, tpc, torch.as_tensor(r)),
          JG.gtmg_apply(case.jg, jcs, jpc, jnp.asarray(r)))
    conv = convert.gtmg_from_jax(jpc)
    close(TG.gtmg_apply(case.tg, tcs, conv, torch.as_tensor(r)),
          JG.gtmg_apply(case.jg, jcs, jpc, jnp.asarray(r)))


def test_pressure_solve(case):
    jcs, tcs = case.cs
    jpc, tpc = case.pc
    args = (case.u, case.p, case.lam)
    jout = j_pressure_solve(case.jg, jcs, *map(jnp.asarray, args),
                            precond=lambda v: JG.gtmg_apply(case.jg, jcs, jpc, v))
    tout = t_pressure_solve(case.tg, tcs, *map(torch.as_tensor, args),
                            precond=lambda v: TG.gtmg_apply(case.tg, tcs, tpc, v))
    assert tout[3] == int(jout[3]) and tout[3] > 0
    for a, b in zip(tout[:3], jout[:3]):
        close(a, b, 1e-10)


# ----------------------------------------------------------------------
# one step, the whole run, the driver
# ----------------------------------------------------------------------


def _problem(pkg, name, disc):
    return (pkg.DoubleLayerShearFlow if name == "shear" else pkg.KelvinHelmholtz)(disc)


def test_ssp2_step_matches_jax(step_case):
    """One SSP2(3,3,2) projection step from the problem's initial state:
    every stage state to 1e-10 and every Krylov count equal."""
    case = step_case
    dt = 0.05
    js, ts = JSSP2(case.jd, dt), TSSP2(case.td, dt)
    jp, tp = _problem(JPB, case.problem, case.jd), _problem(TPB, case.problem, case.td)
    Q0, p0 = jp.initial_condition()
    Q = case.jd.interpolate_velocity(Q0)
    p = js.shift_pressure(case.jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    jstate = ([Q] + [jnp.zeros_like(Q)] * (s - 1), [p] + [jnp.zeros_like(p)] * (s - 1),
              [lam] + [jnp.zeros_like(lam)] * (s - 1))
    step = js._get_step(jp.f_rhs(), False)
    jQ, jP, jL, _, jc = step(case.jg, js._proj, js._cs, js._gtmg, *jstate, jnp.asarray(0.0),
                             jnp.zeros_like(p), None)
    tstate = ts.initial_state(*tp.initial_condition())
    for a, b in zip(tstate, jstate):
        close(a[0], b[0], 1e-12)
    tQ, tP, tL, tc = ts.step(*tstate, 0.0, tp.f_rhs())
    for tl, jl in zip((tQ, tP, tL), (jQ, jP, jL)):
        for a, b in zip(tl, jl):
            close(a, b, 1e-10)
    assert tc["tentative"] == [int(n) for n in np.asarray(jc["tentative"])]
    assert tc["pressure"] == [int(n) for n in np.asarray(jc["pressure"])]
    assert tc["final_pressure"] == int(jc["final_pressure"])
    assert tc["reconstruction"] == int(jc["reconstruction"])
    assert min(tc["tentative"] + tc["pressure"]) > 0


def test_kelvin_helmholtz_disk_end_to_end():
    """tests/test_integration_extra.py's Kelvin-Helmholtz run through the
    port (refinement 2, k = 1, dt = 0.05 to T = 0.25): finite, no energy
    gain beyond 5%, at least 20% kept, divergence below 1e-3."""
    disc = TDisc(TM.unit_disk_mesh(2), 1, device="cpu")
    stepper = TSSP2(disc, 0.05)
    problem = TPB.KelvinHelmholtz(disc)
    Q0e, p0e = problem.initial_condition()
    E0 = kinetic_energy(disc.geom, disc.interpolate_velocity(Q0e))
    Q, _ = stepper.solve(Q0e, p0e, None, problem.f_rhs(), 0.25)
    assert bool(torch.isfinite(Q).all()) and problem.solution(0.25) is None
    E1 = kinetic_energy(disc.geom, Q)
    assert 0.2 * E0 <= E1 <= 1.05 * E0, (E0, E1)
    assert divergence_norm(disc.geom, Q) < 1e-3
    # the pressure mean shift divides by the polygon's area, not pi
    assert stepper.domain_volume == pytest.approx(3.10583, abs=5e-6)


def check_cli_matches_jax(argv, tmp_path, monkeypatch, capsys, n_counts=4):
    """The port's driver and the JAX driver on the same flags: the same
    ``n_counts`` averaged iteration counts (projection SSP2 prints four, the
    monolithic scheme two, HDG implicit none), the same final state (each
    driver's checkpoint after its last step, <= 1e-10), no error norms (no
    exact solution), a solution.vtu from each."""
    monkeypatch.chdir(tmp_path)
    argv = argv + ["--checkpoint_every", "1", "--checkpoint_file", "state.npz"]
    capsys.readouterr()
    res = tdriver.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    (tmp_path / "solution.vtu").unlink()
    (tmp_path / "state.npz").rename(tmp_path / "port.npz")
    jdriver.main(argv)
    jout = capsys.readouterr().out
    assert (tmp_path / "solution.vtu").exists()
    counts, jcounts = averaged_counts(out), averaged_counts(jout)
    assert len(counts) == n_counts and counts == jcounts, (counts, jcounts)
    (state, t, _), (jstate, jt, _) = (load_checkpoint(tmp_path / f) for f in ("port.npz",
                                                                               "state.npz"))
    assert t == pytest.approx(jt, abs=1e-12) and state.keys() == jstate.keys()
    for name, ref in jstate.items():
        for a, b in zip(*((v if isinstance(v, list) else [v]) for v in (state[name], ref))):
            close(a, b, 1e-10)
    for text in (out, jout):
        assert "velocity error" not in text and "pressure error" not in text
    assert "velocity_error" not in res
    assert bool(torch.isfinite(res["Q"]).all())
    return out


def test_cli_kelvin_helmholtz_matches_jax(tmp_path, monkeypatch, capsys):
    out = check_cli_matches_jax(
        ["--problem", "kelvinhelmholtz", "--refinement", "2", "--degree", "1", "--dt", "0.05",
         "--tfinal", "0.1", "--use_projection_method"], tmp_path, monkeypatch, capsys)
    assert "mesh refinement = 2" in out and "kappa" not in out


SCHEMES = {"monolithic": ([], 2),
           "implicit": (["--timestepper", "implicit", "--use_projection_method"], 0),
           "implicit_monolithic": (["--timestepper", "implicit"], 0)}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_cli_kelvin_helmholtz_schemes_match_jax(scheme, tmp_path, monkeypatch, capsys):
    """The CLI default (monolithic SSP2) and HDG implicit, with projection
    (the left-preconditioned tentative GMRES at restart 40) and monolithic,
    on the disk: one step each."""
    flags, n_counts = SCHEMES[scheme]
    check_cli_matches_jax(["--problem", "kelvinhelmholtz", "--refinement", "2", "--degree", "1",
                           "--dt", "0.05", "--tfinal", "0.05", *flags],
                          tmp_path, monkeypatch, capsys, n_counts)


def test_disk_mesh_takes_the_gather_paths(case):
    """The disk has no shift structure, more than 16 geometry classes and
    no cell without an interior facet: the gather branches, the per-cell
    class blocks and the left-preconditioned tentative GMRES."""
    assert case.tg.shift is None and case.tg.uniform is None and not case.tg.fcol_orphans
    proj = TPr.build_bdm_projection(case.td)
    assert proj.recon.shape[0] > TPr.CLASS_LOOP_MAX
    assert case.pc[1].coarse_kind == "cheb" and case.pc[1].star_inv is not None
    assert case.pc[1].coarse_dense_inv is not None  # at most 8,192 vertices
