"""Parity of the port's monolithic and HDG-implicit paths with the JAX package.

float64 on the CPU, the same inputs (made from a numpy seed, or by both
packages from the same expressions) through both:

- ``gamma_apply`` and ``coupled_matvec``: 1e-12 relative;
- ``fgmres`` (flexible GMRES with x0 and a nullspace projector): equal
  iteration counts, solutions to 1e-10;
- ``monolithic_stage_solve`` and one monolithic SSP2(3,3,2) step at 8^2,
  k=1: equal FGMRES counts, states to 1e-10;
- one ``IncompressibleEulerHDGImplicit`` step, projection and monolithic, and
  one centered-flux projection SSP2 step: states to 1e-10, equal counts.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops import forms as JF
from incompressibleeulerhdg_tpu.ops.fields import mass_apply as j_mass_apply
from incompressibleeulerhdg_tpu.linalg import krylov as JK
from incompressibleeulerhdg_tpu.linalg import monolithic as JM
from incompressibleeulerhdg_tpu.linalg.gtmg import gtmg_apply as j_gtmg_apply
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)
from incompressibleeulerhdg_tpu.timesteppers.hdg_implicit import (
    IncompressibleEulerHDGImplicit as JImplicit,
)

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops import forms as TF
from incompressibleeulerhdg_tpu_torch.ops.fields import mass_apply as t_mass_apply
from incompressibleeulerhdg_tpu_torch.linalg import krylov as TK
from incompressibleeulerhdg_tpu_torch.linalg import monolithic as TM
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_implicit import (
    IncompressibleEulerHDGImplicit as TImplicit,
)

torch.set_num_threads(1)

DT = 0.1


def close(got, ref, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module")
def discs4():
    return JDisc(unit_square_mesh(4), 1), TDisc(unit_square_mesh(4), 1, device="cpu")


def _random_fields(disc, seed):
    g = disc.geom
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, g.d1, g.n_cells)), rng.standard_normal((g.d0, g.n_cells)),
            rng.standard_normal((g.nt, g.n_facets)))


def test_gamma_apply_matches_jax(discs4):
    jd, td = discs4
    u, p, lam = _random_fields(jd, 3)
    ref = JF.gamma_apply(jd.geom, *map(jnp.asarray, (u, p, lam)), tau=1.0)
    got = TF.gamma_apply(td.geom, *map(torch.as_tensor, (u, p, lam)), tau=1.0)
    for a, b in zip(got, ref):
        close(a, b, 1e-12)


@pytest.mark.parametrize("upwind", [True, False])
def test_coupled_matvec_matches_jax(discs4, upwind):
    jd, td = discs4
    u, p, lam = _random_fields(jd, 4)
    Qs = np.random.default_rng(5).standard_normal(u.shape)
    jstar = JF.star_fields(jd.geom, jnp.asarray(Qs))
    tstar = TF.star_fields(td.geom, torch.as_tensor(Qs))
    ref = JM.coupled_matvec(jd.geom, jstar, *map(jnp.asarray, (u, p, lam)), 0.025,
                            upwind=upwind)
    got = TM.coupled_matvec(td.geom, tstar, *map(torch.as_tensor, (u, p, lam)), 0.025,
                            upwind=upwind)
    for a, b in zip(got, ref):
        close(a, b, 1e-12)


@pytest.mark.parametrize("restart", [5, 30])
def test_fgmres_matches_jax(restart):
    """A nonsymmetric system with a constant nullspace direction deflated,
    a Jacobi preconditioner and a nonzero start."""
    rng = np.random.default_rng(43)
    n = 60
    A = np.eye(n) * 3.0 + rng.standard_normal((n, n)) * 0.5 / np.sqrt(n)
    A[np.arange(n), np.arange(n)] += np.linspace(0.0, 4.0, n)
    b, x0 = rng.standard_normal(n), 0.1 * rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    nv = np.zeros(n)
    nv[-5:] = 1.0 / np.sqrt(5.0)
    jA, jd, jn = map(jnp.asarray, (A, dinv, nv))
    tA, td, tn = map(torch.as_tensor, (A, dinv, nv))
    jx, jit, jres = JK.fgmres(lambda v: jA @ v, jnp.asarray(b), M=lambda v: jd * v,
                              x0=jnp.asarray(x0), rtol=1e-11, restart=restart, maxiter=200,
                              project=lambda v: v - jn * jnp.dot(jn, v))
    tx, tit, tres = TK.fgmres(lambda v: tA @ v, torch.as_tensor(b), M=lambda v: td * v,
                              x0=torch.as_tensor(x0), rtol=1e-11, restart=restart, maxiter=200,
                              project=lambda v: v - tn * torch.dot(tn, v))
    assert tit == int(jit) and tit > restart * (restart < 20)
    close(tx, jx, 1e-10)
    np.testing.assert_allclose(tres, float(jres), rtol=1e-6)


@pytest.fixture(scope="module")
def mono8():
    """Both packages' monolithic SSP2 steppers at 8^2, k=1 and their t = 0
    stage states."""
    jd, td = JDisc(unit_square_mesh(8), 1), TDisc(unit_square_mesh(8), 1, device="cpu")
    js = JSSP2(jd, DT, use_projection_method=False)
    ts = TSSP2(td, DT, use_projection_method=False)
    jp, tp = JTG(jd), TTG(td)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    jstate = ([Q] + [jnp.zeros_like(Q)] * (s - 1), [p] + [jnp.zeros_like(p)] * (s - 1),
              [lam] + [jnp.zeros_like(lam)] * (s - 1))
    tstate = ts.initial_state(*tp.initial_condition())
    return js, ts, jp, tp, jstate, tstate


def test_monolithic_stage_solve_matches_jax(mono8):
    """One coupled stage solve from the t = 0 state (rtol 1e-3, where FGMRES
    stops before its 100-iteration cap)."""
    js, ts, _, _, jstate, tstate = mono8
    jg, tg = js.geom, ts.geom
    c = 0.25 * DT
    jstar = JF.star_fields(jg, js.project_bdm(jstate[0][0]))
    tstar = TF.star_fields(tg, ts.project_bdm(tstate[0][0]))
    jb = j_mass_apply(jg, jg.m1, jstate[0][0])
    tb = t_mass_apply(tg, tg.m1, tstate[0][0])
    jx0 = tuple(st[0] for st in jstate)
    tx0 = tuple(st[0] for st in tstate)
    jsolve = jax.jit(lambda b, x0: JM.monolithic_stage_solve(
        jg, js._cs, jstar, b, c, rtol=1e-3, x0=x0,
        precond=lambda v: j_gtmg_apply(jg, js._cs, js._gtmg, v)))
    jout = jsolve(jb, jx0)
    tout = TM.monolithic_stage_solve(tg, ts._cs, tstar, tb, c, rtol=1e-3, x0=tx0,
                                     precond=ts._precond)
    assert tout[3] == int(jout[3]) and 0 < tout[3] < 100
    for a, b in zip(tout[:3], jout[:3]):
        close(a, b, 1e-10)


def test_monolithic_step_matches_jax(mono8):
    """One monolithic SSP2 step (the driver's default scheme) from the same
    start: every stage state to 1e-10, equal FGMRES and pressure counts."""
    js, ts, jp, tp, jstate, tstate = mono8
    step = js._get_step(jp.f_rhs(), False)
    sQ, sp, sl, _, jc = step(js.geom, js._proj, js._cs, js._gtmg, *jstate, jnp.asarray(0.0),
                             jnp.zeros_like(jstate[1][0]), None)
    tQ, tp_, tl, tc = ts.step(*tstate, 0.0, tp.f_rhs())
    for tl_, jl_ in zip((tQ, tp_, tl), (sQ, sp, sl)):
        for a, b in zip(tl_, jl_):
            close(a, b, 1e-10)
    assert tc["tentative"] == [int(n) for n in np.asarray(jc["tentative"])]
    assert tc["pressure"] == tc["tentative"]
    assert tc["final_pressure"] == int(jc["final_pressure"])
    assert tc["reconstruction"] == int(jc["reconstruction"])


@pytest.mark.parametrize("projection", [True, False], ids=["projection", "monolithic"])
def test_hdg_implicit_step_matches_jax(discs4, projection):
    jd, td = discs4
    js = JImplicit(jd, DT, use_projection_method=projection)
    ts = TImplicit(td, DT, use_projection_method=projection)
    jp, tp = JTG(jd), TTG(td)
    Q0, p0 = jp.initial_condition()
    jQ = jd.interpolate_velocity(Q0)
    jpp = js.shift_pressure(jd.interpolate_pressure(p0))
    jf = jd.interpolate_velocity(jp.f_rhs()(0.0))
    Q0t, p0t = tp.initial_condition()
    tQ = td.interpolate_velocity(Q0t)
    tpp = ts.shift_pressure(td.interpolate_pressure(p0t))
    tf = td.interpolate_velocity(tp.f_rhs()(0.0))
    jout = js._step(jd.geom, js._proj, js._cs, js._gtmg, jQ, jpp, jf)
    tout = ts.step(tQ, tpp, tf)
    close(tout[0], jout[0], 1e-10)
    close(tout[1], jout[1], 1e-10)
    assert (tout[2], tout[3]) == (int(jout[2]), int(jout[3]))
    assert min(tout[2], tout[3]) > 0


def test_centered_flux_step_matches_jax():
    """One projection SSP2 step with the centered flux at 4^2, k=1."""
    jd, td = JDisc(unit_square_mesh(4), 1), TDisc(unit_square_mesh(4), 1, device="cpu")
    js, ts = JSSP2(jd, DT, flux="centered"), TSSP2(td, DT, flux="centered")
    jp, tp = JTG(jd), TTG(td)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    jstate = ([Q] + [jnp.zeros_like(Q)] * (s - 1), [p] + [jnp.zeros_like(p)] * (s - 1),
              [lam] + [jnp.zeros_like(lam)] * (s - 1))
    step = js._get_step(jp.f_rhs(), False)
    sQ, sp, sl, _, jc = step(jd.geom, js._proj, js._cs, js._gtmg, *jstate, jnp.asarray(0.0),
                             jnp.zeros_like(p), None)
    tQ, tp_, tl, tc = ts.step(*ts.initial_state(*tp.initial_condition()), 0.0, tp.f_rhs())
    for tl_, jl_ in zip((tQ, tp_, tl), (sQ, sp, sl)):
        for a, b in zip(tl_, jl_):
            close(a, b, 1e-10)
    assert tc["tentative"] == [int(n) for n in np.asarray(jc["tentative"])]
    assert tc["pressure"] == [int(n) for n in np.asarray(jc["pressure"])]
