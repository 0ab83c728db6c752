"""The PyTorch port's whole slice: HDG IMEX SSP2(3,3,2) with Richardson +
projection on the Taylor-Green vortex, against the JAX package.

- two timesteps from the same initial state at 4^2, k=1, float64: every
  stage state (Q, p, lam) agrees to 1e-10 relative and every Krylov solve
  takes the same number of iterations;
- the accuracy row of BASELINE.md (ssp2_332, k=1, 8^2, dt=0.1, T=0.5:
  velocity L2 error 1.12e-3, pressure 6.03e-3), reproduced to three
  significant digits through the port's ``solve()``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
    IncompressibleEulerHDGIMEXImplicit as TImplicit,
)

torch.set_num_threads(1)

NX, DT = 4, 0.1


def close(got, ref, rtol):
    got = got.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module")
def steps():
    """Both packages' states after 0, 1 and 2 steps from the same start."""
    jd = JDisc(unit_square_mesh(NX), 1)
    js = JSSP2(jd, DT)
    jp = JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    jstate = ([Q] + [jnp.zeros_like(Q)] * (s - 1), [p] + [jnp.zeros_like(p)] * (s - 1),
              [lam] + [jnp.zeros_like(lam)] * (s - 1))
    step = js._get_step(jp.f_rhs(), False)
    ops = (jd.geom, js._proj, js._cs, js._gtmg)
    jout = [jstate]
    for k in range(2):
        sQ, sp, sl, _, counts = step(*ops, *jout[-1][:3], jnp.asarray(k * DT), jnp.zeros_like(p), None)
        jout.append((sQ, sp, sl, counts))

    td = TDisc(unit_square_mesh(NX), 1, device="cpu")
    ts = TSSP2(td, DT)
    tp = TTG(td)
    tstate = ts.initial_state(*tp.initial_condition())
    tout = [tstate]
    for k in range(2):
        tout.append(ts.step(*tout[-1][:3], k * DT, tp.f_rhs()))
    return jout, tout


def test_initial_state_matches(steps):
    jout, tout = steps
    for tl, jl in zip(tout[0], jout[0]):
        for a, b in zip(tl, jl):
            if np.abs(np.asarray(b)).max() > 0:
                close(a, b, 1e-12)


@pytest.mark.parametrize("k", [1, 2])
def test_step_matches_jax(steps, k):
    jout, tout = steps
    for tl, jl in zip(tout[k][:3], jout[k][:3]):
        for a, b in zip(tl, jl):
            close(a, b, 1e-10)
    tc, jc = tout[k][3], jout[k][3]
    assert tc["tentative"] == [int(n) for n in np.asarray(jc["tentative"])]
    assert tc["pressure"] == [int(n) for n in np.asarray(jc["pressure"])]
    assert tc["final_pressure"] == int(jc["final_pressure"])
    assert tc["reconstruction"] == int(jc["reconstruction"])
    assert min(tc["tentative"] + tc["pressure"]) > 0


def test_step_from_converted_state(steps):
    """The JAX state carried over with convert.state_from_jax steps to the
    same result as the port's own."""
    jout, tout = steps
    td = TDisc(unit_square_mesh(NX), 1, device="cpu")
    ts = TSSP2(td, DT)
    state = [convert.state_from_jax(a) for a in jout[1][:3]]
    out = ts.step(*state, DT, TTG(td).f_rhs())
    for tl, jl in zip(out[:3], jout[2][:3]):
        for a, b in zip(tl, jl):
            close(a, b, 1e-10)


def _solve_errors(cls, nx, dt, tfinal):
    disc = TDisc(unit_square_mesh(nx), 1, device="cpu")
    stepper = cls(disc, dt)
    problem = TTG(disc)
    Q0, p0 = problem.initial_condition()
    Q, p = stepper.solve(Q0, p0, None, problem.f_rhs(), tfinal)
    Q_exact, p_exact = problem.solution(tfinal)
    return stepper.velocity_error_norm(Q, Q_exact), stepper.pressure_error_norm(p, p_exact)


def test_baseline_accuracy_row():
    """BASELINE.md: ssp2_332, k=1, 8^2, dt=0.1, T=0.5 gives velocity
    1.12e-3 and pressure 6.03e-3."""
    err_vel, err_p = _solve_errors(TSSP2, 8, 0.1, 0.5)
    assert float(f"{err_vel:.3g}") == 1.12e-3, err_vel
    assert float(f"{err_p:.3g}") == 6.03e-3, err_p


def test_implicit_tableau_is_first_order():
    """The 2-stage implicit tableau shares the stepper: halving (h, dt)
    roughly halves its velocity error."""
    e1, _ = _solve_errors(TImplicit, 4, 0.05, 0.2)
    e2, _ = _solve_errors(TImplicit, 8, 0.025, 0.2)
    assert e1 < 0.1 and e2 < 0.6 * e1, (e1, e2)


def test_float32_step_runs():
    """The float32 path (the card's working type) on the CPU: finite, and
    close to the float64 step at the float32 Krylov tolerances."""
    outs = []
    for dtype in (torch.float32, torch.float64):
        td = TDisc(unit_square_mesh(NX), 2, dtype=dtype, device="cpu")
        ts = TSSP2(td, DT)
        tp = TTG(td)
        sQ, sp, sl, counts = ts.step(*ts.initial_state(*tp.initial_condition()), 0.0,
                                     tp.f_rhs())
        assert sQ[0].dtype == dtype and bool(torch.isfinite(sQ[0]).all())
        outs.append(sQ[0].to(torch.float64))
    close(outs[0], outs[1].numpy(), 1e-4)
