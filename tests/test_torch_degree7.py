"""k = 7 through the PyTorch port's stepper, against the JAX package in
float64: one SSP2 step on the 2^2 square from the same initial state, the
stage states within 1e-10 and every Krylov count equal.  At k = 7 (d1 = 45,
n = 90) the card runs the runtime-width kernels K1w-K3w and K5w; on the CPU
the wrappers run the plain versions that chip_smoke.py holds them to.
"""

import numpy as np
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh as t_mesh
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)

torch.set_num_threads(1)

DEGREE = 7


def close(got, ref, rtol):
    got = np.asarray(got.detach().cpu())
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


def test_step_k7_matches_jax():
    """One SSP2 step at k = 7 on the 2^2 square: every stage state within
    1e-10 and every Krylov count equal."""
    dt = 0.1
    jd = JDisc(unit_square_mesh(2), DEGREE)
    assert jd.geom.d1 == 45
    js, jp = JSSP2(jd, dt), JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    z = lambda a: [a] + [jnp.zeros_like(a)] * (s - 1)
    step = js._get_step(jp.f_rhs(), False)
    jQ, jpr, jl, _, jc = step(jd.geom, js._proj, js._cs, js._gtmg, z(Q), z(p), z(lam),
                              jnp.asarray(0.0), jnp.zeros_like(p), None)

    td = TDisc(t_mesh(2), DEGREE, device="cpu")
    ts, tp = TSSP2(td, dt), TTG(td)
    tQ, tpr, tl, tc = ts.step(*ts.initial_state(*tp.initial_condition()), 0.0, tp.f_rhs())
    for tlist, jlist in ((tQ, jQ), (tpr, jpr), (tl, jl)):
        for a, b in zip(tlist, jlist):
            close(a, b, 1e-10)
    assert tc["tentative"] == [int(n) for n in np.asarray(jc["tentative"])]
    assert tc["pressure"] == [int(n) for n in np.asarray(jc["pressure"])]
    assert tc["final_pressure"] == int(jc["final_pressure"])
    assert tc["reconstruction"] == int(jc["reconstruction"])
    assert min(tc["tentative"] + tc["pressure"]) > 0
