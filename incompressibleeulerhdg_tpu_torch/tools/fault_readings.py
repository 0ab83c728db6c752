"""The readings that classify a float32 fault: one configuration of
projection SSP2 on the Taylor-Green vortex, run by the port on the CPU
and on the card, in float32 and float64, and by the JAX package's driver
(``tools/jax_reference.py``, a subprocess), each on the same flags and
under the same ``IEHDG_*`` variables.

Each run prints one JSON line as soon as it ends: every Krylov count a step
(the port's; the JAX driver prints only its averages a solve), the
largest true relative residual of the run's solves (``max_relres``; the
JAX driver's "max Krylov relative residual"), the velocity and pressure L2
errors against the vortex, the wall time, and on the card the kernel
launches and the card's name.  A run on the card where there is none
fails, as the driver does.

A run is ``where:dtype`` with ``where`` one of ``cpu``, ``cuda`` (the port)
or ``jax`` (the JAX package on the CPU); every run is taken at each
``--nx`` and under each ``--env`` set (comma-separated ``KEY=VALUE``; an
empty string is the default).

With ``--az`` a port run takes no step: it builds the first stage's
tentative operator from the initial velocity and applies the fused sweep
(``IEHDG_TENT_FUSED=1`` and ``=2``) to a seeded vector, and prints how far
each route's returned ``A z`` is from the float64 product of its own ``z``
(relative, in the 2-norm): the inconsistency GMRES's Arnoldi relation
carries, which with the free ``A z`` grows with the mesh (the JAX
package's note, preconditioners.py:1494-1500).

With ``--f32-phase`` a port run takes one float64 step with one phase run
in float32 instead (``bdm``: the BDM projection of the star velocity;
``pressure``: every pressure solve; ``none``), and prints the step's
errors: which phase's float32 rounding the float32 step's error is.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.fault_readings \\
            --nx 32 --degree 8 --runs jax:float32 cpu:float32 cuda:float32 cuda:float64
        python -m incompressibleeulerhdg_tpu_torch.tools.fault_readings \\
            --nx 64 128 256 --degree 2 --runs cuda:float32 --env "" --env IEHDG_TENT_FUSED=2
        python -m incompressibleeulerhdg_tpu_torch.tools.fault_readings \\
            --nx 64 128 256 --degree 2 --runs cuda:float32 --az
        python -m incompressibleeulerhdg_tpu_torch.tools.fault_readings \\
            --nx 2 --degree 8 --runs cpu:float64 --f32-phase none bdm pressure
"""

import argparse
import contextlib
import io
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import kernels
from ..cli import driver
from ..fem.discretisation import HDGDiscretisation
from ..linalg import preconditioners as P
from ..mesh import unit_square_mesh
from ..models.problems import TaylorGreen
from ..ops.forms import star_fields
from ..ops.projection import project_bdm
from ..timesteppers import hdg_imex
from ..timesteppers.hdg_imex import ALPHA_PENALTY, IncompressibleEulerHDGIMEXSSP2_332

F32_PHASES = ("none", "bdm", "pressure")


@contextlib.contextmanager
def environment(env):
    """Within the block, the variables of ``env`` set (then restored)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def parse_env(text):
    return dict(kv.split("=", 1) for kv in text.split(",") if kv)


def port_run(nx, degree, dt, steps, dtype, device):
    """One run of the port's driver in-process: its readings."""
    argv = ["--nx", str(nx), "--degree", str(degree), "--dt", repr(dt), "--tfinal",
            repr(steps * dt), "--dtype", dtype, "--device", device, "--use_projection_method"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(io.StringIO()):
        res = driver.main(argv)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = res["step_counts"]
    finite = all(bool(torch.isfinite(res[f]).all()) for f in ("Q", "p"))
    out = dict(counts=[{k: v for k, v in c.items() if k != "max_relres"} for c in counts],
               max_relres=max(c["max_relres"] for c in counts), finite=finite,
               velocity_error=res["velocity_error"], pressure_error=res["pressure_error"],
               wall_s=wall)
    if device == "cuda":
        out.update(launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                   card=torch.cuda.get_device_name(0))
    del res
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def az_consistency(nx, degree, dt, dtype, device, seed=0):
    """The fused sweep's ``A z`` by both routes against the float64 product
    of the returned ``z`` (relative 2-norm), on the first stage's operator
    of the Taylor-Green step at nx^2 and a seeded vector."""
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    dtype = getattr(torch, dtype)
    mesh = unit_square_mesh(nx)
    steppers = {}
    for dt_ in (dtype, torch.float64):
        disc = HDGDiscretisation(mesh, degree, dtype=dt_, device=dev)
        steppers[dt_] = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
    s64, s = steppers[torch.float64], steppers[dtype]
    c = float(s64.tableau.a_impl[1][1]) * dt
    Q = s64.disc.interpolate_velocity(TaylorGreen(s64.disc).initial_condition()[0]).to(dtype)
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((2 * s.geom.d1, s.geom.n_cells)), device=dev)

    def operator(st, Qs):
        star = star_fields(st.geom, project_bdm(st.geom, st._proj, Qs))
        return P.build_tentative_operator(st.geom, star, c, ALPHA_PENALTY)

    op64, op = operator(s64, Q.double()), operator(s, Q)
    out = {}
    for mode, exact in (("exact_Az", True), ("free_Az", False)):
        z, Az = P._colored_apply_fused_bl(s.geom, op, v.to(dtype), symmetric=True, exact_Az=exact)
        ref = P._matvec_bl(s64.geom, op64, z.double())
        out[mode] = float((Az.double() - ref).norm() / ref.norm())
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    return out


def phase_in_float32(nx, degree, dt, phase, device):
    """One float64 step of the Taylor-Green vortex with one phase of
    F32_PHASES run in float32 (its inputs rounded to float32, its output
    widened back): the step's velocity and pressure errors."""
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    mesh = unit_square_mesh(nx)
    s64, s32 = (IncompressibleEulerHDGIMEXSSP2_332(
        HDGDiscretisation(mesh, degree, dtype=d, device=dev), dt)
        for d in (torch.float64, torch.float32))
    real_bdm = hdg_imex.project_bdm
    if phase == "bdm":
        hdg_imex.project_bdm = lambda geom, proj, Q: real_bdm(
            s32.geom, s32._proj, Q.float()).double()
    elif phase == "pressure":
        s64._pressure_solve = lambda *a: tuple(
            x.double() if torch.is_tensor(x) else x
            for x in s32._pressure_solve(*(t.float() for t in a)))
    try:
        problem = TaylorGreen(s64.disc)
        state = s64.initial_state(*problem.initial_condition())
        sQ, sp, _, _ = s64.step(*state, 0.0, problem.f_rhs())
    finally:
        hdg_imex.project_bdm = real_bdm
    Qe, pe = problem.solution(dt)
    return dict(f32_phase=phase, velocity_error=s64.velocity_error_norm(sQ[0], Qe),
                pressure_error=s64.pressure_error_norm(sp[0], pe))


def jax_run(nx, degree, dt, steps, dtype):
    """One run of the JAX package's driver on the CPU (a subprocess that
    inherits the environment): its readings."""
    from . import jax_reference

    args = jax_reference.build_parser().parse_args(
        ["--problem", "taylorgreen", "--nx", str(nx), "--degree", str(degree), "--dtype", dtype,
         "--dt", repr(dt), "--steps", str(steps), "--use_projection_method", "--device", "cpu"])
    r = jax_reference.run_reference(args)
    return dict(averaged_counts=r["counts"], max_relres=r["max_relres"],
                velocity_error=r["velocity_error"], pressure_error=r["pressure_error"],
                wall_s=r["wall_s"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nx", type=int, nargs="+", required=True)
    p.add_argument("--degree", type=int, required=True)
    p.add_argument("--dt", type=float, default=1.0 / 256)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--runs", nargs="+", required=True,
                   help="where:dtype, where in cpu, cuda (the port), jax (the JAX package)")
    p.add_argument("--env", action="append", default=None,
                   help="comma-separated KEY=VALUE set; repeat for several (default: none)")
    p.add_argument("--az", action="store_true",
                   help="no step: the fused sweep's A z against its own z (port runs only)")
    p.add_argument("--f32-phase", nargs="+", choices=F32_PHASES, default=None,
                   help="a float64 step with this phase in float32 (port runs only)")
    args = p.parse_args(argv)
    results = []
    for nx in args.nx:
        for env_text in args.env or [""]:
            env = parse_env(env_text)
            for spec in args.runs:
                where, dtype = spec.split(":")
                with environment(env):
                    if args.f32_phase:
                        r = [phase_in_float32(nx, args.degree, args.dt, ph, where)
                             for ph in args.f32_phase]
                    elif args.az:
                        r = az_consistency(nx, args.degree, args.dt, dtype, where)
                    elif where == "jax":
                        r = jax_run(nx, args.degree, args.dt, args.steps, dtype)
                    else:
                        r = port_run(nx, args.degree, args.dt, args.steps, dtype, where)
                for r in r if isinstance(r, list) else [r]:
                    r = dict(run=spec, nx=nx, degree=args.degree, dt=args.dt,
                             steps=args.steps, env=env, **r)
                    print(json.dumps(r), flush=True)
                    results.append(r)
    return results


if __name__ == "__main__":
    main()
