"""The JAX package's driver as the same-machine reference of a port run.

Runs ``python -m incompressibleeulerhdg_tpu.cli.driver`` in a subprocess
(this module imports neither JAX nor the JAX package) with the given flags
and a checkpoint after the last step, then reads back:

- the driver's averaged Krylov iteration counts, its timer table and, where
  the problem has an exact solution, its velocity and pressure errors;
- with ``--test_pressure_solver``, the benchmark's iteration count and
  solve time (no step is taken);
- from the checkpoint (the file format both packages share), the final
  state: for the problems without an exact solution the kinetic energy
  ratio E(T)/E(0) and the divergence L2 norm of the final DG velocity
  (``utils.diagnostics.flow_diagnostics``, not for the conforming scheme,
  whose state is RT dofs), and with ``--tracer_advection`` the tracer's L2
  norm (``utils.diagnostics.tracer_norm``), computed on the port's own mesh
  and forms, in the run's dtype on ``--device``, as chip_smoke.py computes
  them for the port's runs.

It prints one JSON line.  With ``--device cuda`` (the default) JAX uses
the card (its Pallas kernels are TPU-only, so it runs its XLA fallbacks
there; ``XLA_PYTHON_CLIENT_PREALLOCATE=false`` keeps it from reserving the
card's memory); with ``--device cpu`` both JAX and the diagnostics run on
the CPU.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.jax_reference \\
            --problem shear --nx 256 --degree 2 --dtype float32 --dt 0.00390625 --steps 2 \\
            --use_projection_method
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from ..cli.driver import make_mesh, make_problem, select_device
from ..fem.discretisation import HDGDiscretisation
from ..utils.checkpoint import load_checkpoint
from ..utils.diagnostics import averaged_counts, flow_diagnostics, tracer_norm

__all__ = ["run_reference", "reference_diagnostics"]


def timer_table(out):
    """label -> (calls, total s, mean s, std s) of the driver's timer table."""
    rows = re.finditer(r"^(\w[\w ]*?)\s+(\d+)\s+(\S+e[+-]\d+)\s+(\S+e[+-]\d+)\s+(\S+e[+-]\d+)$",
                       out, re.M)
    return {m.group(1): (int(m.group(2)), *(float(m.group(i)) for i in (3, 4, 5))) for m in rows}


def printed(out, pattern):
    """The number after ``pattern =`` on a line of ``out`` (a unit "s" after
    it allowed), or None."""
    m = re.search(rf"{pattern}\s*=\s*(\S+)[ s]*$", out, re.M)
    return None if m is None else float(m.group(1))


def _disc(args):
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    degree = 0 if args.discretisation == "conforming" else args.degree
    return HDGDiscretisation(make_mesh(args), degree, dtype=dtype,
                             device=select_device(args.device))


def reference_diagnostics(args, Q):
    """(E(T)/E(0), divergence L2 norm) of a final velocity array ``Q``
    (2, d1, nc) on the port's discretisation of the run's mesh, in the run's
    dtype on ``args.device``."""
    disc = _disc(args)
    return flow_diagnostics(disc, make_problem(args, disc), Q)


def driver_argv(args):
    """The JAX driver's flags for ``args`` (without the checkpoint)."""
    argv = ["--problem", args.problem, "--nx", str(args.nx), "--refinement", str(args.refinement),
            "--degree", str(args.degree), "--dtype", args.dtype, "--dt", repr(args.dt),
            "--discretisation", args.discretisation, "--timestepper", args.timestepper]
    for flag in ("use_projection_method", "tracer_advection", "test_pressure_solver"):
        if getattr(args, flag):
            argv.append(f"--{flag}")
    if not args.test_pressure_solver:
        argv += ["--tfinal", repr(args.steps * args.dt)]
    return argv


def run_reference(args):
    """Run the JAX driver for ``args.steps`` steps (or its pressure-solver
    benchmark) on ``args.device``; returns the result dict."""
    argv = driver_argv(args)
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    if args.device == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "state.npz")
        extra = [] if args.test_pressure_solver else ["--checkpoint_every", str(args.steps),
                                                      "--checkpoint_file", ck]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "incompressibleeulerhdg_tpu.cli.driver", *argv, *extra],
            cwd=tmp, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"JAX driver failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        ck_state = None if args.test_pressure_solver else load_checkpoint(ck)[:2]
    out = proc.stdout
    devices = re.search(r"^jax devices = (.*)$", out, re.M)
    res = {
        "argv": argv,
        "jax_devices": devices.group(1) if devices else None,
        "timers": timer_table(out),
        "wall_s": wall,
    }
    if args.test_pressure_solver:
        return dict(res, iterations=int(printed(out, "number of iterations")),
                    solve_time=printed(out, "solve time"))
    state, t_ck = ck_state
    res.update(t_final=t_ck, counts=averaged_counts(out),
               velocity_error=printed(out, "^velocity error"),
               pressure_error=printed(out, "^pressure error"))
    m = re.search(r"max Krylov relative residual:\s*(\S+)$", out, re.M)
    res["max_relres"] = None if m is None else float(m.group(1))
    if res["velocity_error"] is None and args.discretisation != "conforming":
        Q = state["stage_Q"][0] if "stage_Q" in state else state["Q"]
        res["energy_ratio"], res["divergence"] = reference_diagnostics(args, Q)
    if args.tracer_advection:
        res["tracer_l2"] = tracer_norm(_disc(args), state["q_tracer"])
    return res


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--problem", choices=["taylorgreen", "shear", "kelvinhelmholtz"],
                   default="shear")
    p.add_argument("--nx", type=int, default=8)
    p.add_argument("--refinement", type=int, default=2)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--discretisation", choices=["conforming", "dg", "hdg"], default="hdg")
    p.add_argument("--timestepper", default="imex_ssp2_332",
                   choices=["implicit", "imex_implicit", "imex_ars2_232", "imex_ars3_443",
                            "imex_ssp2_332", "imex_ssp3_433"])
    p.add_argument("--use_projection_method", action="store_true", default=False)
    p.add_argument("--tracer_advection", action="store_true", default=False)
    p.add_argument("--test_pressure_solver", action="store_true", default=False)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where JAX runs and the diagnostics are computed")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = run_reference(args)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
