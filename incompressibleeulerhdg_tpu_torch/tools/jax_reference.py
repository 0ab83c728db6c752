"""The JAX package's driver as the same-machine reference of a port run.

Runs ``python -m incompressibleeulerhdg_tpu.cli.driver`` in a subprocess
(this module imports neither JAX nor the JAX package) with the given flags
and a checkpoint after the last step, then reads back:

- the driver's averaged Krylov iteration counts and its timer table;
- from the checkpoint (the file format both packages share), the final
  velocity, whose kinetic energy ratio E(T)/E(0) and divergence L2 norm are
  computed by ``utils.diagnostics.flow_diagnostics`` on the port's own mesh
  and forms, in the run's dtype on ``--device``, as chip_smoke.py computes
  them for the port's runs (e) and (f).

It prints one JSON line.  With ``--device cuda`` (the default) JAX uses
the card (its Pallas kernels are TPU-only, so it runs its XLA fallbacks
there; ``XLA_PYTHON_CLIENT_PREALLOCATE=false`` keeps it from reserving the
card's memory); with ``--device cpu`` both JAX and the diagnostics run on
the CPU.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.jax_reference \\
            --problem shear --nx 256 --degree 2 --dtype float32 --dt 0.00390625 --steps 2
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
from ..utils.diagnostics import averaged_counts, flow_diagnostics

__all__ = ["run_reference", "reference_diagnostics"]


def timer_table(out):
    """label -> (calls, total s, mean s, std s) of the driver's timer table."""
    rows = re.finditer(r"^(\w[\w ]*?)\s+(\d+)\s+(\S+e[+-]\d+)\s+(\S+e[+-]\d+)\s+(\S+e[+-]\d+)$",
                       out, re.M)
    return {m.group(1): (int(m.group(2)), *(float(m.group(i)) for i in (3, 4, 5))) for m in rows}


def reference_diagnostics(args, Q):
    """(E(T)/E(0), divergence L2 norm) of a final velocity array ``Q``
    (2, d1, nc) on the port's discretisation of the run's mesh, in the run's
    dtype on ``args.device``."""
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    disc = HDGDiscretisation(make_mesh(args), args.degree, dtype=dtype,
                             device=select_device(args.device))
    return flow_diagnostics(disc, make_problem(args, disc), Q)


def run_reference(args):
    """Run the JAX driver for ``args.steps`` steps on ``args.device``;
    returns the result dict."""
    argv = ["--problem", args.problem, "--nx", str(args.nx), "--refinement", str(args.refinement),
            "--degree", str(args.degree), "--dtype", args.dtype, "--dt", repr(args.dt),
            "--tfinal", repr(args.steps * args.dt), "--use_projection_method",
            "--checkpoint_every", str(args.steps)]
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    if args.device == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "incompressibleeulerhdg_tpu.cli.driver", *argv,
             "--checkpoint_file", ck], cwd=tmp, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"JAX driver failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        state, t_ck, _ = load_checkpoint(ck)
    out = proc.stdout
    ratio, div = reference_diagnostics(args, state["stage_Q"][0])
    devices = re.search(r"^jax devices = (.*)$", out, re.M)
    return {
        "argv": argv,
        "jax_devices": devices.group(1) if devices else None,
        "t_final": t_ck,
        "counts": averaged_counts(out),
        "timers": timer_table(out),
        "energy_ratio": ratio,
        "divergence": div,
        "wall_s": wall,
    }


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--problem", choices=["shear", "kelvinhelmholtz"],
                   default="shear")
    p.add_argument("--nx", type=int, default=8)
    p.add_argument("--refinement", type=int, default=2)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=2)
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
