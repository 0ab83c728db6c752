"""How far one projection SSP2 step's state moves when its initial velocity
moves by one unit in the last place: the rounding sensitivity of a run,
which sets how closely two devices summing in different orders can agree.

Runs the port's CLI driver twice on the same flags (Taylor-Green, dt =
1/256, one step, float64 unless ``--dtype``), the second time with every
entry of the interpolated initial velocity multiplied by 1 +- 2^-52 (the
signs from a fixed seed), and prints one JSON line: the largest change of
the final velocity and pressure relative to their largest entries, and
both runs' Krylov counts.  It runs on the card unless ``--device cpu``
asks for the CPU, as the driver does.  The CPU's move at k = 11 on 4^2
sets how far chip_smoke.py's run (o11c) may hold the card's state from
``--device cpu``'s.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.ulp_sensitivity --degree 11 --nx 4
            [--dtype float64] [--device cpu]
"""

import argparse
import contextlib
import io
import json
import os
import tempfile

import torch

from ..cli import driver
from ..fem.discretisation import HDGDiscretisation


def run(argv, perturb):
    """The driver's result on ``argv``, its initial velocity perturbed by
    one unit in the last place where ``perturb``."""
    real = HDGDiscretisation.interpolate_velocity

    def interpolate(self, Q):
        out = real(self, Q)
        if not perturb:
            return out
        gen = torch.Generator().manual_seed(1)
        sign = torch.randint(0, 2, out.shape, generator=gen).to(out.device, out.dtype) * 2 - 1
        return out * (1 + torch.finfo(out.dtype).eps * sign)

    HDGDiscretisation.interpolate_velocity = interpolate
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return driver.main(argv)
    finally:
        HDGDiscretisation.interpolate_velocity = real


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--degree", type=int, required=True)
    parser.add_argument("--nx", type=int, required=True)
    parser.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    dt = 1.0 / 256
    flags = ["--nx", str(args.nx), "--degree", str(args.degree), "--dt", str(dt), "--tfinal",
             str(dt), "--use_projection_method", "--dtype", args.dtype, "--device", args.device]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            base, moved = run(flags, False), run(flags, True)
        finally:
            os.chdir(cwd)
    change = max(float((moved[f] - base[f]).abs().max()) / float(base[f].abs().max())
                 for f in ("Q", "p"))
    print(json.dumps({"degree": args.degree, "nx": args.nx, "dtype": args.dtype,
                      "device": args.device, "state_change": change,
                      "counts": base["timestepper"].step_counts,
                      "counts_perturbed": moved["timestepper"].step_counts}))


if __name__ == "__main__":
    main()
