"""Readings that set a cell's limits: sound runs and the control, in one
process.

    python3 -m benchmark.control --workload <cell> --seconds <s> \\
        --seeds 1 2 ... [--control-seeds 101 102 103] [--nx N --dt DT] [--out FILE]

builds the cell once, then for each seed starts the state of the seed's
parameters, takes the warm-up step and steps for ``--seconds`` (as a
run's window does), and prints the numbers that decide ``correct``
(``run.check_state``), one JSON line a seed.  The control seeds repeat
this with TF32 on (``torch.backends.cuda.matmul.allow_tf32`` and
``cudnn.allow_tf32``): float32 with TF32 off is what the configurations
state, and TF32 is the nearest precision below it.  Each seed's line
also holds a second control, close to float32: the same numbers of its
final state rounded to bfloat16 (``bf16_state``).  ``--nx``/``--dt``
read another mesh than the traffic's (the card-only control test's).
The benchmark's own runs never run this.
"""

import argparse
import json
import math
import sys
import time

import torch

from . import cell as C
from . import manifest
from .run import check_state

__all__ = ["readings", "bf16_rounded", "main"]


def bf16_rounded(arrays):
    """``cell.state_arrays`` with Q, p and the trace rounded to bfloat16."""
    Q, p, lam, cells, ends = arrays
    r = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(torch.float64).numpy()
    return r(Q), r(p), r(lam), cells, ends


def readings(spec, seeds, seconds, device, tf32, cell=None, emit=None, steps=None):
    """One dict a seed, each also handed to ``emit`` as it is read: the
    seed, its parameters, TF32, the steps and their time, the checks, and
    the checks of the final state rounded to bfloat16, after a window of
    ``seconds`` (or of ``steps`` steps); ``cell`` a :func:`cell.build`
    result to reuse.  Returns (dicts, the cell)."""
    cell = cell or C.build(spec.config, spec.traffic, spec.problem, device)
    out = []
    for seed in seeds:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            params = spec.problem.parameters(seed, spec.traffic)
            C.start(cell, spec.config, spec.problem, params)
            window_s, counts, _ = C.run_steps(cell, seconds, max_steps=steps)
            notes = []
            arrays, t = C.state_arrays(cell), cell.steps_done * cell.dt
            checks = check_state(spec, params, counts, arrays, t, notes)
            rounded = check_state(spec, params, counts, bf16_rounded(arrays), t, notes)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                      for c in checks.values())
        out.append({"cell": spec.name, "nx": spec.traffic["nx"], "seed": seed, **params,
                    "tf32": tf32, "steps": len(counts), "step_s": window_s / len(counts),
                    "last_counts": {k: v for k, v in counts[-1].items() if k != "max_relres"},
                    "max_relres": max(float(c["max_relres"]) for c in counts),
                    "correct": correct, "notes": notes,
                    "checks": {k: v["value"] for k, v in checks.items()},
                    "bf16_state": {k: v["value"] for k, v in rounded.items()}})
        if emit is not None:
            emit(out[-1])
    return out, cell


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--steps", type=int, help="end each window after this many steps")
    parser.add_argument("--nx", type=int)
    parser.add_argument("--dt", type=float)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("# the control runs on a CUDA card", file=sys.stderr)
        return 2
    spec = manifest.cell_spec(args.workload)
    if args.nx:
        spec.traffic = dict(spec.traffic, nx=args.nx, dt=args.dt or spec.traffic["dt"])
    device = torch.device("cuda:0")

    def emit(row):
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    t0 = time.perf_counter()
    rows, cell = readings(spec, args.seeds, args.seconds, device, False, emit=emit,
                          steps=args.steps)
    rows += readings(spec, args.control_seeds, args.seconds, device, True, cell, emit,
                     args.steps)[0]
    print(f"# {len(rows)} readings in {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(device)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
