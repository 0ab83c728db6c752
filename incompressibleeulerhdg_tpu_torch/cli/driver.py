"""Command-line driver of the PyTorch port.

Counterpart of incompressibleeulerhdg_tpu/cli/driver.py with the same flags
and printed lines: run banner, the stand-alone pressure-solver benchmark,
the solve with its averaged iteration counts and timer table, the error
norms against the analytic solution where the problem has one, and
``solution.vtu``.  The port runs the three model problems (Taylor-Green on
the unit square, the double shear layer on the periodic square,
Kelvin-Helmholtz on the unit disk) with the HDG IMEX and HDG implicit
schemes (projection or monolithic), DG implicit and conforming RT1 x DG0
implicit (projection or monolithic), optionally advecting a tracer and
writing the ``evolution.pvd`` animation; ``--device`` picks the device
(default ``cuda``; no card is an error, never a silent CPU run).
``--n_devices N`` runs on N ranks, one process each (rank r on ``cuda:r``,
or on the CPU with ``--device cpu``), on the JAX package's route: the slab
decomposition of the structured meshes (parallel/slab.py) where it takes
its slab path, the cell/facet partition (parallel/partition.py) where it
takes its GSPMD sharding (the disk, the conforming scheme, a periodic nx
that N does not divide, a split with an empty slab, the tracer under HDG
or DG implicit); rank 0 prints and writes the outputs from the state
gathered at the end.

Run:  python -m incompressibleeulerhdg_tpu_torch.cli.driver --help
"""

import argparse
import math

import torch

from ..fem.discretisation import HDGDiscretisation
from ..mesh import periodic_square_mesh, unit_disk_mesh, unit_square_mesh
from ..models.problems import DoubleLayerShearFlow, KelvinHelmholtz, TaylorGreen
from ..ops import fields as F
from ..timesteppers.common import to_host
from ..timesteppers.conforming_implicit import IncompressibleEulerConformingImplicit
from ..timesteppers.dg_implicit import IncompressibleEulerDGImplicit
from ..timesteppers.hdg_implicit import IncompressibleEulerHDGImplicit
from ..timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXImplicit,
    IncompressibleEulerHDGIMEXARS2_232,
    IncompressibleEulerHDGIMEXARS3_443,
    IncompressibleEulerHDGIMEXSSP2_332,
    IncompressibleEulerHDGIMEXSSP3_433,
)
from ..utils.callbacks import AnimationCallback
from ..utils.logging import PerformanceLog, log_summary
from ..utils.vtk import sample_dg_at_corners, write_vtu

IMEX_CLASSES = {
    "imex_implicit": IncompressibleEulerHDGIMEXImplicit,
    "imex_ars2_232": IncompressibleEulerHDGIMEXARS2_232,
    "imex_ars3_443": IncompressibleEulerHDGIMEXARS3_443,
    "imex_ssp2_332": IncompressibleEulerHDGIMEXSSP2_332,
    "imex_ssp3_433": IncompressibleEulerHDGIMEXSSP3_433,
}


def build_parser():
    parser = argparse.ArgumentParser("Mesh specifications and polynomial degree")
    parser.add_argument("--problem", choices=["taylorgreen", "kelvinhelmholtz", "shear"],
                        default="taylorgreen", help="model problem to solve")
    parser.add_argument("--nx", type=int, default=8, help="number of grid cells in x-direction")
    parser.add_argument("--refinement", type=int, default=2,
                        help="refinement level for unit disk mesh")
    parser.add_argument("--degree", type=int, default=1, help="polynomial degree")
    parser.add_argument("--tfinal", type=float, default=1.0, help="final time")
    parser.add_argument("--kappa", type=float, default=0.5, help="exponential decay factor")
    parser.add_argument("--dt", type=float, default=0.04, help="timestep size")
    parser.add_argument("--discretisation", choices=["conforming", "dg", "hdg"], default="hdg",
                        help="discretisation method")
    parser.add_argument("--use_projection_method", action="store_true", default=False,
                        help="use projection method for timestepping")
    parser.add_argument("--richardson", type=int, default=2,
                        help="number of Richardson iterations")
    parser.add_argument("--flux", choices=["upwind", "centered"], default="upwind",
                        help="numerical flux")
    parser.add_argument("--timestepper", choices=["implicit", *IMEX_CLASSES],
                        default="imex_ssp2_332", help="timestepper")
    parser.add_argument("--forcing", choices=["exponential", "constant"], default="exponential",
                        help="forcing")
    parser.add_argument("--test_pressure_solver", action="store_true", default=False,
                        help="carry out a single solve with the pressure solver for testing")
    parser.add_argument("--warmup", action="store_true", default=False,
                        help="only perform one timestep")
    parser.add_argument("--animation", action="store_true", default=False,
                        help="save velocity and pressure fields at the end of each timestep "
                        "as an animation")
    parser.add_argument("--tracer_advection", action="store_true", default=False,
                        help="advect tracer field")
    parser.add_argument("--dtype", choices=["float32", "float64"], default="float64",
                        help="runtime floating-point precision (float32 for the card's fast path)")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="distribute the solve over N devices")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="save the solver state every N timesteps (0 = off)")
    parser.add_argument("--checkpoint_file", type=str, default="checkpoint.npz",
                        help="checkpoint file path")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="resume from --checkpoint_file (validated against this config)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of every tensor (cuda: the first card; no card is an error)")
    return parser


def check_args(args):
    """The JAX driver's checks of invalid combinations and of the device
    count."""
    if args.discretisation == "conforming" and args.timestepper != "implicit":
        raise RuntimeError(
            f"Invalid timestepping method for conforming discretisation: '{args.timestepper}'")
    if args.discretisation == "dg":
        if args.use_projection_method:  # the JAX driver's assert, kept under -O too
            raise AssertionError("Can not use projection method with DG discretsation")
        if args.timestepper != "implicit":
            raise RuntimeError(
                f"Invalid timestepping method for DG discretisation: '{args.timestepper}'")
    if args.n_devices > 1:
        check_distributed_args(args)


def check_distributed_args(args):
    """``--n_devices`` beyond the visible cards raises, as the JAX driver's
    device check does (before any work; every scheme and mesh runs)."""
    n = args.n_devices
    if args.device == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"n_devices={n} but only {torch.cuda.device_count()} CUDA devices are visible")


def select_device(name):
    """torch.device for ``--device``; exits when a card is asked for and none
    is visible."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is False; "
                             "run on a CUDA card or pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda:0")
    return torch.device("cpu")


def make_mesh(args):
    """The problem's mesh (the JAX driver's choice, driver.py:155-160)."""
    if args.problem == "shear":
        return periodic_square_mesh(args.nx, L=2 * math.pi)
    if args.problem == "kelvinhelmholtz":
        return unit_disk_mesh(refinement_level=args.refinement)
    return unit_square_mesh(args.nx)


def make_problem(args, disc):
    if args.problem == "shear":
        return DoubleLayerShearFlow(disc)
    if args.problem == "kelvinhelmholtz":
        return KelvinHelmholtz(disc)
    return TaylorGreen(disc, args.forcing, args.kappa)


def make_timestepper(args, disc, callbacks=None):
    if args.discretisation == "conforming":
        return IncompressibleEulerConformingImplicit(
            disc, args.dt, flux=args.flux, use_projection_method=args.use_projection_method,
            callbacks=callbacks)
    if args.discretisation == "dg":
        return IncompressibleEulerDGImplicit(disc, args.dt, flux=args.flux, callbacks=callbacks)
    if args.timestepper == "implicit":
        return IncompressibleEulerHDGImplicit(disc, args.dt, flux=args.flux,
                                              use_projection_method=args.use_projection_method,
                                              callbacks=callbacks)
    return IMEX_CLASSES[args.timestepper](disc, args.dt, flux=args.flux,
                                          use_projection_method=args.use_projection_method,
                                          n_richardson=args.richardson, callbacks=callbacks)


def tracer_initial_condition(x, y):
    """The tracer at t = 0: sin(2 pi x) sin(2 pi y)."""
    return torch.sin(2 * math.pi * x) * torch.sin(2 * math.pi * y)


def main(argv=None):
    """Run the driver; returns a dict with the timestepper (on one device),
    each step's iteration counts and, where computed, the final state, the
    error norms or the pressure-solver benchmark's numbers.  With
    ``--n_devices N`` the dict is rank 0's, without the timestepper."""
    args = build_parser().parse_args(argv)
    check_args(args)
    if args.n_devices > 1:
        from ..parallel.launch import run_ranks

        return run_ranks(_run_rank, args.n_devices, args=(args,), device=args.device)[0]
    return run(args, select_device(args.device))


def _run_rank(comm, device, args):
    """One rank of a ``--n_devices`` run: :func:`run` without the
    timestepper in its result (it stays in the rank's process)."""
    res = run(args, device, comm)
    res.pop("timestepper")
    return res


def run(args, device, comm=None):
    """The driver's work on ``device``; with ``comm``, as one rank of a
    distributed run (the global tables are built on the host, then each
    rank keeps its slab's or partition's on its device; rank 0 prints and
    writes)."""
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    root = comm is None or comm.rank == 0
    with PerformanceLog("setup"):
        mesh = make_mesh(args)
        degree = args.degree
        if args.discretisation == "conforming":
            print("Warning: ignoring degree for conforming method")
            degree = 0
        disc = HDGDiscretisation(mesh, degree, dtype=dtype,
                                 device=device if comm is None else "cpu")
        callbacks = [AnimationCallback(disc, "evolution.pvd")] if args.animation else None
        timestepper = make_timestepper(args, disc, callbacks)
        if comm is not None:
            timestepper.distribute(comm, device, tracer=args.tracer_advection)

    print("+-------------------------------------------------+")
    print("! timesteppers for incompressible Euler equations !")
    print("! (PyTorch port)                                  !")
    print("+-------------------------------------------------+")
    print()
    print(f"model problem = {args.problem}")
    if args.problem == "kelvinhelmholtz":
        print(f"mesh refinement = {args.refinement}")
    else:
        print(f"mesh size = {args.nx} x {args.nx}")
    if args.problem == "taylorgreen":
        print(f"forcing = {args.forcing}")
        print(f"kappa = {args.kappa}")
    print(f"polynomial degree = {args.degree}")
    print(f"final time = {args.tfinal}")
    print(f"timestep size = {args.dt}")
    print(f"discretisation = {args.discretisation}")
    print(f"numerical flux = {args.flux}")
    print(f"number of Richardson iterations = {args.richardson}")
    print(f"use projection method = {args.use_projection_method}")
    print(f"advect tracer = {args.tracer_advection}")
    print(f"timestepping method = {timestepper.label}")
    print(f"dtype = {args.dtype}")
    if comm is not None:
        print(f"distributed over {comm.size} devices")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"torch device = {device} ({name})")
    print()

    result = {"timestepper": timestepper}
    if args.test_pressure_solver:
        if not hasattr(timestepper, "test_pressure_solver"):
            raise RuntimeError("selected timestepper has no pressure solver to test")
        print("=== Testing pressure solver")
        print()
        t_solve, its = timestepper.test_pressure_solver(seed=123456789)
        print(f"    solve time           = {t_solve:12.4f} s")
        print(f"    number of iterations = {its}")
        return dict(result, solve_time=t_solve, iterations=its)

    if args.warmup:
        print("WARNING: performing a single timestep only!")
        print()

    model_problem = make_problem(args, disc)
    Q_0, p_0 = model_problem.initial_condition()
    solve_kwargs = {}
    if args.checkpoint_every or args.resume:
        solve_kwargs = dict(checkpoint_every=args.checkpoint_every,
                            checkpoint_path=args.checkpoint_file, resume=args.resume)
    q_0 = tracer_initial_condition if args.tracer_advection else None
    Q, p = timestepper.solve(Q_0, p_0, q_0, model_problem.f_rhs(), args.tfinal,
                             warmup=args.warmup, **solve_kwargs)
    result.update(step_counts=timestepper.step_counts)
    if not root:
        return result
    result.update(Q=Q, p=p)

    log_summary()

    if not args.warmup:
        geom = disc.geom
        divQ = F.mass_solve(geom, geom.m0inv,
                            F.cell_integrate(geom, geom.phi0, F.cell_div(geom, Q)))
        fields = {
            "velocity": sample_dg_at_corners(disc, to_host(Q)),
            "pressure": sample_dg_at_corners(disc, to_host(p)),
            "divergence": sample_dg_at_corners(disc, to_host(divQ)),
        }
        exact = model_problem.solution(args.tfinal)
        if exact is not None:
            Q_exact, p_exact = exact
            Q_err_nrm = timestepper.velocity_error_norm(Q, Q_exact)
            p_err_nrm = timestepper.pressure_error_norm(p, p_exact)
            print()
            print(f"velocity error = {Q_err_nrm}")
            print(f"pressure error = {p_err_nrm}")
            print()
            fields["velocity_exact"] = sample_dg_at_corners(disc, to_host(Q_exact))
            fields["velocity_error"] = sample_dg_at_corners(disc, to_host(Q - Q_exact))
            fields["pressure_exact"] = sample_dg_at_corners(disc, to_host(p_exact))
            fields["pressure_error"] = sample_dg_at_corners(disc, to_host(p - p_exact))
            result.update(velocity_error=Q_err_nrm, pressure_error=p_err_nrm)
        write_vtu("solution.vtu", mesh, fields)
        print("wrote solution.vtu")
    return result


if __name__ == "__main__":
    main()
