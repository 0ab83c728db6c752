"""The system under test: one cell's set-up, its timed steps and its state.

Everything here drives ``incompressibleeulerhdg_tpu_torch`` (the PyTorch
and CUDA program) through its own entry points: the problem module's mesh
and problem (``benchmark/problems/``), ``HDGDiscretisation``, the HDG IMEX
stepper named by the configuration's tableau and ``stepper.step``.  The
program is imported inside the functions, so that importing this module
loads nothing of it.
"""

import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["Cell", "check_config", "build", "start", "set_up", "run_steps", "sync",
           "state_arrays"]

DTYPES = ("float32", "float64")


def sync(device):
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_config(config):
    """Raise ValueError on a configuration value this harness does not
    run: it builds HDG discretisations only, in float32 or float64, TF32
    only beside float32."""
    if config.get("discretisation") != "hdg":
        raise ValueError(f"the harness runs discretisation 'hdg' only, not "
                         f"{config.get('discretisation')!r}")
    if config.get("dtype") not in DTYPES:
        raise ValueError(f"dtype {config.get('dtype')!r} is not one of {DTYPES}")
    if config.get("tf32") and config["dtype"] != "float32":
        raise ValueError("TF32 applies to float32 only")
    if not float(config.get("krylov_relres_max", 0.0)) > 0.0:
        raise ValueError("the configuration states no krylov_relres_max")


def _stepper_class(tableau):
    from incompressibleeulerhdg_tpu_torch.timesteppers import hdg_imex

    for obj in vars(hdg_imex).values():
        if isinstance(obj, type) and issubclass(obj, hdg_imex.IncompressibleEulerHDGIMEX) \
                and obj.tableau_name == tableau:
            return obj
    raise ValueError(f"the program has no HDG IMEX stepper with tableau {tableau!r}")


@dataclass
class Cell:
    """A set-up cell: the stepper and its state after the warm-up step."""

    device: torch.device
    mesh: object
    stepper: object
    f_rhs: object
    dt: float
    state: tuple
    steps_done: int = 0  # steps taken from t = 0, the warm-up step included
    spans: dict = field(default_factory=dict)  # set-up spans, host seconds


def build(config, traffic, problem, device):
    """Build the mesh of ``problem`` (a module of ``benchmark/problems/``)
    for the traffic, and the discretisation and the stepper of ``config``
    on ``device`` (on the card, after building or loading every kernel
    library).  Returns a :class:`Cell` with no state yet; :func:`start`
    gives it one."""
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation

    check_config(config)
    problem.check(config, traffic)
    spans = {}
    dtype = getattr(torch, config["dtype"])
    if device.type == "cuda":
        t0 = time.perf_counter()
        kernels.build_all()  # nothing to do once the checkout has its libraries
        spans["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = problem.mesh(traffic)
    spans["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    disc = HDGDiscretisation(mesh, config["degree"], dtype=dtype, device=device)
    stepper = _stepper_class(config["timestepper"])(
        disc, traffic["dt"], flux=config["flux"],
        use_projection_method=config["use_projection_method"],
        n_richardson=config["n_richardson"])
    sync(device)
    spans["disc"] = time.perf_counter() - t0
    return Cell(device=device, mesh=mesh, stepper=stepper, f_rhs=None, dt=traffic["dt"],
                state=None, spans=spans)


def start(cell, config, problem, params):
    """Give ``cell`` the state at t = 0 of ``problem`` with the seed's
    ``params`` and take one warm-up step (every shape of a step)."""
    program = problem.program_problem(cell.stepper.disc, config, params)
    cell.f_rhs = program.f_rhs()
    t0 = time.perf_counter()
    sQ, sp, sl = cell.stepper.initial_state(*program.initial_condition())
    sQ, sp, sl, _ = cell.stepper.step(sQ, sp, sl, 0.0, cell.f_rhs)
    sync(cell.device)
    cell.spans["warmup"] = time.perf_counter() - t0
    cell.state, cell.steps_done = (sQ, sp, sl), 1
    return cell


def set_up(config, traffic, problem, params, device):
    """:func:`build`, then :func:`start` with the seed's ``params``."""
    return start(build(config, traffic, problem, device), config, problem, params)


def run_steps(cell, seconds, max_steps=None, phase_timing=False):
    """Step ``cell`` back to back, each step ended by a synchronise, until
    ``seconds`` have passed (at least one step) or ``max_steps`` are done.
    With ``phase_timing`` the program's ``IEHDG_PHASE_TIMING=1`` spans are
    on.  Returns (seconds taken, each step's counts, each step's seconds)."""
    old = os.environ.get("IEHDG_PHASE_TIMING")
    if phase_timing:
        os.environ["IEHDG_PHASE_TIMING"] = "1"
    try:
        counts, times = [], []
        sQ, sp, sl = cell.state
        t0 = t_last = time.perf_counter()
        while True:
            sQ, sp, sl, c = cell.stepper.step(sQ, sp, sl, cell.steps_done * cell.dt, cell.f_rhs)
            sync(cell.device)
            now = time.perf_counter()
            cell.steps_done += 1
            counts.append(c)
            times.append(now - t_last)
            t_last = now
            if now - t0 >= seconds or (max_steps is not None and len(counts) >= max_steps):
                break
        cell.state = (sQ, sp, sl)
        return now - t0, counts, times
    finally:
        if phase_timing:
            if old is None:
                del os.environ["IEHDG_PHASE_TIMING"]
            else:
                os.environ["IEHDG_PHASE_TIMING"] = old


def state_arrays(cell):
    """The program's state after its last step as float64 host arrays: Q,
    p, the trace, each cell's three vertex ids and each facet's two, in the
    program's cell and facet order (a facet's from its plus cell and local
    facet)."""
    import numpy as np
    from incompressibleeulerhdg_tpu_torch.mesh import LOCAL_FACET_VERTS

    sQ, sp, sl = cell.state
    Q, p, lam = (t[0].detach().to("cpu", torch.float64).numpy() for t in (sQ, sp, sl))
    m = cell.mesh
    plus, local = m.facet_cells[:, 0], m.facet_local[:, 0]
    ends = m.cells[plus[:, None], LOCAL_FACET_VERTS[local]]
    return Q, p, lam, np.asarray(m.cells, dtype=np.int64), np.asarray(ends, dtype=np.int64)
