"""Time the kernels K2-K5 and the main path of one tree of the port on a
CUDA card, for an A/B of two trees in turns.

Imports ``incompressibleeulerhdg_tpu_torch`` from ``--root`` (a checkout or
an unpacked ``git archive`` of any commit of the port), so the same script
measures the parent and the change; run it once per tree, in turns (parent,
change, change, parent), in one call on one card.  It prints one JSON line:

- K2 on the full field (both (10, 10, nf) tables, 3 colours + tail) and on
  one colour, K3 on one colour, at the 256^2, k=2, float32 main-path shapes;
  K4 (Gauss-Jordan, n = 20) on the 131072 own-cell blocks of 256^2, k=2 and
  on one colour's 65280 Schur blocks; K5 (n = 42) on the 32768 own-cell
  blocks of 128^2, k=4 and on one colour's 16256: ms per launch over 20
  launches after a warm-up (the tables exceed the 50 MB L2, or nearly, so
  every launch reads them from HBM), as device time from torch.profiler;
- the main path (HDG IMEX SSP2, k=2, float32, dt = 1/256; Taylor-Green
  on the 256^2 square, or with ``--problem`` the shear layer on the
  periodic 256^2 square or Kelvin-Helmholtz on the unit disk at
  ``--refinement``, built as the CLI driver builds them): set-up seconds,
  s/step over 3 steps after a warm-up step, each ended by
  ``torch.cuda.synchronize()``, the iteration counts, launches a step, and
  from ``torch.profiler`` over one more step the device time of each kernel
  and of all kernels and the PyTorch operators with the most device time;
- the same for Taylor-Green at 128^2, k=4 (chip_smoke.py's run (d), which
  runs K5), over one step after a warm-up step (``wide_128_k4_``), or at
  each ``--wide NX:K`` given instead (e.g. ``--wide 64:5 --wide 64:6``,
  chip_smoke.py's runs (n5), (n6): ``wide_64_k5_``, ``wide_64_k6_``).

The tree must have ``cli.driver.make_mesh`` (any tree that runs the shear
layer and the disk).

Usage:  python incompressibleeulerhdg_tpu_torch/tools/ab_cross_patch.py --root DIR [--label L]
            [--problem taylorgreen|shear|kelvinhelmholtz] [--refinement R] [--wide NX:K ...]
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

NX, DEGREE, REPS, STEPS = 256, 2, 20, 3
WIDE_NX, WIDE_DEGREE = 128, 4
DISK_REFINEMENT = 7
PROFILER_ATTEMPTS = 3
EVENTS_CHECK_MS, EVENTS_RATIO = 0.2, 1.2  # device_time's check against CUDA events
GRAPH_REPLAYS = 5  # graph_ms: replays of the captured calls between its two events
AB_READS = 5  # in_turns: reads of each kernel of an A/B
# each kernel's symbol, as torch.profiler names its launches
SYMBOLS = {name: f"{name}_kernel" for name in
           ("fact_apply", "cross_pair", "patch_solve", "gauss_jordan", "gauss_jordan_select",
            "fact_apply_wide", "cross_pair_wide", "cross_pair_cluster", "patch_solve_wide")}
SYMBOLS["gauss_jordan_wide"] = "gauss_jordan_wide"  # its register-tile and cluster kernels
SYMBOLS["gauss_jordan_blocked"] = "gauss_jordan_blocked"  # its copy, panel and update kernels


def device_ms(fn, reps=REPS, match=None):
    """Device milliseconds per call of ``fn()``; see ``device_time``."""
    return device_time(fn, reps, match)[0]


def device_time(fn, reps=REPS, match=None, attempts=PROFILER_ATTEMPTS):
    """(milliseconds per call of ``fn()``, timer).  The timer is
    "profiler": the summed device durations of the kernels ``fn`` runs over
    ``reps`` calls after a warm-up call, from torch.profiler, divided by
    ``reps``; with ``match``, of the kernels whose name contains ``match``,
    divided by the number of their launches the session recorded (one a
    call: a session that loses some launches still reads the time of one).
    A CUDA-event interval around one call would also count the host's launch
    time when that exceeds the kernel's, as it does for a kernel of a few
    tens of microseconds behind a Python wrapper.  A profiler session now
    and then records no device time for the kernels asked for; such a
    session is repeated, and after ``attempts`` empty sessions the timer is
    "cuda events": one event pair around ``reps`` back-to-back calls, which
    counts every kernel of ``fn`` and any gap between them.  A session can
    also keep part of a launch's time (on the H100, K5w's 128^2 batch once
    read 2.23 ms where one colour, half its blocks, read 2.31; NVIDIA H100
    80GB HBM3, 700.00 W): every read of EVENTS_CHECK_MS or more a call
    (whose launches then hide behind the kernels) is checked against the
    events, whose time is kept, with the timer "cuda events (longer than
    the profiler's)", where it is more than EVENTS_RATIO times longer.
    Without ``match`` the events also count the gaps between ``fn``'s
    kernels, so a plain version whose host keeps the card waiting reads
    its events' time there."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        us, launches = _profiled_us(fn, reps, match)
        if us > 0:
            if match and launches != reps:
                print(f"# device_time: the profiler recorded {launches} launches of {match} "
                      f"in {reps} calls", file=sys.stderr, flush=True)
            ms = us / 1e3 / (launches if match else reps)
            if ms >= EVENTS_CHECK_MS:
                ev = _events_ms(fn, reps)
                if ev > EVENTS_RATIO * ms:
                    print(f"# device_time: {match or 'all kernels'} read {ms:.4f} ms by the "
                          f"profiler and {ev:.4f} ms by CUDA events; the events' time is kept",
                          file=sys.stderr, flush=True)
                    return ev, "cuda events (longer than the profiler's)"
            return ms, "profiler"
        print(f"# device_time: profiler session {attempt + 1} of {attempts} recorded no "
              f"device time{' for ' + match if match else ''}", file=sys.stderr, flush=True)
    return _events_ms(fn, reps), "cuda events"


def graph_ms(fn, reps=REPS, replays=GRAPH_REPLAYS):
    """Device milliseconds per call of ``fn()``, the timer of the A/Bs that
    decide the port's dispatch (tools/ab_cross.py, tools/ab_patch.py):
    ``reps`` calls captured in one CUDA graph, replayed ``replays`` times
    between two CUDA events after a warm-up call and a warm-up replay.  The
    replays launch the kernels back to back with no host work between them,
    so the events read the card's time (with the graph's short gaps between
    launches), however slow the host, and without torch.profiler, whose
    sessions now and then lose launches or part of a launch's time (on the
    H100, K2c's full field once read 0.0720 ms where every other read was
    0.15; NVIDIA H100 80GB HBM3, 700.00 W): a kernel whose read comes out
    too short would win an A/B it loses.  ``fn`` launches on PyTorch's
    current stream and allocates through PyTorch, as the kernels' wrappers
    and the tools' runners do."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (replays * reps)


def in_turns(runs, timer, reads=AB_READS):
    """Each of ``runs`` (name -> call) timed ``reads`` times by ``timer`` in
    turns, the order reversed on every other turn, so that a drift of the
    card's clock falls on every kernel alike: (the median read by name, the
    reads by name)."""
    names = list(runs)
    got = {n: [] for n in names}
    for turn in range(reads):
        for n in names if turn % 2 == 0 else names[::-1]:
            got[n].append(timer(runs[n]))
    return {n: statistics.median(v) for n, v in got.items()}, got


def _profiled_us(fn, reps, match):
    """(summed device microseconds, number of kernel launches) of the kernels
    of ``reps`` calls of ``fn`` whose name contains ``match`` (or all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and (match is None or match in ev.key)]
    return sum(_self_device_us(ev) for ev in events), sum(ev.count for ev in events)


def plain_ms(fn, reps):
    """Milliseconds per call of a plain version ``fn`` (many kernels and
    host work between them): CUDA events around ``reps`` calls after a
    warm-up call.  A torch.profiler read of such a call can keep only part
    of its kernels' time (on the H100 the one-colour cross pair's plain
    version once read 0.04 ms, a thirtieth of its time)."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def _events_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_us(ev):
    us = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0.0) if us is None else us


def kernel_times(P):
    """K2 full field, K2 one colour, K3 one colour at the 256^2, k=2 shapes."""
    d1, nu = 10, 20
    nc, nf = 2 * NX * NX, 3 * NX * NX + 2 * NX
    b = (0, NX * NX, NX * NX + NX * (NX - 1), NX * NX + 2 * NX * (NX - 1))
    k = 1
    b0, m = b[k], b[k + 1] - b[k]
    rng = np.random.default_rng(2024)
    rnd = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device="cuda")
    K01, K10 = rnd(d1, d1, nf), rnd(d1, d1, nf)
    Bp, Cp = rnd(3, nu, nu), rnd(3, nu, nu)
    x0, x1 = rnd(nu, nf), rnd(nu, nf)
    Di, Si = rnd(nu, nu, nf), rnd(nu, nu, nf)
    r0, r1 = rnd(nu, m), rnd(nu, m)
    xm0, xm1 = x0[:, :m].contiguous(), x1[:, :m].contiguous()
    out = {
        "k2_full_ms": device_ms(lambda: P.cross_pair(K01, K10, Bp, Cp, b, x0, x1),
                                match="cross_pair_kernel"),
        "k2_color_ms": device_ms(lambda: P.cross_pair(K01, K10, Bp[k:k + 1], Cp[k:k + 1],
                                                      (0, m), xm0, xm1, aoff=b0),
                                 match="cross_pair_kernel"),
        "k3_color_ms": device_ms(lambda: P.patch_solve(Di, Si, K01, K10, Bp[k], Cp[k], r0, r1, b0),
                                 match="patch_solve_kernel"),
    }
    del K01, K10, x0, x1, Di, Si
    torch.cuda.empty_cache()
    return out


def gauss_jordan_times(smallinv):
    """K4 at n = 20 on 256^2, k=2's own cells and one colour; K5 at n = 42
    on 128^2, k=4's own cells and one colour; diagonally dominant blocks."""
    from incompressibleeulerhdg_tpu_torch.tools.microbench_gj import diag_dominant

    out = {}
    for key, n, nx, fn, name in (("k4", 20, NX, smallinv.gauss_jordan_inv_bl, "gauss_jordan"),
                                 ("k5", 42, WIDE_NX, smallinv.gauss_jordan_inv_select,
                                  "gauss_jordan_select")):
        for suffix, m in (("", 2 * nx * nx), ("_color", nx * (nx - 1))):
            A = diag_dominant(n, m, torch.float32, seed=n)
            out[f"{key}{suffix}_ms"] = device_ms(lambda: fn(A), match=SYMBOLS[name])
            del A
    torch.cuda.empty_cache()
    return out


def device_ms_by_kernel(fn, top=15, operators=True):
    """Device ms of each kernel K1-K5, K1w-K3w, K2c, K5w and of all kernels during ``fn()``,
    and the ``top`` PyTorch operators by device time (each with the kernels
    it launches itself: name, ms, calls), from torch.profiler; with
    ``operators`` False the host's operators are not traced (a long ``fn``,
    such as a whole CLI run, then costs the profiler far less) and the list
    is empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if operators else [])
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    per = dict.fromkeys(SYMBOLS, 0.0)
    total, n, ops = 0.0, 0, []
    for ev in prof.key_averages():
        us = _self_device_us(ev)
        if us <= 0:
            continue
        if ev.device_type != DeviceType.CUDA:
            ops.append((ev.key, us / 1e3, ev.count))
            continue
        total += us
        n += ev.count
        for name, sym in SYMBOLS.items():
            if sym in ev.key:
                per[name] += us / 1e3
    ops.sort(key=lambda o: -o[1])
    return {"kernel_device_ms": per, "device_ms": total / 1e3, "device_events": n,
            "top_device_ms": ops[:top]}


def main_path(nx=NX, degree=DEGREE, steps=STEPS, problem="taylorgreen", refinement=DISK_REFINEMENT):
    """HDG IMEX SSP2 + projection on ``problem``'s mesh as the CLI driver
    builds it (nx^2, or the unit disk at ``refinement``), k = degree,
    float32, dt = 1/256: set-up, one warm-up step, ``steps`` timed steps, one
    profiled step."""
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.cli.driver import make_mesh, make_problem
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )

    dt = 1.0 / NX
    args = argparse.Namespace(problem=problem, nx=nx, refinement=refinement, forcing="exponential",
                              kappa=0.5)
    t0 = time.perf_counter()
    disc = HDGDiscretisation(make_mesh(args), degree, dtype=torch.float32, device="cuda")
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
    model = make_problem(args, disc)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    f_rhs = model.f_rhs()
    state = stepper.initial_state(*model.initial_condition())
    state = stepper.step(*state, 0.0, f_rhs)[:3]
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, counts = [], None
    for k in range(steps):
        t0 = time.perf_counter()
        *state, counts = stepper.step(*state, (k + 1) * dt, f_rhs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {n: v / steps for n, v in kernels.LAUNCHES.items()}
    prof = device_ms_by_kernel(lambda: stepper.step(*state, (steps + 1) * dt, f_rhs))
    return {"problem": problem, "n_cells": disc.geom.n_cells, "setup_s": setup_s,
            "s_per_step": sum(times) / steps, "steps_s": times,
            "tentative": counts["tentative"], "pressure": counts["pressure"],
            "final": counts["final_pressure"], "recon": counts["reconstruction"],
            "launches_per_step": launches, **prof}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="tree whose port is measured")
    parser.add_argument("--label", default="")
    parser.add_argument("--problem", choices=["taylorgreen", "shear", "kelvinhelmholtz"],
                        default="taylorgreen", help="the main path's problem and mesh")
    parser.add_argument("--refinement", type=int, default=DISK_REFINEMENT,
                        help="unit-disk refinement of --problem kelvinhelmholtz")
    parser.add_argument("--wide", action="append", metavar="NX:K",
                        help=f"Taylor-Green at NX^2, degree K, one profiled step (repeatable; "
                             f"default {WIDE_NX}:{WIDE_DEGREE})")
    args = parser.parse_args(argv)
    wide_runs = [tuple(int(v) for v in w.split(":")) for w in args.wide or
                 [f"{WIDE_NX}:{WIDE_DEGREE}"]]
    if not torch.cuda.is_available():
        sys.exit("ab_cross_patch: needs a CUDA card (torch.cuda.is_available() is False)")
    sys.path.insert(0, args.root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import incompressibleeulerhdg_tpu_torch as port
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as P
    from incompressibleeulerhdg_tpu_torch.linalg import smallinv

    build_s = kernels.build_all()
    wide = {f"wide_{nx}_k{k}_{key}": v for nx, k in wide_runs
            for key, v in main_path(nx, k, steps=1).items()}
    res = {"label": args.label, "package": port.__file__, "build_s": build_s,
           **kernel_times(P), **gauss_jordan_times(smallinv),
           **main_path(problem=args.problem, refinement=args.refinement),
           **wide, "card": torch.cuda.get_device_name(0)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
