"""Time K2 (cross pair) and K3 (patch solve) and the main path of one tree
of the port on a CUDA card, for an A/B of two trees in turns.

Imports ``incompressibleeulerhdg_tpu_torch`` from ``--root`` (a checkout or
an unpacked ``git archive`` of any commit of the port), so the same script
measures the parent and the change; run it once per tree, in turns (parent,
change, change, parent), in one call on one card.  It prints one JSON line:

- K2 on the full field (both (10, 10, nf) tables, 3 colours + tail) and on
  one colour, K3 on one colour, at the 256^2, k=2, float32 main-path shapes:
  ms per launch over 20 launches after a warm-up (the tables exceed the
  50 MB L2, so every launch reads them from HBM), as device time from
  torch.profiler;
- the main path (HDG IMEX SSP2, Taylor-Green, 256^2, k=2, float32, dt =
  1/256): s/step over 3 steps after a warm-up step, each ended by
  ``torch.cuda.synchronize()``, the iteration counts, and the device time
  per step of K2 and K3 (and of all kernels) from ``torch.profiler`` over
  one more step.

Usage:  python incompressibleeulerhdg_tpu_torch/tools/ab_cross_patch.py --root DIR [--label L]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

NX, DEGREE, REPS, STEPS = 256, 2, 20, 3
PROFILER_ATTEMPTS = 3


def device_ms(fn, reps=REPS, match=None):
    """Device milliseconds per call of ``fn()``; see ``device_time``."""
    return device_time(fn, reps, match)[0]


def device_time(fn, reps=REPS, match=None, attempts=PROFILER_ATTEMPTS):
    """(milliseconds per call of ``fn()``, timer).  The timer is
    "profiler": the summed device durations of the kernels ``fn`` runs
    (those whose name contains ``match``, or all), from torch.profiler over
    ``reps`` calls after a warm-up call.  A CUDA-event interval around one
    call would also count the host's launch time when that exceeds the
    kernel's, as it does for a kernel of a few tens of microseconds behind a
    Python wrapper.  A profiler session now and then records no device time
    for the kernels asked for; such a session is repeated, and after
    ``attempts`` empty sessions the timer is "cuda events": one event pair
    around ``reps`` back-to-back calls, which counts every kernel of ``fn``
    and any gap between them."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        us = _profiled_us(fn, reps, match)
        if us > 0:
            return us / 1e3 / reps, "profiler"
        print(f"# device_time: profiler session {attempt + 1} of {attempts} recorded no "
              f"device time{' for ' + match if match else ''}", file=sys.stderr, flush=True)
    return _events_ms(fn, reps), "cuda events"


def _profiled_us(fn, reps, match):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_self_device_us(ev) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and (match is None or match in ev.key))


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


def device_ms_by_kernel(fn):
    """Device ms of K2, K3 and all kernels during ``fn()`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    k2 = k3 = total = 0.0
    n = 0
    for ev in prof.key_averages():
        us = _self_device_us(ev)
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        total += us
        n += ev.count
        if "cross_pair_kernel" in ev.key:
            k2 += us
        elif "patch_solve_kernel" in ev.key:
            k3 += us
    return {"k2_device_ms": k2 / 1e3, "k3_device_ms": k3 / 1e3, "device_ms": total / 1e3,
            "device_events": n}


def main_path():
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh
    from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen
    from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )

    dt = 1.0 / NX
    disc = HDGDiscretisation(unit_square_mesh(NX), DEGREE, dtype=torch.float32, device="cuda")
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
    problem = TaylorGreen(disc)
    f_rhs = problem.f_rhs()
    state = stepper.initial_state(*problem.initial_condition())
    state = stepper.step(*state, 0.0, f_rhs)[:3]
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, counts = [], None
    for k in range(STEPS):
        t0 = time.perf_counter()
        *state, counts = stepper.step(*state, (k + 1) * dt, f_rhs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {n: v / STEPS for n, v in kernels.LAUNCHES.items()}
    prof = device_ms_by_kernel(lambda: stepper.step(*state, (STEPS + 1) * dt, f_rhs))
    return {"s_per_step": sum(times) / STEPS, "steps_s": times,
            "tentative": counts["tentative"], "pressure": counts["pressure"],
            "final": counts["final_pressure"], "recon": counts["reconstruction"],
            "launches_per_step": launches, **prof}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="tree whose port is measured")
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_cross_patch: needs a CUDA card (torch.cuda.is_available() is False)")
    sys.path.insert(0, args.root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import incompressibleeulerhdg_tpu_torch as port
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as P

    t0 = time.perf_counter()
    for name in ("cross_pair", "patch_solve"):
        kernels._get(name)
    build_s = time.perf_counter() - t0
    res = {"label": args.label, "package": port.__file__, "build_s": build_s,
           **kernel_times(P), **main_path(), "card": torch.cuda.get_device_name(0)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
