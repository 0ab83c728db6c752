"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own lines:

1. device check: a CUDA card is required (exit 1 otherwise); prints the
   card's name and power limit and pins float32 matmuls/convolutions to full
   float32 (no TF32);
2. kernel build: compiles the CUDA kernels of incompressibleeulerhdg_tpu_torch/csrc
   with nvcc (timed);
3. each kernel K1-K4 against its plain PyTorch version on the card, at the
   main path's shapes (256^2, k=2), in float32 and float64, with a nonzero
   colour offset and a colour size that is not a multiple of the thread
   block; prints the errors and the median CUDA-event time of both;
4. the main path: HDG IMEX SSP2(3,3,2), Richardson + projection, Taylor-Green
   vortex, 256^2 unit-square mesh, k=2, float32, dt = 1/256 -- set-up,
   initial trace, one warm-up step and three timed steps; validates
   finiteness, the L2 errors against the analytic vortex, the Krylov
   iteration counts, and that every kernel launched during the run.

The line before last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before it.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NX = 256
DEGREE = 2
N_STEPS = 3
ERROR_VELOCITY_MAX = 1.0e-4
ERROR_PRESSURE_MAX = 1.0e-2
TOL = {torch.float32: 1.0e-4, torch.float64: 1.0e-11}
TOL_GJ_F32_ABS = 5.0e-5  # tests/test_linalg.py's tolerance on well-conditioned blocks
REPS = 20


def fail(msg):
    print(f"# FAILED: {msg}", flush=True)
    sys.exit(1)


def device_check():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"# tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    return card


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timed runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def main_shapes(nx):
    """Field sizes and colour bounds of the nx^2 unit-square mesh (the three
    interior colours hold nx^2 and twice nx (nx - 1) facets)."""
    nc = 2 * nx * nx
    nf = 3 * nx * nx + 2 * nx
    bounds = (0, nx * nx, nx * nx + nx * (nx - 1), nx * nx + 2 * nx * (nx - 1))
    return nc, nf, bounds


def compare_kernels():
    """Phase 3: every kernel against its plain version at main-path shapes."""
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as P
    from incompressibleeulerhdg_tpu_torch.linalg import smallinv

    nc, nf, b = main_shapes(NX)
    d1 = (DEGREE + 2) * (DEGREE + 3) // 2
    nu = 2 * d1
    nch = nc // 2
    k = 1  # a colour with a nonzero offset
    b0, m_col = b[k], b[k + 1] - b[k]
    m_odd = m_col - 37  # not a multiple of the 128-thread block
    rng = np.random.default_rng(2024)
    dev = torch.device("cuda:0")
    results = {}

    def rnd(*shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    def check(name, dtype, got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        rel = abs_err / scale
        ok = rel <= TOL[dtype]
        if name == "gauss_jordan" and dtype == torch.float32:
            ok = ok and abs_err <= TOL_GJ_F32_ABS
        entry = results.setdefault(name, {"abs": {}, "rel": {}})
        key = str(dtype).replace("torch.", "")
        entry["abs"][key] = max(entry["abs"].get(key, 0.0), abs_err)
        entry["rel"][key] = max(entry["rel"].get(key, 0.0), rel)
        if not ok:
            fail(f"{name} {key}: max abs err {abs_err:.3e}, max rel err {rel:.3e}")

    timings = {}
    for dtype in (torch.float64, torch.float32):
        A = rnd(d1, d1, nc, dtype=dtype)
        Pc = rnd(2, nu, nu, dtype=dtype)
        xc = rnd(nu, nc, dtype=dtype)
        K01 = rnd(d1, d1, nf, dtype=dtype)
        K10 = rnd(d1, d1, nf, dtype=dtype)
        Bp = rnd(3, nu, nu, dtype=dtype)
        Cp = rnd(3, nu, nu, dtype=dtype)
        x0 = rnd(nu, nf, dtype=dtype)
        x1 = rnd(nu, nf, dtype=dtype)
        Di = rnd(nu, nu, nf, dtype=dtype)
        Si = rnd(nu, nu, nf, dtype=dtype)
        Bk = rnd(nu, nu, dtype=dtype)
        Ck = rnd(nu, nu, dtype=dtype)
        r0 = rnd(nu, m_col, dtype=dtype)
        r1 = rnd(nu, m_col, dtype=dtype)
        G = (0.1 * rnd(nu, nu, nc, dtype=dtype)
             + 3.0 * torch.eye(nu, dtype=dtype, device=dev)[:, :, None])
        halves = (0, nch, nc)

        cases = {
            "fact_apply": [
                (lambda: P.fact_apply(A, Pc, halves, xc),
                 lambda: P.fact_apply_plain(A, Pc, halves, xc)),
                (lambda: P.fact_apply(K01, Bp[k:k + 1], (0, m_odd), x0[:, :m_odd], aoff=b0),
                 lambda: P.fact_apply_plain(K01, Bp[k:k + 1], (0, m_odd), x0[:, :m_odd], aoff=b0)),
            ],
            "cross_pair": [
                (lambda: P.cross_pair(K01, K10, Bp, Cp, b, x0, x1),
                 lambda: P.cross_pair_plain(K01, K10, Bp, Cp, b, x0, x1)),
                (lambda: P.cross_pair(K01, K10, Bp[k:k + 1], Cp[k:k + 1], (0, m_odd),
                                      x0[:, :m_odd], x1[:, :m_odd], aoff=b0),
                 lambda: P.cross_pair_plain(K01, K10, Bp[k:k + 1], Cp[k:k + 1], (0, m_odd),
                                            x0[:, :m_odd], x1[:, :m_odd], aoff=b0)),
            ],
            "patch_solve": [
                (lambda: P.patch_solve(Di, Si, K01, K10, Bk, Ck, r0, r1, b0),
                 lambda: P.patch_solve_plain(Di, Si, K01, K10, Bk, Ck, r0, r1, b0)),
                (lambda: P.patch_solve(Di, Si, K01, K10, Bk, Ck, r0[:, :m_odd], r1[:, :m_odd], b0),
                 lambda: P.patch_solve_plain(Di, Si, K01, K10, Bk, Ck, r0[:, :m_odd],
                                             r1[:, :m_odd], b0)),
            ],
            "gauss_jordan": [
                (lambda: smallinv.gauss_jordan_inv_bl(G),
                 lambda: smallinv.gauss_jordan_inv_plain(G)),
                (lambda: smallinv.gauss_jordan_inv_bl(G[:, :, :m_odd]),
                 lambda: smallinv.gauss_jordan_inv_plain(G[:, :, :m_odd])),
            ],
        }
        for name, pairs in cases.items():
            for kern, plain in pairs:
                check(name, dtype, kern(), plain())
            if dtype == torch.float32:
                # in turns: plain, kernel, kernel, plain
                kern, plain = pairs[0]
                t_p1, t_k1, t_k2, t_p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
                timings[name] = (min(t_k1, t_k2), min(t_p1, t_p2))
        del A, Pc, xc, K01, K10, Bp, Cp, x0, x1, Di, Si, G
        torch.cuda.empty_cache()

    rows = []
    for name in kernels.KERNELS:
        e = results[name]
        t_k, t_p = timings[name]
        print(f"# kernel {name}: rel err f32 {e['rel']['float32']:.3e} f64 "
              f"{e['rel']['float64']:.3e} | abs err f32 {e['abs']['float32']:.3e} | "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms (float32, main-path shape)",
              flush=True)
        rows.append(dict(
            name=name, route="cuda", source=kernels.source_path(name),
            replaces=kernels.KERNELS[name][2], max_abs_err=e["abs"]["float32"],
            max_rel_err_f64=e["rel"]["float64"], ms=t_k, plain_ms=t_p,
        ))
    return rows


def main_path(card):
    """Phase 4: the port's main path at 256^2, k=2, float32 on cuda:0."""
    from incompressibleeulerhdg_tpu_torch import kernels
    from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen
    from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )

    dtype = torch.float32
    dev = torch.device("cuda:0")
    dt = 1.0 / NX
    kernels.reset_launches()
    t0 = time.perf_counter()
    print(f"# mesh: building the {NX}^2 unit-square mesh", flush=True)
    mesh = unit_square_mesh(NX)
    print(f"# mesh: done in {time.perf_counter() - t0:.2f} s "
          f"({mesh.n_cells} cells, {mesh.n_facets} facets)", flush=True)
    disc = HDGDiscretisation(mesh, DEGREE, dtype=dtype, device=dev)
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
    problem = TaylorGreen(disc)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"# setup: {setup_s:.2f} s", flush=True)

    Q0, p0 = problem.initial_condition()
    f_rhs = problem.f_rhs()
    t0 = time.perf_counter()
    sQ, sp, sl = stepper.initial_state(Q0, p0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sQ, sp, sl, counts = stepper.step(sQ, sp, sl, 0.0, f_rhs)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    print(f"# init: {init_s:.3f} s | warm-up step: {warmup_s:.3f} s | iters "
          f"tentative={counts['tentative']} pressure={counts['pressure']}", flush=True)

    step_s = []
    all_counts = [counts]
    for k in range(N_STEPS):
        t0 = time.perf_counter()
        sQ, sp, sl, counts = stepper.step(sQ, sp, sl, (k + 1) * dt, f_rhs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        all_counts.append(counts)
    launches = dict(kernels.LAUNCHES)

    Q, p = sQ[0], sp[0]
    finite = bool(torch.isfinite(Q).all()) and bool(torch.isfinite(p).all())
    t_final = (1 + N_STEPS) * dt
    Q_exact, p_exact = problem.solution(t_final)
    err_vel = stepper.velocity_error_norm(Q, Q_exact)
    err_p = stepper.pressure_error_norm(p, p_exact)
    iters_ok = all(n > 0 for c in all_counts for n in c["tentative"] + c["pressure"])
    per_step = sum(step_s) / len(step_s)
    print(f"# main path 256^2 k=2 float32 SSP2: setup {setup_s:.2f} s, warm-up "
          f"{warmup_s:.3f} s, {per_step:.4f} s/step (steps {[round(s, 4) for s in step_s]}) | "
          f"iters tentative={counts['tentative']} pressure={counts['pressure']} "
          f"final={counts['final_pressure']} recon={counts['reconstruction']} "
          f"max relres {counts['max_relres']:.2e} | err velocity {err_vel:.3e} "
          f"pressure {err_p:.3e} | launches {launches} | card {card}", flush=True)
    if not finite:
        fail("non-finite state")
    if not (err_vel < ERROR_VELOCITY_MAX and err_p < ERROR_PRESSURE_MAX):
        fail(f"errors above bound: velocity {err_vel:.3e} pressure {err_p:.3e}")
    if not iters_ok:
        fail("a Krylov solve took zero iterations")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return launches


def main():
    root = Path(__file__).resolve().parent
    if not (root / "incompressibleeulerhdg_tpu_torch" / "csrc").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(root))
    card = device_check()

    from incompressibleeulerhdg_tpu_torch import kernels

    build_s = kernels.build_all()
    print(f"# kernel build: {build_s:.2f} s ({', '.join(kernels.KERNELS)})", flush=True)
    rows = compare_kernels()
    launches = main_path(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
