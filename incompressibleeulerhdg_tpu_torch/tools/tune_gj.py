"""Time launch plans of the register-tiled Gauss-Jordan template on a CUDA card.

K4 and K5 (``csrc/gauss_jordan.cu``, ``csrc/gauss_jordan_select.cu``) are
instantiations of ``gj_tile<T, N, R, C, BB>`` (``csrc/gauss_jordan.cuh``)
with the plan ``GjPlan<T, N>``.  This tool compiles other plans of the same
template into one library under ``build/tune_gj/`` (nvcc, the kernels'
flags), prints ptxas's registers and spills of each, holds each against
``gauss_jordan_inv_plain`` and times each by device time
(``ab_cross_patch.device_time``), in turns: every plan forward, then every
plan in reverse; the better of the two reads is kept.  Beside each plan it
times a copy kernel with the plan's map of threads to table entries and no
pivots (``copy_ms``): the least time of the plan's access pattern.  One
JSON line a plan.

With ``--team`` it compiles plans (N, BB, G) of K5's team design
(``gt_tile<T, N, BB, G>``, ``csrc/gauss_jordan_team.cuh``: BB teams a
thread block, G groups of BB blocks staged at once) into
``build/tune_gj/`` and times
each beside K5's variant 0 (PR 4's template, through the port's library)
on the same blocks, by CUDA-graph replays in turns
(``ab_cross_patch.graph_ms``, ``in_turns``), each held to the plain version,
and the same plan's staging alone and panels alone (``part``); one JSON line
a plan and part, with ptxas's registers and spills.

With ``--wide`` it times K5w (``csrc/gauss_jordan_wide.cu``), whose plan
is a run-time argument: every plan ``smallinv.wide_gj_plan`` admits for
the block size (an R x R tile of ``WIDE_GJ_TILES``, BB batch entries a
thread block, CS thread blocks a cluster; BB <= 2 on a cluster) through the
kernel's own library, each held to ``gauss_jordan_inv_plain`` on 64 blocks
and timed on the whole batch in turns, forward then reverse; one JSON line a
plan with the default plan marked, plus ``torch.linalg.inv`` on the same
blocks.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.tune_gj [--dtype float32]
        [--plan N,R,C,BB,MINB ...]
        python -m incompressibleeulerhdg_tpu_torch.tools.tune_gj --wide [N,BATCH ...]
        [--dtype float32]
        python -m incompressibleeulerhdg_tpu_torch.tools.tune_gj --team [N,BB,G ...]
        [--dtype float32]
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

# (N, R, C, BB, min thread blocks an SM for __launch_bounds__); the first
# plan of each N is GjPlan<float, N>
DEFAULT_PLANS = [
    (12, 6, 6, 32, 1), (12, 4, 4, 32, 1), (12, 6, 6, 16, 1), (12, 12, 6, 32, 1),
    (20, 10, 5, 32, 1), (20, 5, 5, 16, 1),
    (30, 8, 8, 16, 1), (30, 6, 6, 16, 1), (30, 6, 6, 8, 1), (30, 10, 6, 32, 1),
    (30, 10, 10, 16, 1), (30, 10, 5, 16, 1),
    (42, 7, 7, 8, 1), (42, 7, 7, 16, 1),
    (56, 8, 8, 8, 1), (56, 8, 8, 4, 1), (56, 7, 7, 8, 1), (56, 7, 7, 16, 1),
    (72, 8, 8, 4, 1), (72, 8, 8, 2, 1), (72, 9, 9, 4, 1), (72, 6, 6, 8, 1),
]
# own-cell batches: 256^2 at k = 1, 2, 3 (n = 12, 20, 30) and 128^2 at
# k = 4, 5, 6 (n = 42, 56, 72); any other N: 131072 blocks
BATCH = {12: 131072, 20: 131072, 30: 131072, 42: 32768, 56: 32768, 72: 32768}
TOL = {torch.float32: 5.0e-5, torch.float64: 1.0e-11}


def source(plans, T, header):
    cases = []
    for v, (N, R, C, BB, minb) in enumerate(plans):
        for w, kern in ((v, "tune_gj_kernel"), (len(plans) + v, "tune_copy_kernel")):
            cases.append(f"    case {w}: return gj_run<{T}, {N}, {R}, {C}, {BB}>("
                         f"{kern}<{T}, {N}, {R}, {C}, {BB}, {minb}>, A, out, n, B, st);")
    return f"""#include "{header}"

template <typename T, int N, int R, int C, int BB, int MINB>
__global__ void __launch_bounds__(GjShape<N, R, C, BB>::THREADS, MINB) tune_gj_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {{
  gj_tile<T, N, R, C, BB>(A, out, n, B);
}}

// gj_tile's loads and stores alone
template <typename T, int N, int R, int C, int BB, int MINB>
__global__ void __launch_bounds__(GjShape<N, R, C, BB>::THREADS, MINB) tune_copy_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {{
  using S = GjShape<N, R, C, BB>;
  const int pos = threadIdx.x / BB;
  const int i0 = pos / S::TC * R, j0 = pos % S::TC * C;
  const long long col = (long long)blockIdx.x * BB + threadIdx.x % BB;
  if (col >= B) return;
  T a[R][C];
#pragma unroll
  for (int li = 0; li < R; ++li)
#pragma unroll
    for (int lj = 0; lj < C; ++lj) {{
      const int i = i0 + li, j = j0 + lj;
      a[li][lj] = (i < n && j < n) ? A[((long long)i * n + j) * B + col] : T(0);
    }}
#pragma unroll
  for (int li = 0; li < R; ++li)
#pragma unroll
    for (int lj = 0; lj < C; ++lj) {{
      const int i = i0 + li, j = j0 + lj;
      if (i < n && j < n) out[((long long)i * n + j) * B + col] = a[li][lj];
    }}
}}

IEHDG_EXPORT int tune_gj(int variant, const void* A, void* out, int n, long long B, void* stream) {{
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {{
{chr(10).join(cases)}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""


def build(plans, T):
    """Compile the plans for scalar type ``T`` ("float" or "double") into one
    library; returns (ctypes function, ptxas registers and spill bytes keyed
    by (N, R, C, BB, MINB))."""
    from ..kernels import _CSRC, BUILD_DIR, NVCC_FLAGS, NVCC_LIBS, _nvcc

    out = BUILD_DIR.parent / "tune_gj"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "tune_gj.cu", out / "libtune_gj.so"
    cu.write_text(source(plans, T, _CSRC / "gauss_jordan.cuh"))
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu), *NVCC_LIBS],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"tune_gj: nvcc failed:\n{proc.stderr}")
    report, key = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+tune_gj_kernelI[fd]((?:Li\d+E)+)E", line)
        if m:
            key = tuple(map(int, re.findall(r"Li(\d+)E", m.group(1))))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key:
            report[key] = {"spill": int(m.group(1)) + int(m.group(2))}
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            report[key]["registers"] = int(m.group(1))
            key = None
    lib = ctypes.CDLL(str(so))
    fn = lib.tune_gj
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, report


# K5's team plans (N, BB, G) by dtype; the batch: 32768 blocks
TEAM_PLANS = {
    "float32": [(N, bb, g) for N in (42, 48, 56, 72) for bb, g in ((4, 1), (8, 1), (4, 2), (2, 4))],
    "float64": [(N, bb, g) for N in (42, 48, 56, 72) for bb, g in ((2, 1), (4, 1), (2, 2), (4, 2))],
}
TEAM_PARTS = ("inverse", "staging only", "panels only")  # gt_tile's MODE


def team_source(plans, T, header):
    cases = "\n".join(
        f"    case {v + k * len(plans)}: return run<{T}, {N}, {BB}, {G}, {k}>(A, out, n, B, st, "
        f"info);" for k in range(len(TEAM_PARTS)) for v, (N, BB, G) in enumerate(plans))
    return f"""#include "{header}"

template <typename T, int N, int BB, int G, int MODE>
__global__ void __launch_bounds__(GtShape<T, N, BB, G>::THREADS) tune_team_kernel(
    const T* __restrict__ A, T* __restrict__ out, int n, long long B) {{
  gt_tile<T, N, BB, G, MODE>(A, out, n, B);
}}

template <typename T, int N, int BB, int G, int MODE>
static int run(const void* A, void* out, int n, long long B, cudaStream_t st, int* info) {{
  using S = GtShape<T, N, BB, G>;
  if (info) {{
    info[0] = S::THREADS;
    info[1] = S::SMEM;
    return 0;
  }}
  static bool attr = false;
  return gt_launch<T, N, BB, G>(tune_team_kernel<T, N, BB, G, MODE>, attr, A, out, n, B, st);
}}

IEHDG_EXPORT int tune_team(int variant, const void* A, void* out, int n, long long B,
                           void* stream, int* info) {{
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""


def team(plans, dtype, card, batch=32768, reps=10):
    """Time every team plan beside K5's variant 0 at each plan's N."""
    from ..kernels import _CSRC, BUILD_DIR, NVCC_FLAGS, NVCC_LIBS, _nvcc, stream_ptr
    from ..linalg import smallinv
    from .ab_cross_patch import graph_ms, in_turns
    from .ab_gj import bound_ms, per_block_rel
    from .microbench_gj import diag_dominant

    # plans whose staged blocks pass a thread block's shared memory do not launch
    plans = [p for p in plans
             if smallinv.team_shape(*p[:1], dtype, *p[1:])["smem_bytes"] <= smallinv.SMEM_MAX]

    out_dir = BUILD_DIR.parent / "tune_gj"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "tune_team.cu", out_dir / f"libtune_team_{dtype}.so"
    T = "float" if dtype == torch.float32 else "double"
    cu.write_text(team_source(plans, T, _CSRC / "gauss_jordan_team.cuh"))
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu), *NVCC_LIBS],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"tune_gj: nvcc failed:\n{proc.stderr}")
    report, key = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+tune_team_kernelI[fd]((?:Li\d+E)+)E", line)
        if m:
            key = tuple(map(int, re.findall(r"Li(\d+)E", m.group(1))))
            key = key[:3] if key[3] == 0 else None  # the inverse (MODE 0) only
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key:
            report[key] = {"spill": int(m.group(1)) + int(m.group(2))}
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            report[key]["registers"] = int(m.group(1))
            key = None
    fn = ctypes.CDLL(str(so)).tune_team
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for N in sorted({p[0] for p in plans}):
        A = diag_dominant(N, batch, dtype, seed=N)
        ref = smallinv.gauss_jordan_inv_plain(A)
        runs = {"v0": lambda: smallinv.gauss_jordan_inv_select(A, variant=0)}
        for v, plan in enumerate(plans):
            if plan[0] != N:
                continue

            def launch(v=v, plan=plan):
                out = torch.empty_like(A)
                rc = fn(v, A.data_ptr(), out.data_ptr(), N, batch, stream_ptr(A), None)
                if rc:
                    raise RuntimeError(f"tune_gj: team plan {plan} failed to launch ({rc})")
                return out

            runs[plan] = launch
            for mode in range(1, len(TEAM_PARTS)):  # the staging alone, the panels alone
                def part(v=v, plan=plan, mode=mode):
                    out = torch.empty_like(A)
                    rc = fn(v + mode * len(plans), A.data_ptr(), out.data_ptr(), N, batch,
                            stream_ptr(A), None)
                    if rc:
                        raise RuntimeError(f"tune_gj: team plan {plan} mode {mode} failed ({rc})")
                    return out

                runs[(*plan, mode)] = part
        # the inverse's error (the parts' outputs are no inverse)
        errs = {k: per_block_rel(f(), ref) for k, f in runs.items() if k == "v0" or len(k) == 3}
        del ref
        ms, reads = in_turns(runs, lambda f: graph_ms(f, reps))
        t_b, by = bound_ms(N, batch, dtype)
        for k in runs:
            info = (ctypes.c_int * 2)()
            if k != "v0":
                fn(plans.index(k[:3]), None, None, N, 0, None, info)
            print(json.dumps({"N": N, "dtype": str(dtype).replace("torch.", ""), "batch": batch,
                              "plan": "variant 0" if k == "v0" else
                              {"N": N, "BB": k[1], "G": k[2],
                               "part": TEAM_PARTS[k[3] if len(k) == 4 else 0]},
                              "threads": info[0] if k != "v0" else None,
                              "smem_bytes": info[1] if k != "v0" else None,
                              "ms": ms[k], "reads": reads[k], "pct_bound": 100 * t_b / ms[k],
                              "bound_ms": t_b, "bound_by": by, "rel_err": errs.get(k),
                              **(report.get(k, {}) if k != "v0" and len(k) == 3 else {}),
                              "card": card}),
                  flush=True)
        del A
        torch.cuda.empty_cache()


# K5w's blocks: (n, batch) of the 128^2 own cells at k = 7, 8 (float32) and
# of 1024 k = 11 blocks (float64: the cluster path)
WIDE_DEFAULT = {"float32": [(90, 32768), (110, 32768)], "float64": [(182, 1024)]}
# the H100's peak FLOP/s for float32 outside the tensor cores and float64
# through them (NVIDIA's data sheet, 700 W): the operations bound of K5w
PEAK_FLOPS = 67e12


def wide(sizes, dtype, card):
    """Time every admissible K5w plan at each (n, batch) of ``sizes``."""
    from .. import kernels
    from ..linalg import smallinv
    from .ab_cross_patch import device_time
    from .microbench_gj import diag_dominant

    for n, batch in sizes:
        A = diag_dominant(n, batch, dtype, seed=n)
        ref = smallinv.gauss_jordan_inv_plain(A[:, :, :64])
        default = smallinv.wide_gj_plan(n, dtype)
        plans = []
        for R in smallinv.WIDE_GJ_TILES[dtype]:
            for CS in range(1, smallinv.WIDE_GJ_CLUSTER_MAX + 1):
                for BB in range(1, (smallinv.WIDE_GJ_BB_MAX if CS == 1 else 2) + 1):
                    try:
                        plans.append(smallinv.wide_gj_plan(n, dtype, R=R, BB=BB, CS=CS))
                    except ValueError:
                        pass

        def launch(p, X):
            out = torch.empty_like(X)
            kernels.launch("gauss_jordan_wide", X.device.index, kernels.dtype_code(dtype), n,
                           X.data_ptr(), out.data_ptr(), X.shape[2], 0, p["R"], p["BB"],
                           p["CS"], p["threads"], p["smem_bytes"], kernels.stream_ptr(X))
            return out

        times = {}
        for order in (plans, plans[::-1]):
            for p in order:
                times.setdefault(id(p), []).append(
                    device_time(lambda: launch(p, A), 3, match="gauss_jordan_wide")[0])
        lib = device_time(lambda: torch.linalg.inv(A.permute(2, 0, 1)), 3)[0]
        flops = 2 * n ** 3 * batch
        for p in plans:
            err = float((launch(p, A[:, :, :64].contiguous()) - ref).abs().max())
            ms = min(times[id(p)])
            print(json.dumps({"n": n, "batch": batch, "dtype": str(dtype).replace("torch.", ""),
                              **{k: p[k] for k in ("path", "R", "BB", "CS", "threads")},
                              "default": all(p[k] == default[k] for k in ("R", "BB", "CS")),
                              "ms": ms, "ms_reads": times[id(p)], "library_ms": lib,
                              "pct_ops_bound": 100 * flops / PEAK_FLOPS * 1e3 / ms,
                              "max_abs_err": err, "card": card}), flush=True)
        del A
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    parser.add_argument("--plan", action="append", default=[],
                        help="N,R,C,BB,MINB (repeatable; default: a built-in list)")
    parser.add_argument("--wide", nargs="*", default=None, metavar="N,BATCH",
                        help="time K5w's plans (default sizes: the k = 7, 8 own cells at 128^2 "
                             "in float32, 1024 k = 11 blocks in float64)")
    parser.add_argument("--team", nargs="*", default=None, metavar="N,BB,G",
                        help="time K5's team plans beside its variant 0 (default: a built-in list)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tune_gj: needs a CUDA card (torch.cuda.is_available() is False)")
    if args.team is not None:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        plans = [tuple(int(v) for v in p.split(",")) for p in args.team] or TEAM_PLANS[args.dtype]
        team(plans, getattr(torch, args.dtype), card)
        return
    if args.wide is not None:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        sizes = [tuple(int(v) for v in w.split(",")) for w in args.wide] or WIDE_DEFAULT[args.dtype]
        wide(sizes, getattr(torch, args.dtype), card)
        return
    from ..kernels import stream_ptr
    from ..linalg.smallinv import gauss_jordan_inv_plain
    from .ab_cross_patch import device_time
    from .microbench_gj import diag_dominant

    plans = [tuple(int(v) for v in p.split(",")) for p in args.plan] or DEFAULT_PLANS
    dtype = getattr(torch, args.dtype)
    fn, report = build(plans, "float" if dtype == torch.float32 else "double")
    blocks, results = {}, {}
    for order in (plans, plans[::-1]):
        for plan in order:
            N = plan[0]
            if N not in blocks:
                A = diag_dominant(N, BATCH.get(N, 131072), dtype, seed=N)
                blocks[N] = (A, gauss_jordan_inv_plain(A))
            A, ref = blocks[N]
            v = plans.index(plan)

            def launch(w):
                out = torch.empty_like(A)
                rc = fn(w, A.data_ptr(), out.data_ptr(), N, A.shape[2], stream_ptr(A))
                if rc:
                    raise RuntimeError(f"tune_gj: plan {plan} failed to launch ({rc})")
                return out

            err = float((launch(v) - ref).abs().max())
            ms, timer = device_time(lambda: launch(v), match="tune_gj_kernel")
            copy_ms, _ = device_time(lambda: launch(len(plans) + v), match="tune_copy_kernel")
            r = results.setdefault(plan, {"ms": [], "copy_ms": [], "err": err, "timer": timer})
            r["ms"].append(ms)
            r["copy_ms"].append(copy_ms)
            r["err"] = max(r["err"], err)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for plan in plans:
        N, R, C, BB, minb = plan
        r = results[plan]
        info = report.get(plan, {})
        print(json.dumps({"N": N, "R": R, "C": C, "BB": BB, "minb": minb, "dtype": args.dtype,
                          "batch": blocks[N][0].shape[2], "ms": min(r["ms"]), "ms_reads": r["ms"],
                          "copy_ms": min(r["copy_ms"]),
                          "timer": r["timer"], "max_abs_err": r["err"], "ok": r["err"] <= TOL[dtype],
                          **info, "card": card}), flush=True)


if __name__ == "__main__":
    main()
