"""One-process A/Bs of the Gauss-Jordan kernels the port chooses between, on a CUDA card.

- ``select``: K5's two variants (``csrc/gauss_jordan_select.cu``: 0, PR 4's
  register-tiled template; 1, the team design of
  ``csrc/gauss_jordan_team.cuh``) at n = 42, 48, 56, 72 on 32,768 blocks
  (the 128^2 own cells of k = 4, 5, 6), float32 and float64, with
  ``torch.linalg.inv`` on the same blocks beside them;
- ``wide``: K5w's register-tile or cluster plan against K5b (the blocked
  path, ``gauss_jordan_blocked``) at float64 n = 182 (1,024 blocks, the
  cluster path) and float32 n = 110 (32,768 blocks);
- ``library``: K5b against ``torch.linalg.inv_ex`` on the same blocks at
  float64 n = 420 and float32 n = 552 (32 blocks each: k = 18, 21), where no
  cluster of 8 holds a block.

Each kernel is held per block to ``gauss_jordan_inv_plain`` on the same
blocks (diagonally dominant, 0.1 N(0, 1) + 3 I from a numpy seed; a
float32 ``wide`` row also gives the plain version's own error against the
float64 plain inverse, ``plain_f32_vs_f64``) and timed
by CUDA events around replays of a CUDA graph of its launches
(``ab_cross_patch.graph_ms``), the median of its reads in turns
(``ab_cross_patch.in_turns``; three in ``select`` and ``wide``, five in
``library``); the library call the same way where a graph
captures it, else by CUDA events around eager calls.  Each row names the
kernel or variant the port's dispatch takes (``smallinv.select_variant``,
``smallinv.wide_gj_plan``); chip_smoke.py fails where that is the slower.

With ``--sweep`` it times K5b under each workspace budget at the
``library`` shapes instead.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.ab_gj [select|wide|library ...]
        [--sweep]
"""

import json
import subprocess
import sys

import torch

SELECT_N = (42, 48, 56, 72)
SELECT_BATCH = 32768
WIDE_CASES = ((182, torch.float64, 1024), (110, torch.float32, 32768))
LIBRARY_CASES = ((420, torch.float64, 32), (552, torch.float32, 32))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12  # float32 outside the tensor cores, float64 through them (DMMA)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def bound_ms(n, batch, dtype):
    """(bound ms, "bytes" or "operations") of inverting ``batch`` (n, n)
    blocks: each entry read and written once, n^3 FMAs a block."""
    size = torch.empty((), dtype=dtype).element_size()
    t_b = 2 * n * n * batch * size / HBM_BYTES_PER_S * 1e3
    t_o = 2 * n ** 3 * batch / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def per_block_rel(got, ref):
    """Largest over the batch-last blocks of each block's error relative to
    its largest entry."""
    return float(((got - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max())


def library_ms(fn, reps=5):
    """Device ms of one call of ``fn`` on a CUDA graph, or by CUDA events
    around eager calls where the graph does not capture it: (ms, timer)."""
    from .ab_cross_patch import _events_ms, graph_ms

    try:
        return graph_ms(fn, reps), "cuda-graph"
    except RuntimeError:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        return _events_ms(fn, reps), "cuda-events"


def _blocks(n, batch, dtype, seed):
    from .microbench_gj import diag_dominant

    return diag_dominant(n, batch, dtype, seed=seed)


def compare_select(ns=SELECT_N, dtypes=(torch.float32, torch.float64), batch=SELECT_BATCH,
                   reps=5, reads=3):
    """K5's variants 0 and 1 at each n and dtype: per-block errors against
    the plain version, device ms (median of reads in turns), one
    ``torch.linalg.inv`` on the same blocks (``library_ms``: CUDA events,
    not in turns),
    the bytes bound, the faster variant and the dispatch's.  One dict a
    case."""
    from ..linalg import smallinv
    from .ab_cross_patch import graph_ms, in_turns, plain_ms

    rows = []
    for dtype in dtypes:
        for n in ns:
            A = _blocks(n, batch, dtype, seed=n)
            ref = smallinv.gauss_jordan_inv_plain(A)
            runs = {v: (lambda v=v: smallinv.gauss_jordan_inv_select(A, variant=v))
                    for v in (0, 1)}
            err = {v: per_block_rel(runs[v](), ref) for v in runs}
            del ref
            ms, got = in_turns(runs, lambda run: graph_ms(run, reps), reads)
            # CUDA events: a graph capture of torch.linalg.inv fails on its
            # error check, and a failed capture keeps its memory pool
            lib = plain_ms(lambda: torch.linalg.inv(A.permute(2, 0, 1)), 2)
            t_b, by = bound_ms(n, batch, dtype)
            rows.append({"n": n, "batch": batch, "dtype": _name(dtype),
                         "library_ms": lib,
                         "v0_ms": ms[0], "v1_ms": ms[1], "v0_reads": got[0],
                         "v1_reads": got[1], "v0_rel_err": err[0], "v1_rel_err": err[1],
                         "bound_ms": t_b, "bound_by": by,
                         "faster": 0 if ms[0] <= ms[1] else 1,
                         "dispatch": smallinv.select_variant(n, dtype),
                         "plans": [smallinv.launch_plan("gauss_jordan_select", dtype, n, v)
                                   for v in (0, 1)]})
            del A
            torch.cuda.empty_cache()
    return rows


def compare_wide(cases=WIDE_CASES, reps=5, reads=3):
    """K5w's register-tile or cluster plan against K5b at each (n, dtype,
    batch): errors, device ms in turns, the bound, the faster and the
    dispatch's path.  One dict a case."""
    from .. import kernels
    from ..linalg import smallinv
    from .ab_cross_patch import graph_ms, in_turns

    rows = []
    for n, dtype, batch in cases:
        A = _blocks(n, batch, dtype, seed=n)
        ref = smallinv.gauss_jordan_inv_plain(A)
        tp = smallinv.register_plan(n, dtype)

        def tiles():
            out = torch.empty_like(A)
            kernels.launch("gauss_jordan_wide", A.device.index, kernels.dtype_code(dtype), n,
                           A.data_ptr(), out.data_ptr(), batch, 0, tp["R"], tp["BB"], tp["CS"],
                           tp["threads"], tp["smem_bytes"], kernels.stream_ptr(A))
            return out

        runs = {tp["path"]: tiles, "blocked": lambda: smallinv.gauss_jordan_inv_blocked(A)}
        err = {k: per_block_rel(f(), ref) for k, f in runs.items()}
        own = (per_block_rel(ref.double(), smallinv.gauss_jordan_inv_plain(A.double()))
               if dtype == torch.float32 else 0.0)
        del ref
        ms, got = in_turns(runs, lambda run: graph_ms(run, reps), reads)
        t_b, by = bound_ms(n, batch, dtype)
        rows.append({"n": n, "batch": batch, "dtype": _name(dtype),
                     "tiles_path": tp["path"], "tiles_ms": ms[tp["path"]],
                     "blocked_ms": ms["blocked"], "tiles_reads": got[tp["path"]],
                     "blocked_reads": got["blocked"], "tiles_rel_err": err[tp["path"]],
                     "blocked_rel_err": err["blocked"], "plain_f32_vs_f64": own,
                     "bound_ms": t_b, "bound_by": by,
                     "faster": "blocked" if ms["blocked"] < ms[tp["path"]] else tp["path"],
                     "dispatch": smallinv.wide_gj_plan(n, dtype)["path"],
                     "tiles_plan": tp, "blocked_plan": smallinv.blocked_plan(n, dtype)})
        del A
        torch.cuda.empty_cache()
    return rows


def compare_library(cases=LIBRARY_CASES, reps=5, plans=None):
    """K5b (under ``plans`` (b, workspace bytes), by default its own plan)
    against ``torch.linalg.inv_ex`` on the same (n, dtype, batch) blocks:
    errors against the plain version (and the blocked twin), device ms in
    turns, the operations bound.  One dict a case and plan."""
    from ..linalg import smallinv
    from .ab_cross_patch import graph_ms, in_turns

    rows = []
    for n, dtype, batch in cases:
        A = _blocks(n, batch, dtype, seed=n)
        ref = smallinv.gauss_jordan_inv_plain(A)
        twin = smallinv.gauss_jordan_inv_blocked_plain(A)
        Am = A.permute(2, 0, 1)
        lib, timer = library_ms(lambda: torch.linalg.inv_ex(Am)[0], reps)
        for b, ws in plans or [(None, None)]:
            p = smallinv.blocked_plan(n, dtype, b=b, ws_bytes=ws)
            run = lambda p=p: smallinv.gauss_jordan_inv_blocked(A, p)
            got = run()
            err, err_twin = per_block_rel(got, ref), per_block_rel(got, twin)
            ms, reads = in_turns({"blocked": run}, lambda f: graph_ms(f, reps))
            t_b, by = bound_ms(n, batch, dtype)
            rows.append({"n": n, "batch": batch, "dtype": _name(dtype), "plan": p,
                         "blocked_ms": ms["blocked"], "blocked_reads": reads["blocked"],
                         "library_ms": lib, "library_timer": timer, "rel_err": err,
                         "rel_err_twin": err_twin,
                         "plain_twin_rel_err": per_block_rel(twin, ref),
                         "bound_ms": t_b, "bound_by": by})
        del A, Am, ref, twin
        torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_gj: needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    argv = sys.argv[1:]
    parts = [a for a in argv if not a.startswith("--")] or ["select", "wide", "library"]
    rows = []
    if "--sweep" in argv:
        rows += compare_library(plans=[(None, ws) for ws in (16 << 20, 32 << 20, 64 << 20)])
    else:
        if "select" in parts:
            rows += compare_select()
        if "wide" in parts:
            rows += compare_wide()
        if "library" in parts:
            rows += compare_library()
    for row in rows:
        print(json.dumps({**row, "card": card}, default=str), flush=True)


if __name__ == "__main__":
    main()
