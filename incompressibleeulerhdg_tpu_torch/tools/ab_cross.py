"""The cross pair (K2's function) by K2, K2w and the cluster kernel, in one
process on a CUDA card: the A/B that decides which kernel the port's
dispatch takes at each width and dtype.

K2 (``csrc/cross_pair.cu``) stages a facet tile's two whole tables in
shared memory; the port instantiates it at d1 <= 21.  This tool compiles
K2's template at d1 = 21, 28 and 36 (from d1 = 45 its tables exceed a
block's shared memory) into its own library under ``build/ab_cross/``
(nvcc, the kernels' flags; a source that includes ``cross_pair.cu`` and
exports one more entry point), and times it beside K2w
(``csrc/wide_apply.cu``) and the cluster kernel
(``csrc/cross_pair_cluster.cu``, its plan from
``preconditioners.cross_pair_plan``) on the 128^2 mesh at d1 = 21, 28,
36, 45, in float32 and float64, on one colour (16,256 facets at offset
16,384) and on the full field (3 colours + the boundary tail), padded
tables.  Each result is held to ``cross_pair_plain`` and timed by device
time on a CUDA graph of the launches (``ab_cross_patch.graph_ms``) in
turns, the order reversed on every other turn, the median of five reads
kept (``ab_cross_patch.in_turns``).  It prints
one JSON line a width, dtype and kind, with the fastest kernel and the
one the port's dispatch takes.  ``chip_smoke.py`` calls
:func:`start_build`, :func:`load` and :func:`compare`.

With ``--sweep`` it times the cluster kernel instead under every plan
``cross_pair_plan`` admits, at the same widths, dtypes and kinds, each
held to the plain version: one JSON line a plan, the default plan marked.

``--widths 55,66,78,91`` sets the widths of either (K2 takes part only at
d1 = 21, 28, 36; ``chip_smoke.py`` runs both :data:`WIDTHS` and
:data:`WIDE_WIDTHS`, k = 8 .. 11, where K2w and K2c compete).

With ``--fact`` it also times K1's function at the same widths: the
kernel the dispatch takes (K1 to d1 = 36, K1w above) on the 128^2 cell
field (32,768 cells, two penalty segments, as the tentative matvec
launches it), in float32 and float64, held to ``fact_apply_plain`` and
timed by ``graph_ms`` (the median of five reads) beside the plain version
and the bytes bound: one JSON line a width and dtype.

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.ab_cross [--sweep] [--fact] [--widths W,...]
"""

import ctypes
import json
import subprocess
import sys

import torch

WIDTHS = (21, 28, 36, 45)
WIDE_WIDTHS = (55, 66, 78, 91)  # k = 8 .. 11: K2w against K2c
K2_WIDTHS = (21, 28, 36)  # K2's two tables of a tile fit a block's shared memory
DTYPES = (torch.float32, torch.float64)
KINDS = ("colour", "full")
NX = 128
REPS = 20
PLAIN_REPS = 3  # calls of the plain version a timing (not in turns)
NAMES = ("cross_pair", "cross_pair_wide", "cross_pair_cluster")  # K2, K2w, K2c

SOURCE = """#include "{csrc}/cross_pair.cu"

// K2 at the widths of the cross-pair A/B, whether or not the port's
// dispatch launches it there
IEHDG_EXPORT int iehdg_cross_pair_k2_ab(int device, int dtype, int d1, const void* K01,
                                        const void* K10, long long ldk, long long aoff,
                                        const void* Bp, const void* Cp,
                                        const long long* seg_bounds, int nseg, const void* x0,
                                        const void* x1, void* y0, void* y1, long long m,
                                        void* stream) {{
  if (nseg < 0 || nseg > IEHDG_MAX_SEG) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Segs seg = make_segs(seg_bounds, nseg);
  cudaStream_t st = (cudaStream_t)stream;
#define K2_AB(T, D1) \\
  if (d1 == D1) return launch<T, D1>(K01, K10, ldk, aoff, Bp, Cp, seg, x0, x1, y0, y1, m, st);
  if (dtype == 0) {{
    K2_AB(float, 21) K2_AB(float, 28) K2_AB(float, 36)
  }} else if (dtype == 1) {{
    K2_AB(double, 21) K2_AB(double, 28) K2_AB(double, 36)
  }}
#undef K2_AB
  return (int)cudaErrorInvalidValue;
}}
"""


def _paths():
    from ..kernels import _CSRC, BUILD_DIR

    out = BUILD_DIR.parent / "ab_cross"
    return _CSRC, out / "k2_ab.cu", out / "libk2_ab.so"


def start_build():
    """Start nvcc on K2 at d1 = 21, 28, 36; returns the process (see :func:`load`)."""
    from ..kernels import NVCC_FLAGS, NVCC_LIBS, _nvcc

    csrc, cu, so = _paths()
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(SOURCE.format(csrc=csrc))
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu), *NVCC_LIBS],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(proc):
    """Wait for :func:`start_build`'s nvcc; the library's entry point (raises
    RuntimeError with nvcc's report if the build failed)."""
    from ..kernels import KERNELS

    _, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"ab_cross: nvcc failed for K2 at d1 = {K2_WIDTHS}:\n{err}")
    fn = ctypes.CDLL(str(_paths()[2])).iehdg_cross_pair_k2_ab
    fn.argtypes = KERNELS["cross_pair"][1]
    fn.restype = ctypes.c_int
    return fn


def _field(d1, gen, dtype):
    """Both tables, penalty blocks and sides of the 128^2 mesh at width d1."""
    from ..linalg import preconditioners as P

    nu, nf = 2 * d1, 3 * NX * NX + 2 * NX
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=dtype, device="cuda:0")
    return (P.pad_table(rnd(d1, d1, nf)), P.pad_table(rnd(d1, d1, nf)), rnd(3, nu, nu),
            rnd(3, nu, nu), rnd(nu, nf), rnd(nu, nf))


def _case(field, kind):
    """(K01, K10, Bp, Cp, bounds, x0, x1, aoff) of one colour (colour 1) or
    of the full field (3 colours and the boundary tail)."""
    K01, K10, Bp, Cp, x0, x1 = field
    b = (0, NX * NX, NX * NX + NX * (NX - 1), NX * NX + 2 * NX * (NX - 1))
    if kind == "full":
        return K01, K10, Bp, Cp, b, x0, x1, 0
    m = b[2] - b[1]
    return (K01, K10, Bp[1:2], Cp[1:2], (0, m), x0[:, :m].contiguous(),
            x1[:, :m].contiguous(), b[1])


def _bound_ms(d1, m, nseg, dtype):
    """Each table, penalty block and side read once, each output written
    once, over 3.35 TB/s."""
    nu, size = 2 * d1, torch.empty((), dtype=dtype).element_size()
    return size * (2 * d1 * d1 * m + 2 * nseg * nu * nu + 4 * nu * m) / 3.35e12 * 1e3


def runner(name, case, k2=None, plan=None):
    """A call of kernel ``name`` on ``case`` through its C entry point (K2
    through the A/B library's, the cluster kernel under ``plan``):
    returns (y0, y1)."""
    from .. import kernels

    K01, K10, Bp, Cp, b, x0, x1, aoff = case
    code = kernels.dtype_code(x0.dtype)
    d1, m = K01.shape[0], x0.shape[1]
    seg, nseg = kernels.seg_array(b)
    head = {"cross_pair_cluster": lambda p: (p["F"], p["CS"], p["threads"], p["smem_bytes"])}

    def run():
        y0, y1 = torch.empty_like(x0), torch.empty_like(x0)
        args = (0, code, d1, *(head[name](plan) if name in head else ()), K01.data_ptr(),
                K10.data_ptr(), K01.stride(1), aoff, Bp.data_ptr(), Cp.data_ptr(), seg, nseg,
                x0.data_ptr(), x1.data_ptr(), y0.data_ptr(), y1.data_ptr(), m,
                kernels.stream_ptr(x0))
        if name == "cross_pair":
            err = k2(*args)
            if err:
                raise RuntimeError(f"ab_cross: K2 at d1 = {d1} failed to launch ({err})")
        else:
            kernels.launch(name, *args)
        return y0, y1

    return run


def _rel_err(got, ref):
    return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


def compare(k2, widths=WIDTHS, reps=REPS, reads=None):
    """K2 (the entry point :func:`load` returns, at d1 <= 36; None leaves it
    out), K2w and the cluster kernel at each width, dtype and kind: errors against the plain
    version, device ms per launch of each (the median of its reads in
    turns), the plain version's ms (CUDA events, ``plain_ms``),
    the bytes bound, the fastest kernel and the kernel the dispatch takes;
    ``reads``: each kernel's reads in turns (default ``in_turns``'s).
    Returns one dict a width, dtype and kind."""
    from ..linalg import preconditioners as P
    from .ab_cross_patch import graph_ms, in_turns, plain_ms

    gen = torch.Generator(device="cuda:0").manual_seed(2030)
    rows = []
    for dtype in DTYPES:
        for d1 in widths:
            field = _field(d1, gen, dtype)
            for kind in KINDS:
                case = _case(field, kind)
                m, nseg = case[5].shape[1], len(case[4]) - 1
                ref = P.cross_pair_plain(*case[:7], aoff=case[7])
                here = [n for n in NAMES
                        if n != "cross_pair" or (k2 is not None and d1 in K2_WIDTHS)]
                plan = P.cross_pair_plan(d1, dtype)
                runs = {n: runner(n, case, k2, plan) for n in here}
                err = {n: _rel_err(run(), ref) for n, run in runs.items()}
                err["dispatch"] = _rel_err(P.cross_pair(*case[:7], aoff=case[7]), ref)
                best, ms = in_turns(runs, lambda run: graph_ms(run, reps),
                                    **({"reads": reads} if reads else {}))
                plain = plain_ms(lambda: P.cross_pair_plain(*case[:7], aoff=case[7]), PLAIN_REPS)
                rows.append({"d1": d1, "dtype": str(dtype).replace("torch.", ""), "kind": kind,
                             "m": m, "nseg": nseg, "plain_ms": plain,
                             **{f"{n}_ms": best[n] for n in here},
                             **{f"{n}_reads": ms[n] for n in here},
                             **{f"{n}_rel_err": err[n] for n in here},
                             "dispatch_rel_err": err["dispatch"],
                             "bound_ms": _bound_ms(d1, m, nseg, dtype),
                             "fastest": min(best, key=best.get),
                             "dispatch": P.width_kernels(d1, dtype)[1], "plan": plan})
                del case, ref, runs
            del field
            torch.cuda.empty_cache()
    return rows


def fact_rows(widths, reps=REPS):
    """K1's function by the dispatch's kernel at each width and dtype on the
    128^2 cell field: its error against the plain version, device ms a
    launch (the median of five ``graph_ms`` reads), the plain version's ms
    and the bytes bound.  Returns one dict a width and dtype."""
    import statistics

    from ..linalg import preconditioners as P
    from .ab_cross_patch import graph_ms, plain_ms

    gen = torch.Generator(device="cuda:0").manual_seed(2031)
    nc, nch = 2 * NX * NX, NX * NX
    rows = []
    for dtype in DTYPES:
        size = torch.empty((), dtype=dtype).element_size()
        for d1 in widths:
            nu = 2 * d1
            rnd = lambda *s: torch.randn(*s, generator=gen, dtype=dtype, device="cuda:0")
            A, Pc, x = rnd(d1, d1, nc), rnd(2, nu, nu), rnd(nu, nc)
            bounds = (0, nch, nc)
            ref = P.fact_apply_plain(A, Pc, bounds, x)
            got = P.fact_apply(A, Pc, bounds, x)
            err = float((got - ref).abs().max() / ref.abs().max())
            ms = statistics.median(graph_ms(lambda: P.fact_apply(A, Pc, bounds, x), reps)
                                   for _ in range(5))
            nbytes = size * (d1 * d1 * nc + 2 * nu * nu + 2 * nu * nc)
            rows.append({"kernel": P.width_kernels(d1, dtype)[0], "d1": d1,
                         "dtype": str(dtype).replace("torch.", ""), "m": nc, "ms": ms,
                         "plain_ms": plain_ms(lambda: P.fact_apply_plain(A, Pc, bounds, x),
                                              PLAIN_REPS),
                         "bound_ms": nbytes / 3.35e12 * 1e3, "rel_err": err})
            del A, Pc, x, ref, got
            torch.cuda.empty_cache()
    return rows


def _plans(d1, dtype):
    """Every plan the cluster kernel admits at d1."""
    from ..linalg import preconditioners as P

    size = torch.empty((), dtype=dtype).element_size()
    plans = []
    for rb in P.CROSS_CLUSTER_ROW_BYTES:
        for cs in range(1, P.CROSS_CLUSTER_MAX + 1):
            try:
                plans.append(P.cross_pair_plan(d1, dtype, F=rb // size, CS=cs))
            except NotImplementedError:
                pass
    return plans


def sweep(widths=WIDTHS, reps=REPS):
    """The cluster kernel under every admissible plan at each width, dtype
    and kind: one dict a plan."""
    from ..linalg import preconditioners as P
    from .ab_cross_patch import graph_ms

    gen = torch.Generator(device="cuda:0").manual_seed(2031)
    rows = []
    for dtype in DTYPES:
        for d1 in widths:
            field = _field(d1, gen, dtype)
            default = P.cross_pair_plan(d1, dtype)
            for kind in KINDS:
                case = _case(field, kind)
                m, nseg = case[5].shape[1], len(case[4]) - 1
                ref = P.cross_pair_plain(*case[:7], aoff=case[7])
                for p in _plans(d1, dtype):
                    run = runner("cross_pair_cluster", case, plan=p)
                    err = _rel_err(run(), ref)
                    ms = graph_ms(run, reps)
                    rows.append({"d1": d1, "dtype": str(dtype).replace("torch.", ""),
                                 "kind": kind, **p, "default": p == default, "ms": ms,
                                 "bound_ms": _bound_ms(d1, m, nseg, dtype), "rel_err": err})
                del case, ref
            del field
            torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_cross: needs a CUDA card (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    argv = sys.argv[1:]
    widths = WIDTHS
    if "--widths" in argv:
        widths = tuple(int(w) for w in argv[argv.index("--widths") + 1].split(","))
    if "--sweep" in argv:
        rows = sweep(widths)
    else:
        k2 = load(start_build()) if set(widths) & set(K2_WIDTHS) else None
        rows = compare(k2, widths)
    if "--fact" in argv:
        rows += fact_rows(widths)
    for row in rows:
        print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
