"""K3 against K3w at the widths K3w took over or may take (d1 = 21, 28, 36:
k = 4, 5, 6), in one process on a CUDA card.

K3 (``csrc/patch_solve.cu``) serves the narrow widths; the port's patch
solve launches K3w (``csrc/patch_solve_wide.cu``) at every width K3's
dispatch does not list.  This tool
compiles K3's template at d1 = 21, 28 and 36 into its own library under
``build/ab_patch/`` (nvcc, the kernels' flags; a source that includes
``patch_solve.cu`` and exports one more entry point), and times it beside
K3w (through its entry point, under its default plan) on one colour of
the 128^2 mesh (16,256 facets at offset 16,384, padded tables) in float32
and float64, both held to the plain version, as is the port's patch
solve, by device time on a CUDA graph of the launches
(``ab_cross_patch.graph_ms``) in turns, the median of five reads kept
(``ab_cross_patch.in_turns``).  It prints one JSON line a width and dtype, with the kernel the
port's dispatch takes.  ``chip_smoke.py`` calls :func:`start_build`,
:func:`load` and :func:`compare`.

With ``--sweep`` it times K3w instead under every plan
``preconditioners.patch_wide_plan`` admits at d1 = 21, 28, 36, 45, 55, 91,
105, 120 (each cluster plan (F, CS) and the plan without a cluster, CS =
0, at each F that fits; from d1 = 81 only the latter), in float32 and
float64, on the same colour, through the kernel's own entry point, each
held to the plain version: one JSON line a plan, the default plan marked.

With ``--sweep --bf16`` the sweep runs K3w's bfloat16-factor variant
(``patch_solve_wide_bf16``: float32 vectors, Dinv0 and Sinv in bfloat16,
as ``IEHDG_PC_BF16=1`` builds them) under every plan
``patch_wide_plan(d1, float32, factors=bfloat16)`` admits, float32 only.

``--widths 21,28`` restricts either to those widths.  From d1 = 105 in
float64 the four tables hold only the columns up to the colour's end
(their full 128^2 width, 49,408 columns, would take 57 GB).

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.ab_patch [--sweep [--bf16]] [--widths W,...]
"""

import ctypes
import json
import subprocess
import sys

import torch

WIDTHS = (21, 28, 36)
SWEEP_WIDTHS = (21, 28, 36, 45, 55, 91, 105, 120)
TABLE_BYTES_MAX = 40e9  # the four tables of _colour on the full 128^2 width, at most
DTYPES = (torch.float32, torch.float64)
NX = 128

SOURCE = """#include "{csrc}/patch_solve.cu"

// K3 at the widths of the patch-solve A/B, whether or not the port's
// dispatch launches it there
IEHDG_EXPORT int iehdg_patch_solve_k3_wide(int device, int dtype, int d1, const void* Di,
                                           const void* Si, const void* K01, const void* K10,
                                           long long ldt, long long off, const void* Bp,
                                           const void* Cp, const void* r0, const void* r1,
                                           void* y0, void* y1, long long m, void* stream) {{
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && d1 == 21)
    return launch<float, 21>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 0 && d1 == 28)
    return launch<float, 28>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 0 && d1 == 36)
    return launch<float, 36>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 1 && d1 == 21)
    return launch<double, 21>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 1 && d1 == 28)
    return launch<double, 28>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  if (dtype == 1 && d1 == 36)
    return launch<double, 36>(Di, Si, K01, K10, ldt, off, Bp, Cp, r0, r1, y0, y1, m, st);
  return (int)cudaErrorInvalidValue;
}}
"""


def _paths():
    from ..kernels import _CSRC, BUILD_DIR

    out = BUILD_DIR.parent / "ab_patch"
    return _CSRC, out / "k3_wide.cu", out / "libk3_wide.so"


def start_build():
    """Start nvcc on K3 at d1 = 21, 28, 36; returns the process (see :func:`load`)."""
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
        raise RuntimeError(f"ab_patch: nvcc failed for K3 at d1 = {WIDTHS}:\n{err}")
    fn = ctypes.CDLL(str(_paths()[2])).iehdg_patch_solve_k3_wide
    fn.argtypes = KERNELS["patch_solve"][1]
    fn.restype = ctypes.c_int
    return fn


def _colour(d1, gen, dtype, factors=None):
    """The tables and sides of one 128^2 colour at width d1: tables of the
    mesh's nf facet columns, or of the columns up to the colour's end where
    those would exceed TABLE_BYTES_MAX; with ``factors`` (bfloat16) Dinv0
    and Sinv cast to it, each with its own padded stride."""
    from ..linalg import preconditioners as P

    nu, nf = 2 * d1, 3 * NX * NX + 2 * NX
    off, m = NX * NX, NX * (NX - 1)  # colour 1
    if (2 * nu * nu + 2 * d1 * d1) * nf * torch.empty((), dtype=dtype).element_size() > \
            TABLE_BYTES_MAX:
        nf = off + m
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=dtype, device="cuda:0")
    K01, K10 = P.pad_table(rnd(d1, d1, nf)), P.pad_table(rnd(d1, d1, nf))
    Di, Si = rnd(nu, nu, nf), rnd(nu, nu, nf)
    if factors is not None:
        Di, Si = Di.to(factors), Si.to(factors)
    Di, Si = P.pad_table(Di), P.pad_table(Si)
    return (Di, Si, K01, K10, rnd(nu, nu), rnd(nu, nu), rnd(nu, m), rnd(nu, m), off)


def _bound_ms(d1, m, dtype, factors=None):
    """Each table and side read once, each output written once (Dinv0 and
    Sinv at the size of ``factors``), over 3.35 TB/s."""
    nu, size = 2 * d1, torch.empty((), dtype=dtype).element_size()
    fsize = torch.empty((), dtype=factors or dtype).element_size()
    return (fsize * 2 * nu * nu * m + size * (2 * d1 * d1 * m + 2 * nu * nu + 4 * nu * m)) \
        / 3.35e12 * 1e3


def _plans(d1, dtype, factors=None):
    """Every plan K3w admits at d1: each cluster plan, then each F of the
    plan without a cluster."""
    from ..linalg import preconditioners as P

    size = torch.empty((), dtype=dtype).element_size()
    plans = []
    for rb in P.PATCH_WIDE_ROW_BYTES:
        for cs in range(1, P.PATCH_WIDE_CLUSTER_MAX + 1):
            try:
                plans.append(P.patch_wide_plan(d1, dtype, F=rb // size, CS=cs, factors=factors))
            except NotImplementedError:
                pass
    for f in P.PATCH_WIDE_DEV_FACETS:
        try:
            plans.append(P.patch_wide_plan(d1, dtype, F=f, CS=0, factors=factors))
        except NotImplementedError:
            pass
    return plans


def _k3w_runner(args, p):
    """A call of K3w under plan ``p`` on ``args`` (``_colour``'s) through
    its C entry point (its bfloat16-factor variant where Dinv0 is
    bfloat16): returns (y0, y1)."""
    from .. import kernels

    Di, Si, K01, K10, Bk, Ck, r0, r1, off = args
    code = kernels.dtype_code(r0.dtype, Di.dtype)
    d1, m = K01.shape[0], r0.shape[1]
    name, ld = ("patch_solve_wide_bf16", (Di.stride(1), K01.stride(1))) if code == 2 else \
        ("patch_solve_wide", (K01.stride(1),))

    def run():
        y0, y1 = torch.empty_like(r0), torch.empty_like(r0)
        kernels.launch(name, 0, code, d1, p["F"], p["CS"], p["threads"],
                       p["smem_bytes"], Di.data_ptr(), Si.data_ptr(), K01.data_ptr(),
                       K10.data_ptr(), *ld, off, Bk.data_ptr(), Ck.data_ptr(),
                       r0.data_ptr(), r1.data_ptr(), y0.data_ptr(), y1.data_ptr(), m,
                       kernels.stream_ptr(r0))
        return y0, y1

    return run


def _rel_err(got, ref):
    return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


def sweep(widths=SWEEP_WIDTHS, reps=10, factors=None):
    """K3w under every admissible plan at each width and dtype (float32
    alone with bfloat16 ``factors``): one dict a plan."""
    from ..linalg import preconditioners as P
    from .ab_cross_patch import graph_ms

    gen = torch.Generator(device="cuda:0").manual_seed(2029)
    rows = []
    for dtype in DTYPES if factors is None else (torch.float32,):
        for d1 in widths:
            args = _colour(d1, gen, dtype, factors)
            m = args[6].shape[1]
            ref = P.patch_solve_plain(*args)
            default = P.patch_wide_plan(d1, dtype, factors=factors)
            for p in _plans(d1, dtype, factors):
                run = _k3w_runner(args, p)
                err = _rel_err(run(), ref)
                ms = graph_ms(run, reps)
                rows.append({"d1": d1, "dtype": str(dtype).replace("torch.", ""),
                             "factors": str(factors or dtype).replace("torch.", ""), **p,
                             "default": p == default, "ms": ms,
                             "bound_ms": _bound_ms(d1, m, dtype, factors), "rel_err": err})
            del args, ref
            torch.cuda.empty_cache()
    return rows


def compare(k3, widths=WIDTHS, reps=20, reads=None):
    """K3 (the entry point :func:`load` returns) and K3w (through its entry
    point, under its default plan) at each of ``widths`` on one colour of
    the 128^2 mesh, in float32 and float64: errors against the plain
    version (and the error of the port's patch solve), device ms per launch
    of each (the median of its ``reads`` in turns, default ``in_turns``'s),
    the bytes bound, and the kernel the dispatch takes.  Returns one dict a
    width and dtype."""
    from .. import kernels
    from ..linalg import preconditioners as P
    from .ab_cross_patch import graph_ms, in_turns

    gen = torch.Generator(device="cuda:0").manual_seed(2028)
    rows = []
    for dtype in DTYPES:
        code = kernels.dtype_code(dtype)
        for d1 in widths:
            args = _colour(d1, gen, dtype)
            Di, Si, K01, K10, Bk, Ck, r0, r1, off = args
            m = r0.shape[1]

            def run_k3():
                y0, y1 = torch.empty_like(r0), torch.empty_like(r0)
                err = k3(0, code, d1, Di.data_ptr(), Si.data_ptr(), K01.data_ptr(),
                         K10.data_ptr(), K01.stride(1), off, Bk.data_ptr(), Ck.data_ptr(),
                         r0.data_ptr(), r1.data_ptr(), y0.data_ptr(), y1.data_ptr(), m,
                         kernels.stream_ptr(r0))
                if err:
                    raise RuntimeError(f"ab_patch: K3 at d1 = {d1} ({dtype}) failed to launch "
                                       f"({err})")
                return y0, y1

            ref = P.patch_solve_plain(*args)
            plan = P.patch_wide_plan(d1, dtype)
            k3w = _k3w_runner(args, plan)
            e3, ew, ed = _rel_err(run_k3(), ref), _rel_err(k3w(), ref), \
                _rel_err(P.patch_solve(*args), ref)
            ms, got = in_turns({"k3": run_k3, "k3w": k3w}, lambda run: graph_ms(run, reps),
                               **({"reads": reads} if reads else {}))
            rows.append({"d1": d1, "dtype": str(dtype).replace("torch.", ""), "m": m,
                         "k3_ms": ms["k3"], "k3w_ms": ms["k3w"],
                         "k3_reads": got["k3"], "k3w_reads": got["k3w"], "k3_rel_err": e3,
                         "k3w_rel_err": ew, "dispatch_rel_err": ed,
                         "bound_ms": _bound_ms(d1, m, dtype),
                         "dispatch": P.width_kernels(d1, dtype)[2], "k3w_plan": plan})
            del args, Di, Si, K01, K10, ref
            torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_patch: needs a CUDA card (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    argv = sys.argv[1:]
    widths = None
    if "--widths" in argv:
        widths = tuple(int(w) for w in argv[argv.index("--widths") + 1].split(","))
    if "--sweep" in argv:
        rows = sweep(widths or SWEEP_WIDTHS,
                     factors=torch.bfloat16 if "--bf16" in argv else None)
    else:
        rows = compare(load(start_build()), widths or WIDTHS)
    for row in rows:
        print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
