"""Build, load and launch the hand-written CUDA kernels of the port.

Each kernel source ``csrc/<source>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface
(``build/torch_kernels/lib<source>-<hash>.so`` at the repository root, keyed
by the hash of the sources and flags), loaded with ``ctypes``; a source is
named after its kernel, or holds several (:data:`SOURCES`).  Nothing is
compiled or loaded at import time: the first launch of a kernel builds it,
:func:`build_all` builds every kernel at once (in parallel), e.g. as a
timed set-up phase, and :func:`start_builds` starts them all and returns,
so work that needs some kernels can run while the others compile.  nvcc
runs with ``-Xptxas -v``; its report (registers, shared memory, spills of
every instantiation) is kept beside each library and read by
:func:`ptxas_report`.

Every wrapper that launches a kernel adds one to ``LAUNCHES[name]`` at the
launch, and only there, so a run can show which kernels its main path went
through (:func:`reset_launches` zeroes the counts).  A CUDA graph
(``linalg/krylov.py`` ``graphed``) captures no launch: its capture cuts
the graph around each call of a wrapper marked :func:`graph_cut`, and each
replay calls the wrapper there, which launches and counts as an eager call
does.
"""

import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "build_all",
    "graph_cut",
    "reset_launches",
    "launch",
    "launch_outputs",
    "ptxas_report",
    "stream_ptr",
]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_LIBS = ["-lcuda"]  # cuTensorMapEncodeTiled (csrc/tma.cuh)
TMA_ERROR = 100000  # IEHDG_TMA_ERROR of csrc/tma.cuh

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)

# name -> (C entry point, argtypes, TPU kernel it replaces)
KERNELS = {
    "fact_apply": (
        "iehdg_fact_apply",
        [_I, _I, _I, _P, _L, _L, _P, _LP, _I, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:830 _fact_pallas",
    ),
    "cross_pair": (
        "iehdg_cross_pair",
        [_I, _I, _I, _P, _P, _L, _L, _P, _P, _LP, _I, _P, _P, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1007 _cross_pair_pallas",
    ),
    "patch_solve": (
        "iehdg_patch_solve",
        [_I, _I, _I, _P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1199 _patch_pallas",
    ),
    "gauss_jordan": (
        "iehdg_gauss_jordan",
        [_I, _I, _I, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/smallinv.py:52 _gj_pallas",
    ),
    "gauss_jordan_select": (
        "iehdg_gauss_jordan_select",
        [_I, _I, _I, _P, _P, _L, _I, _P],
        "tools/microbench_gj.py:79 _gj_old",
    ),
    # the runtime-width kernels: K1w, K2w where K1, K2 are not instantiated
    # and (K2w) K2c (cross_pair_cluster) is not measured faster
    # (preconditioners.CROSS_PAIR_MEASURED), K3w from d1 = 21, K5w past n = 72
    "fact_apply_wide": (
        "iehdg_fact_apply_wide",
        [_I, _I, _I, _P, _L, _L, _P, _LP, _I, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:830 _fact_pallas",
    ),
    "cross_pair_wide": (
        "iehdg_cross_pair_wide",
        [_I, _I, _I, _P, _P, _L, _L, _P, _P, _LP, _I, _P, _P, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1007 _cross_pair_pallas",
    ),
    "cross_pair_cluster": (
        "iehdg_cross_pair_cluster",
        [_I, _I, _I, _I, _I, _I, _L, _P, _P, _L, _L, _P, _P, _LP, _I, _P, _P, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1007 _cross_pair_pallas",
    ),
    "patch_solve_wide": (
        "iehdg_patch_solve_wide",
        [_I, _I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1199 _patch_pallas",
    ),
    "gauss_jordan_wide": (
        "iehdg_gauss_jordan_wide",
        [_I, _I, _I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
        "incompressibleeulerhdg_tpu/linalg/smallinv.py:89 gauss_jordan_inv_bl",
    ),
    # K5b: K5w's blocked path (panels of b pivots, a rank-b update over the
    # card), past a cluster of 8 and where smallinv.WIDE_GJ_MEASURED says so
    "gauss_jordan_blocked": (
        "iehdg_gauss_jordan_blocked",
        [_I, _I, _I, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "incompressibleeulerhdg_tpu/linalg/smallinv.py:89 gauss_jordan_inv_bl",
    ),
    # K3 and K3w on bfloat16 patch factors (IEHDG_PC_BF16=1): Dinv0 and Sinv
    # in bfloat16 with their own column stride, every other operand float32
    "patch_solve_bf16": (
        "iehdg_patch_solve_bf16",
        [_I, _I, _I, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _L, _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1199 _patch_pallas",
    ),
    "patch_solve_wide_bf16": (
        "iehdg_patch_solve_wide_bf16",
        [_I, _I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _L,
         _P],
        "incompressibleeulerhdg_tpu/linalg/preconditioners.py:1199 _patch_pallas",
    ),
}

# kernel -> its source's name, where that differs from the kernel's
SOURCES = {"fact_apply_wide": "wide_apply", "cross_pair_wide": "wide_apply",
           "gauss_jordan_blocked": "gauss_jordan_wide", "patch_solve_bf16": "patch_solve",
           "patch_solve_wide_bf16": "patch_solve_wide"}

LAUNCHES = {name: 0 for name in KERNELS}

CAPTURE = threading.local()  # .graph: the graph this thread captures; .outs: see launch_outputs

_LIBS = {}
_PENDING = {}  # source -> (nvcc process, temporary output) started by start_builds
_LOCK = threading.Lock()


def reset_launches():
    """Set every kernel's launch count to zero."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def source_of(name):
    """Name of kernel ``name``'s CUDA source (``csrc/<source>.cu``)."""
    return SOURCES.get(name, name)


def source_path(name):
    """Repository-relative path of a kernel's CUDA source."""
    return f"{_PKG.name}/csrc/{source_of(name)}.cu"


def all_sources():
    """Every kernel source, once, in the order of :data:`KERNELS`."""
    return list(dict.fromkeys(source_of(n) for n in KERNELS))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(src):
    h = hashlib.sha256()
    for f in (_CSRC / f"{src}.cu", *sorted(_CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    return BUILD_DIR / f"lib{src}-{h.hexdigest()[:12]}.so"


def _start_build(src, so):
    """Start nvcc on one kernel source; returns (process, temporary output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{src}.cu"), *NVCC_LIBS]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp


def _report_path(so):
    return so.with_name(so.name + ".ptxas.txt")


def _finish_build(src, so, proc, tmp):
    """Wait for nvcc; install the library and its ptxas report, or return
    nvcc's error report."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed for {src}.cu (exit {proc.returncode}):\n{err}"
    _report_path(so).write_text(err)
    os.replace(tmp, so)
    return None


def ptxas_report(src):
    """ptxas's ``-v`` report of kernel source ``src``'s library (built first
    if needed): registers, shared memory and spill bytes of every
    instantiation."""
    _get_source(src)
    return _report_path(_lib_path(src)).read_text()


def _load(src, so):
    lib = ctypes.CDLL(str(so))
    for name, (entry, argtypes, _) in KERNELS.items():
        if source_of(name) == src:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.iehdg_error_string.argtypes = [ctypes.c_int]
    lib.iehdg_error_string.restype = ctypes.c_char_p
    return lib


def _get_source(src):
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            so = _lib_path(src)
            job = _PENDING.pop(src, None)
            if job is not None or not so.exists():
                err = _finish_build(src, so, *(job or _start_build(src, so)))
                if err:
                    raise RuntimeError(err)
            lib = _LIBS[src] = _load(src, so)
        return lib


def _get(name):
    """The loaded library of kernel ``name`` (built first if needed)."""
    return _get_source(source_of(name))


def start_builds():
    """Start nvcc on every kernel source not built yet (one process a
    source, all at once) and return: a kernel's first use, or
    :func:`build_all`, waits for its own source's build only."""
    with _LOCK:
        for src in all_sources():
            so = _lib_path(src)
            if src not in _LIBS and src not in _PENDING and not so.exists():
                _PENDING[src] = _start_build(src, so)


def build_all():
    """Compile (in parallel, one nvcc a source) and load every kernel;
    returns wall seconds."""
    t0 = time.perf_counter()
    start_builds()
    errors = []
    for src in all_sources():
        try:
            _get_source(src)
        except RuntimeError as e:  # gather every source's nvcc report, then raise
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def stream_ptr(t):
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name, *args):
    """Call kernel ``name``'s C entry point, count the launch, raise on error."""
    lib = _get(name)
    entry = KERNELS[name][0]
    code = getattr(lib, entry)(*args)
    if code >= TMA_ERROR:
        raise RuntimeError(f"CUDA kernel {name}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {code - TMA_ERROR})")
    if code != 0:
        msg = lib.iehdg_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({code})")
    LAUNCHES[name] += 1


def graph_cut(vectors, n_out):
    """Decorator of a launch wrapper whose ``n_out`` outputs are new tensors
    shaped like its argument named ``vectors[0]``, allocated by
    :func:`launch_outputs`; ``vectors`` names the arguments it makes
    contiguous.  While this thread captures a graph a call launches
    nothing: it makes the vectors contiguous and allocates the outputs
    inside the capture, and hands the call to the graph
    (``CAPTURE.graph.cut``), which ends its CUDA graph there and goes on
    in a new one.  At every replay, between the two, the graph calls the
    wrapper by its name in its module with the same arguments, and the
    wrapper launches into those outputs."""

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            graph = getattr(CAPTURE, "graph", None)
            if graph is None:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            for name in vectors:
                bound.arguments[name] = bound.arguments[name].contiguous()
            like = bound.arguments[vectors[0]]
            outs = tuple(torch.empty_like(like) for _ in range(n_out))
            graph.cut(sys.modules[fn.__module__], fn.__name__, bound.args, bound.kwargs, outs)
            return outs[0] if n_out == 1 else outs

        return call

    return deco


def launch_outputs(like, n):
    """The ``n`` outputs of a launch wrapper (:func:`graph_cut`): new tensors
    shaped like ``like``, or at a graph's replay those of its capture."""
    outs = getattr(CAPTURE, "outs", None)
    if outs is None:
        return tuple(torch.empty_like(like) for _ in range(n))
    CAPTURE.outs = None
    return outs


def dtype_code(dtype, factors=None):
    """C-interface scalar code of a torch dtype: 0 float32, 1 float64, and 2
    for float32 with ``factors`` (the patch factors' dtype) bfloat16.
    Raises on every other type or mix."""
    if factors is not None and factors != dtype:
        if dtype == torch.float32 and factors == torch.bfloat16:
            return 2
        raise TypeError(f"CUDA kernels take patch factors of their own dtype, or bfloat16 "
                        f"factors with float32, not {factors} with {dtype}")
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"CUDA kernels take float32 or float64, not {dtype}")


def check_cuda(name, *tensors, tables=(), factors=()):
    """Validate tensors handed to a kernel: one CUDA device, one dtype,
    ``tensors`` contiguous (``tables`` are checked by :func:`table_ld`);
    ``factors`` (the patch solve's Dinv0 and Sinv, also checked by
    :func:`table_ld`) share one dtype, which is the others' or, with
    float32, bfloat16 (:func:`dtype_code`).  Returns (device index, dtype
    code)."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    fdtype = factors[0].dtype if factors else dtype
    for t in (*tensors, *tables, *factors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must lie on one CUDA device")
        want = fdtype if any(t is f for f in factors) else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {want}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev.index, dtype_code(dtype, fdtype)


TMA_ALIGN = 16  # bytes: TMA's base-address and row-stride alignment


def padded_ld(n, dtype):
    """Column stride of a batch-last table of ``n`` columns whose rows start
    on TMA's 16-byte alignment."""
    per = TMA_ALIGN // torch.empty((), dtype=dtype).element_size()
    return -(-int(n) // per) * per


def table_ld(name, *tables):
    """Common column stride ``ld`` of batch-last tables (a, b, n) laid out as
    ``pad_table`` makes them (stride (b * ld, ld, 1), 16-byte aligned rows
    and base), as the TMA kernels read them; raises on any other layout."""
    ld = tables[0].stride(1)
    for t in tables:
        a, b, n = t.shape
        ok = t.stride() == (b * ld, ld, 1) and ld >= n and \
            (ld * t.element_size()) % TMA_ALIGN == 0 and t.data_ptr() % TMA_ALIGN == 0
        if not ok:
            raise ValueError(
                f"{name}: table {tuple(t.shape)} with strides {t.stride()} is not a "
                f"16-byte-aligned batch-last table (build it with preconditioners.pad_table)")
    return ld


def seg_array(bounds):
    """ctypes int64 array of segment bounds (at most 8 segments)."""
    bounds = [int(b) for b in bounds]
    if len(bounds) - 1 > 8:
        raise ValueError("at most 8 column segments")
    return (ctypes.c_longlong * len(bounds))(*bounds), len(bounds) - 1
