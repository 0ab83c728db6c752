"""The traced run's view into the program: each port kernel launch, its
kernel, its shape and its span, from the benchmark's own wrappers.

:class:`LaunchRecorder` wraps, for the time of a ``with`` block, the
port's Python launch wrappers (``linalg/preconditioners.py``
``fact_apply``, ``cross_pair``, ``patch_solve`` and ``linalg/smallinv.py``
``_launch_gj``), which know each launch's shape, and ``kernels.launch``,
which every launch goes through and which knows the kernel that runs.
Each launch gets an index, a record (kernel, dtype, d1 or n, columns,
segments, factor dtype) and a ``record_function`` span named
``trace.LAUNCH_SPAN`` + index, which ``trace.summarise`` uses to give the
launch its device time.  The program itself is not changed.
"""

import functools
import inspect
import threading

import torch

from .trace import LAUNCH_SPAN

__all__ = ["LaunchRecorder"]


def _dtype(t):
    return str(t.dtype).removeprefix("torch.")


def _shape_fact_apply(A, P, bounds, x, aoff=0):
    return dict(d1=int(A.shape[0]), m=int(x.shape[1]), nseg=len(bounds) - 1,
                dtype=_dtype(x), factors=None)


def _shape_cross_pair(K01, K10, Bp, Cp, bounds, x0, x1, aoff=0):
    return dict(d1=int(K01.shape[0]), m=int(x0.shape[1]), nseg=len(bounds) - 1,
                dtype=_dtype(x0), factors=None)


def _shape_patch_solve(Dinv0, Sinv, K01, K10, Bp_k, Cp_k, r0, r1, off):
    return dict(d1=int(K01.shape[0]), m=int(r0.shape[1]), nseg=1, dtype=_dtype(r0),
                factors=_dtype(Dinv0))


def _shape_launch_gj(name, A, max_n=None, variant=None):
    return dict(n=int(A.shape[0]), m=int(A.shape[2]), dtype=_dtype(A), factors=None)


class LaunchRecorder:
    """Records every port kernel launch made inside the ``with`` block:
    ``self.launches[i]`` is a dict with the kernel's ``name`` and the
    shape of launch i (or only the name, where no known wrapper made the
    launch)."""

    def __init__(self):
        self.launches = []
        self._local = threading.local()
        self._saved = []

    def _wrap_shape(self, module, attr, shape_fn):
        orig = getattr(module, attr)
        sig = inspect.signature(shape_fn)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            stack = self._local.__dict__.setdefault("stack", [])
            stack.append(shape_fn(*bound.args, **bound.kwargs))
            try:
                return orig(*args, **kwargs)
            finally:
                stack.pop()

        self._saved.append((module, attr, orig))
        setattr(module, attr, wrapper)

    def __enter__(self):
        from incompressibleeulerhdg_tpu_torch import kernels
        from incompressibleeulerhdg_tpu_torch.linalg import preconditioners, smallinv

        self._wrap_shape(preconditioners, "fact_apply", _shape_fact_apply)
        self._wrap_shape(preconditioners, "cross_pair", _shape_cross_pair)
        self._wrap_shape(preconditioners, "patch_solve", _shape_patch_solve)
        self._wrap_shape(smallinv, "_launch_gj", _shape_launch_gj)
        orig_launch = kernels.launch

        @functools.wraps(orig_launch)
        def launch(name, *args):
            stack = self._local.__dict__.get("stack")
            rec = dict(stack[-1]) if stack else {}
            rec["name"] = name
            i = len(self.launches)
            self.launches.append(rec)
            with torch.profiler.record_function(f"{LAUNCH_SPAN}{i}"):
                return orig_launch(name, *args)

        self._saved.append((kernels, "launch", orig_launch))
        kernels.launch = launch
        return self

    def __exit__(self, *exc):
        while self._saved:
            module, attr, orig = self._saved.pop()
            setattr(module, attr, orig)
        return False
