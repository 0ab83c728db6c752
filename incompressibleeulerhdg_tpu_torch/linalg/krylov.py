"""Restarted GMRES and CG with iteration-count observables, as eager loops.

Counterpart of incompressibleeulerhdg_tpu/linalg/krylov.py ``gmres`` (left
preconditioned, with an optional nullspace projector), ``gmres_right``
(flexible, right preconditioned, with a fused preconditioner + operator),
``fgmres`` (flexible, right preconditioned, for an inner-iteration
preconditioner) and ``cg`` (preconditioned conjugate gradients, with the
JAX package's stopping rule).
The JAX ``lax.while_loop`` becomes a Python loop: the Krylov basis and all
vector work stay on the device, and each Arnoldi step makes ONE host read
(the new Hessenberg column and its norm), on which the host applies the
Givens rotations in float64 and decides whether to continue.

Inside a step's spans (utils/logging.py) each operator application runs
under ``krylov.matvec``, each preconditioner application under
``krylov.precond``, the Gram-Schmidt products under
``krylov.orthogonalise``, and each blocking read of the device (the
Hessenberg column, a norm, a finiteness test) under ``host.read``, which
holds the read alone.

Vectors are flat 1-D tensors; callers flatten their field layouts.  With a
``comm`` (parallel/comm.py) the vectors are one rank's part of a
distributed vector: every inner product and norm is summed over the ranks,
so each stopping test reads the same all-reduced value on every rank and
all ranks take the same iterations (the JAX package's ``axis_name``).

A preconditioner's owner on one card may hand the loops :func:`graphed` of
it: each application then replays CUDA graphs of its PyTorch work (their
capture under the span ``krylov.capture``, each replay under
``krylov.replay``), with each hand-written kernel launched between them by
its own wrapper, so the host no longer issues the application's hundreds
of small operations one by one.
"""

import weakref

import numpy as np
import torch

from .. import kernels
from ..utils.logging import span

__all__ = ["gmres", "gmres_right", "fgmres", "cg", "deflate_constant", "graphed", "pdot",
           "pnorm"]


def pdot(a, b, comm=None):
    """Inner product (0-d tensor), summed over the ranks of ``comm``."""
    d = torch.dot(a, b)
    return d if comm is None else comm.allreduce(d)


def deflate_constant(nullvec, comm=None):
    """Projector v -> v - (nullvec . v) nullvec for a unit ``nullvec`` (unit
    in the global norm when distributed)."""

    def proj(v):
        return v - nullvec * pdot(nullvec, v, comm)

    return proj


def _identity(v):
    return v


class _Arnoldi:
    """One GMRES(m) cycle's basis, triangularised Hessenberg and Givens
    rotations.  The basis V (m+1, n) lives on the device; R, the rotations
    and g live on the host in float64."""

    def __init__(self, r, beta, m, tiny, comm=None):
        self.m = m
        self.tiny = tiny
        self.comm = comm
        self.V = r.new_zeros((m + 1, r.shape[0]))
        self.V[0] = r / max(beta, tiny)
        self.R = np.zeros((m, m))
        self.cs = np.zeros(m)
        self.sn = np.zeros(m)
        self.g = np.zeros(m + 1)
        self.g[0] = beta

    def step(self, j, w):
        """Orthogonalise w = op(V[j]) against V[:j+1] (Gram-Schmidt as two
        dense products, as the JAX code does), append V[j+1], update the
        rotations; returns |g[j+1]|, the residual estimate."""
        with span("krylov.orthogonalise"):
            Vj = self.V[: j + 1]
            h = Vj @ w
            if self.comm is not None:
                h = self.comm.allreduce(h)
            w = w - Vj.T @ h
            hnext = pnorm(w, self.comm)
            self.V[j + 1] = w / torch.clamp(hnext, min=self.tiny)
            col = torch.cat([h, hnext[None]])
        with span("host.read"):
            col = col.cpu()
        hh = col.numpy().astype(np.float64)
        for i in range(j):
            hi = self.cs[i] * hh[i] + self.sn[i] * hh[i + 1]
            hh[i + 1] = -self.sn[i] * hh[i] + self.cs[i] * hh[i + 1]
            hh[i] = hi
        denom = np.hypot(hh[j], hh[j + 1])
        if denom > self.tiny:
            c, s = hh[j] / denom, hh[j + 1] / denom
        else:
            c, s = 1.0, 0.0
        self.cs[j], self.sn[j] = c, s
        hh[j] = denom
        self.R[: j + 1, j] = hh[: j + 1]
        self.g[j + 1] = -s * self.g[j]
        self.g[j] = c * self.g[j]
        return abs(self.g[j + 1])

    def solve(self, n_ok, like):
        """y of the leading n_ok x n_ok triangular system, as a tensor."""
        y = np.zeros(n_ok)
        for i in range(n_ok - 1, -1, -1):
            y[i] = (self.g[i] - self.R[i, i + 1 : n_ok] @ y[i + 1 :]) / self.R[i, i]
        return torch.as_tensor(y, dtype=like.dtype, device=like.device)


def _tiny(dtype):
    return 1e-300 if dtype == torch.float64 else 1e-30


def pnorm(v, comm=None):
    """2-norm (0-d tensor), over the ranks of ``comm``."""
    if comm is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(comm.allreduce(torch.dot(v, v)))


def _norm(v, comm=None):
    """``pnorm`` read to the host, a float."""
    n = pnorm(v, comm)
    with span("host.read"):
        return float(n)


def _all_finite(x, comm=None):
    """Whether x is finite on every rank."""
    bad = (~torch.isfinite(x)).sum().to(torch.float64)
    if comm is not None:
        bad = comm.allreduce(bad)
    with span("host.read"):
        return float(bad) == 0.0


def _matvec(matvec, v):
    with span("krylov.matvec"):
        return matvec(v)


def _precond(M, v):
    with span("krylov.precond"):
        return M(v)


_WARM = set()  # (key, layout) of every graphed computation that has run eagerly
_LIVE = weakref.WeakSet()  # the captures still held by their owners
_STREAM = {}  # device -> the stream its captures run on


def _copies(out):
    return out.clone() if isinstance(out, torch.Tensor) else tuple(t.clone() for t in out)


class _Graph:
    """One captured application: its static input, its outputs, and its
    parts in order, the CUDA graphs of its PyTorch work and between them
    the calls of the hand-written kernels' launch wrappers
    (``kernels.graph_cut``).

    Every capture on a device takes the memory pool of a capture still
    alive there (a new pool when none is), on the device's one capture
    stream, so a pool's memory is each capture's scratch in turn.  That
    holds because nothing a capture carries from one replay to the next
    lies in the pool (its input buffer lies outside, the tables it reads
    are its owner's), replays run one after another on one stream, and a
    call copies the outputs before any other replay."""

    def __init__(self, fn, v):
        self.device = v.device
        self.inp = torch.empty_like(v)
        self.pool = next((g.pool for g in _LIVE if g.device == v.device), None) or \
            torch.cuda.graph_pool_handle()
        self.parts = []
        cur = torch.cuda.current_stream(v.device)
        side = _STREAM.get(v.device)
        if side is None:  # capture needs a stream of its own
            side = _STREAM[v.device] = torch.cuda.Stream(v.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            kernels.CAPTURE.graph = self
            self._begin()
            try:
                self.out = fn(self.inp)
            finally:
                kernels.CAPTURE.graph = None
                self.parts[-1].capture_end()
        cur.wait_stream(side)
        _LIVE.add(self)

    def _begin(self):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.parts.append(g)

    def cut(self, module, name, args, kwargs, outs):
        """End the graph being captured before a launch wrapper's call
        (``module.name(*args, **kwargs)`` into ``outs``) and begin the next."""
        self.parts[-1].capture_end()
        self.parts.append((module, name, args, kwargs, outs))
        self._begin()

    def __call__(self, v):
        self.inp.copy_(v)
        for part in self.parts:
            if not isinstance(part, tuple):
                part.replay()
                continue
            module, name, args, kwargs, outs = part
            kernels.CAPTURE.outs = outs
            try:
                got = getattr(module, name)(*args, **kwargs)
            finally:
                kernels.CAPTURE.outs = None
            if any(a is not b for a, b in zip((got,) if len(outs) == 1 else got, outs)):
                raise RuntimeError(f"{name} wrote outside the outputs of its capture")
        return _copies(self.out)


def graphed(fn, graphs, key):
    """``fn`` (a preconditioner on one card: a tensor in, a tensor or a
    tuple of tensors out, no read of the device, no collective) replayed
    from CUDA graphs.

    For a CUDA ``v`` the first call of a ``key`` and input layout (shape,
    dtype, device) in the process runs eagerly, which sets up what the
    launches need once (FFT plans, library handles); a later call captures
    ``fn`` into ``graphs`` (under ``krylov.capture``), and every call
    copies ``v`` into the capture's input, replays (under ``krylov.replay``)
    and returns copies of its outputs, so a result stays as it is under
    later calls.  A replay runs the captured PyTorch work and calls each
    hand-written kernel's launch wrapper where ``fn`` called it
    (``kernels.graph_cut``), in the eager call's order: the results are
    the eager path's.  For a CPU ``v``, ``fn(v)`` runs as it is.

    :arg graphs: dict of the captures, which its owner keeps exactly as
        long as the tensors that ``fn`` reads
    :arg key: what, beside the input's layout, decides the work ``fn`` does
    """

    def apply(v):
        if not v.is_cuda:
            return fn(v)
        layout = (key, tuple(v.shape), v.dtype, v.device)
        g = graphs.get(layout)
        if g is None:
            if layout not in _WARM:
                _WARM.add(layout)
                return fn(v)
            with span("krylov.capture"):
                g = graphs[layout] = _Graph(fn, v)
        with span("krylov.replay"):
            return g(v)

    return apply


def gmres(matvec, b, *, M=None, rtol=1e-12, restart=30, maxiter=200, project=None, comm=None):
    """Left-preconditioned restarted GMRES from x = 0: solves ``M A x = M b``.

    Converged when the preconditioned residual norm drops below
    ``rtol * ||M b||``.  ``project`` is applied to b and to every
    operator output (nullspace deflation).  A restart cycle that reduces the
    residual by less than 5% ends the iteration (stagnation guard).

    :returns: (x, iters, relres) with iters an int and relres a float
    """
    M = M or _identity
    project = project or _identity
    m = restart
    tiny = _tiny(b.dtype)
    b = project(b)
    Mb_norm = _norm(_precond(M, b), comm)
    target = rtol * Mb_norm
    x = torch.zeros_like(b)
    res, iters, go = float("inf"), 0, True
    while res > target and iters < maxiter and go:
        r = _precond(M, project(b - _matvec(matvec, x)))
        beta = _norm(r, comm)
        arn = _Arnoldi(r, beta, m, tiny, comm)
        j, res_c = 0, beta
        while j < m and res_c > target:
            res_c = arn.step(j, _precond(M, project(_matvec(matvec, arn.V[j]))))
            j += 1
        if j > 0:
            x = x + arn.V[:j].T @ arn.solve(j, x)
        go = j > 0 and res_c < 0.95 * res
        res = res_c
        iters += j
    return x, iters, res / max(Mb_norm, tiny)


def gmres_right(opM, matvec, b, *, rtol=1e-12, restart=30, maxiter=200, comm=None):
    """Right-preconditioned flexible GMRES from x = 0 with a fused
    preconditioner.

    ``opM(v) -> (M v, A M v)``.  The preconditioned directions z_j are
    stored and x is rebuilt as ``x + Z y`` from them (re-applying M instead
    floors the attainable residual in float32 at scale); ``matvec`` gives
    the exact starting residual of each cycle.  Converged on the true
    residual ``||b - A x|| <= rtol ||b||``; the returned relres
    is recomputed from an exact final residual.  A non-finite residual stops
    the cycle at its last finite step, and a non-finite iterate is never
    returned.

    :returns: (x, iters, relres) with iters an int and relres a float
    """
    m = restart
    tiny = _tiny(b.dtype)
    bnorm = _norm(b, comm)
    target = rtol * bnorm
    x = torch.zeros_like(b)
    res, iters, go = float("inf"), 0, True
    while res > target and iters < maxiter and go:
        r = b - _matvec(matvec, x)
        beta = _norm(r, comm)
        arn = _Arnoldi(r, beta, m, tiny, comm)
        Z = b.new_zeros((m, b.shape[0]))
        j, res_c = 0, beta
        while j < m and res_c > target and np.isfinite(res_c):
            z, w = _precond(opM, arn.V[j])
            Z[j] = z
            res_c = arn.step(j, w)
            j += 1
        n_ok = j if np.isfinite(res_c) else max(j - 1, 0)
        x_new = x + Z[:n_ok].T @ arn.solve(n_ok, x) if n_ok else x
        if _all_finite(x_new, comm):
            x = x_new
        else:
            res_c = float("inf")
        go = j > 0 and res_c < 0.95 * res
        res = res_c
        iters += j
    relres = _norm(b - _matvec(matvec, x), comm) / max(bnorm, tiny)
    return x, iters, relres


def fgmres(matvec, b, *, M=None, x0=None, rtol=1e-12, restart=30, maxiter=200, project=None,
           comm=None):
    """Flexible right-preconditioned restarted GMRES from ``x0`` (default 0).

    ``M`` may itself be an inner iteration (a projection cycle with nested
    Krylov solves): the preconditioned directions z_j = M v_j are stored and
    x is rebuilt as ``x + Z y``.  ``project`` is applied to b, to every
    cycle's starting residual and to every operator output.  Converged when
    the Givens residual estimate drops below ``rtol * ||b||``; a restart
    cycle that reduces it by less than 5% ends the iteration.

    :returns: (x, iters, relres) with iters an int and relres the final
        residual estimate over ||b||, a float
    """
    M = M or _identity
    project = project or _identity
    m = restart
    tiny = _tiny(b.dtype)
    b = project(b)
    bnorm = _norm(b, comm)
    target = rtol * bnorm
    x = torch.zeros_like(b) if x0 is None else x0
    res, iters, go = float("inf"), 0, True
    while res > target and iters < maxiter and go:
        r = project(b - _matvec(matvec, x))
        beta = _norm(r, comm)
        arn = _Arnoldi(r, beta, m, tiny, comm)
        Z = b.new_zeros((m, b.shape[0]))
        j, res_c = 0, beta
        while j < m and res_c > target:
            z = _precond(M, arn.V[j])
            Z[j] = z
            res_c = arn.step(j, project(_matvec(matvec, z)))
            j += 1
        if j > 0:
            x = x + Z[:j].T @ arn.solve(j, x)
        go = j > 0 and res_c < 0.95 * res
        res = res_c
        iters += j
    return x, iters, res / max(bnorm, tiny)


def cg(matvec, b, *, M=None, x0=None, rtol=1e-12, atol=0.0, maxiter=500, project=None,
       comm=None):
    """Preconditioned conjugate gradients from ``x0`` (default 0).

    Runs while the unpreconditioned residual norm exceeds
    ``max(rtol * ||P b||, atol)`` and fewer than ``maxiter`` iterations were
    taken; ``project`` (P) is applied to b, to the starting residual, to
    every operator output and every preconditioned residual.  One host read
    (the residual norm) per iteration.

    :returns: (x, iters, relres) with iters an int and relres
        ``||r|| / max(||P b||, 1e-300)``, a float
    """
    M = M or _identity
    project = project or _identity
    b = project(b)
    bnorm = _norm(b, comm)
    target = max(rtol * bnorm, atol)
    x = torch.zeros_like(b) if x0 is None else x0
    r = project(b - matvec(x))
    z = project(M(r))
    p = z
    rz = pdot(r, z, comm)
    res, iters = _norm(r, comm), 0
    while res > target and iters < maxiter:
        Ap = project(matvec(p))
        alpha = rz / pdot(p, Ap, comm)
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(M(r))
        rz_new = pdot(r, z, comm)
        p = z + (rz_new / rz) * p
        rz = rz_new
        iters += 1
        res = _norm(r, comm)
    return x, iters, res / max(bnorm, 1e-300)
