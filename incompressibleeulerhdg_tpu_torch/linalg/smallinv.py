"""Batched unpivoted Gauss-Jordan inverse of batch-last (n, n, B) blocks.

Counterpart of incompressibleeulerhdg_tpu/linalg/smallinv.py
``gauss_jordan_inv_bl``.  On a CUDA tensor it launches a kernel chosen by the
block size alone: K4 (``csrc/gauss_jordan.cu``) for n <= 32, K5
(``csrc/gauss_jordan_select.cu``) for 32 < n <= 72 (the JAX Pallas gate is
n <= 48; above it the JAX package inverts with its jnp loop), and K5w
(``csrc/gauss_jordan_wide.cu``) above, for any n: the blocks of k >= 7.  K4
and K5 are instantiations of one register-tiled design
(``csrc/gauss_jordan.cuh``); K5w holds its blocks in shared memory, or in
device memory where one block does not fit (:func:`launch_plan` describes
a kernel's plan for n).  On a CPU tensor it runs
:func:`gauss_jordan_inv_plain`, the pivot loop of the JAX fallback
(smallinv.py:119-136).  No pivoting: the callers invert diagonally
dominant preconditioner blocks (mass + penalty).

:func:`gauss_jordan_inv_select` is K5 on its own, beside its plain version
:func:`gauss_jordan_inv_select_plain`: the masked-select formulation of
``tools/microbench_gj.py:_gj_old``; :func:`gauss_jordan_inv_wide` is K5w on
its own.
"""

import ctypes

import torch

from .. import kernels

__all__ = [
    "gauss_jordan_inv_bl",
    "gauss_jordan_inv_plain",
    "gauss_jordan_inv_select",
    "gauss_jordan_inv_select_plain",
    "gauss_jordan_inv_wide",
    "kernel_for",
    "launch_plan",
]

K4_MAX_N = 32  # K4's largest instantiation (csrc/gauss_jordan.cu)
SELECT_MAX_N = 72  # K5: up to k = 6 (the JAX Pallas gate is n <= 48, smallinv.py:111-117)
PLAN_KEYS = {
    "gauss_jordan": ("N", "R", "C", "BB", "threads", "smem_bytes"),
    "gauss_jordan_select": ("N", "R", "C", "BB", "threads", "smem_bytes"),
    "gauss_jordan_wide": ("G", "RS", "threads", "smem_bytes", "in_smem"),
}


def gauss_jordan_inv_plain(A):
    """Plain PyTorch in-place Gauss-Jordan over the pivot index."""
    A = A.clone()
    n = A.shape[0]
    for k in range(n):
        inv_p = 1.0 / A[k, k]  # (B,)
        row_k = A[k] * inv_p[None, :]  # (n, B)
        row_k[k] = inv_p
        f = A[:, k].clone()
        f[k] = 0.0
        A -= f[:, None, :] * row_k[None, :, :]
        A[:, k] = -f * inv_p[None, :]
        A[k] = row_k
    return A


def gauss_jordan_inv_select_plain(A):
    """Plain PyTorch transcription of the masked-select pivot step of
    ``_gj_old_kernel_factory``: every pivot rewrites the whole block."""
    n = A.shape[0]
    idx = torch.arange(n, device=A.device)[:, None]  # (n, 1)
    for k in range(n):
        mk = idx == k
        pivot = A[k]
        inv_p = 1.0 / pivot[k]
        row_k = torch.where(mk, inv_p[None, :], pivot * inv_p[None, :])
        f = torch.where(mk, 0.0, A[:, k, :])
        A = A - f[:, None, :] * row_k[None, :, :]
        A = torch.where(mk[None, :, :], (-f * inv_p[None, :])[:, None, :], A)
        A = torch.where(mk[:, :, None], row_k[None, :, :], A)
    return A


def _launch_gj(name, A, max_n=None):
    n, n2, B = A.shape
    if n != n2:
        raise ValueError(f"{name}: blocks must be square, got {tuple(A.shape)}")
    if max_n is not None and n > max_n:  # K5 on its own
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes n <= {max_n}, got {n} "
            "(gauss_jordan_inv_bl launches gauss_jordan_wide above)")
    A = A.contiguous()
    dev, code = kernels.check_cuda(name, A)
    out = torch.empty_like(A)
    if B == 0:
        return out
    kernels.launch(name, dev, code, n, A.data_ptr(), out.data_ptr(), B, kernels.stream_ptr(A))
    return out


def launch_plan(name, dtype, n):
    """Launch plan of kernel ``name`` ("gauss_jordan", "gauss_jordan_select"
    or "gauss_jordan_wide") for (n, n) blocks of ``dtype``, from its library
    (built first if needed).  K4, K5: the instantiation N >= n, the R x C
    register tile of a thread, the BB blocks of a thread block, its threads
    and its shared-memory bytes; K5w: the G blocks of a thread block, its
    RS row slices, threads, shared-memory bytes, and whether the blocks
    lie in shared memory (1) or in device memory (0)."""
    keys = PLAN_KEYS[name]
    fn = getattr(kernels._get(name), f"iehdg_{name}_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    plan = (ctypes.c_int * len(keys))()
    if fn(kernels.dtype_code(dtype), int(n), plan) != 0:
        raise ValueError(f"{name}: no launch plan for n = {n}")
    return dict(zip(keys, plan))


def gauss_jordan_inv_select(A):
    """K5: inverse of every (n, n) block of a batch-last (n, n, B) tensor,
    n <= 72, by the masked-select Gauss-Jordan."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_select_plain(A)
    return _launch_gj("gauss_jordan_select", A, SELECT_MAX_N)


def gauss_jordan_inv_wide(A):
    """K5w: inverse of every (n, n) block of a batch-last (n, n, B) tensor,
    any n, by the plain version's pivot steps."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_plain(A)
    return _launch_gj("gauss_jordan_wide", A)


def kernel_for(n):
    """Name of the kernel :func:`gauss_jordan_inv_bl` launches for (n, n)
    blocks: K4 up to n = 32, K5 up to 72, K5w above."""
    if n <= K4_MAX_N:
        return "gauss_jordan"
    return "gauss_jordan_select" if n <= SELECT_MAX_N else "gauss_jordan_wide"


def gauss_jordan_inv_bl(A):
    """Inverse of every (n, n) block of a batch-last (n, n, B) tensor."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_plain(A)
    return _launch_gj(kernel_for(A.shape[0]), A)
