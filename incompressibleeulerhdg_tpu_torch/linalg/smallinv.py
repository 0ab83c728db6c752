"""Batched unpivoted Gauss-Jordan inverse of batch-last (n, n, B) blocks.

Counterpart of incompressibleeulerhdg_tpu/linalg/smallinv.py
``gauss_jordan_inv_bl``.  On a CUDA tensor it launches a kernel chosen by the
block size: K4 (``csrc/gauss_jordan.cu``) for n <= 32 and K5
(``csrc/gauss_jordan_select.cu``) for 32 < n <= 72: the JAX Pallas gate
(n <= 48), and above it the blocks of k = 5 and 6 (n = 56, 72), which the
JAX package inverts with its jnp loop; larger blocks raise.  Both are instantiations of one register-tiled design
(``csrc/gauss_jordan.cuh``; :func:`launch_plan` describes an instantiation).
On a CPU tensor it runs :func:`gauss_jordan_inv_plain`, the pivot loop of
the JAX fallback (smallinv.py:119-136).  No pivoting: the callers invert
diagonally dominant preconditioner blocks (mass + penalty).

:func:`gauss_jordan_inv_select` is K5 on its own, beside its plain version
:func:`gauss_jordan_inv_select_plain`: the masked-select formulation of
``tools/microbench_gj.py:_gj_old``.
"""

import ctypes

import torch

from .. import kernels

__all__ = [
    "gauss_jordan_inv_bl",
    "gauss_jordan_inv_plain",
    "gauss_jordan_inv_select",
    "gauss_jordan_inv_select_plain",
    "launch_plan",
]

K4_MAX_N = 32  # K4's largest instantiation (csrc/gauss_jordan.cu)
SELECT_MAX_N = 72  # K5: up to k = 6 (the JAX Pallas gate is n <= 48, smallinv.py:111-117)
PLAN_KEYS = ("N", "R", "C", "BB", "threads", "smem_bytes")


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


def _launch_gj(name, A, max_n):
    n, n2, B = A.shape
    if n != n2:
        raise ValueError(f"{name}: blocks must be square, got {tuple(A.shape)}")
    if n > max_n:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes n <= {max_n}, got {n} "
            "(ROADMAP Queue 1, 'k >= 7 on the card')")
    A = A.contiguous()
    dev, code = kernels.check_cuda(name, A)
    out = torch.empty_like(A)
    if B == 0:
        return out
    kernels.launch(name, dev, code, n, A.data_ptr(), out.data_ptr(), B, kernels.stream_ptr(A))
    return out


def launch_plan(name, dtype, n):
    """Launch plan of kernel ``name`` ("gauss_jordan" or
    "gauss_jordan_select") for (n, n) blocks of ``dtype``, from its library
    (built first if needed): the instantiation N >= n, the R x C register
    tile of a thread, the BB blocks of a thread block, its threads and its
    shared-memory bytes."""
    fn = getattr(kernels._get(name), f"iehdg_{name}_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    if fn(kernels.dtype_code(dtype), int(n), plan) != 0:
        raise ValueError(f"{name}: no launch plan for n = {n}")
    return dict(zip(PLAN_KEYS, plan))


def gauss_jordan_inv_select(A):
    """K5: inverse of every (n, n) block of a batch-last (n, n, B) tensor,
    n <= 72, by the masked-select Gauss-Jordan."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_select_plain(A)
    return _launch_gj("gauss_jordan_select", A, SELECT_MAX_N)


def gauss_jordan_inv_bl(A):
    """Inverse of every (n, n) block of a batch-last (n, n, B) tensor."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_plain(A)
    if A.shape[0] <= K4_MAX_N:
        return _launch_gj("gauss_jordan", A, K4_MAX_N)
    return _launch_gj("gauss_jordan_select", A, SELECT_MAX_N)
