"""Batched unpivoted Gauss-Jordan inverse of batch-last (n, n, B) blocks.

Counterpart of incompressibleeulerhdg_tpu/linalg/smallinv.py
``gauss_jordan_inv_bl``.  On a CUDA tensor it launches kernel K4
(``csrc/gauss_jordan.cu``, one warp per block, n <= 32); on a CPU tensor it
runs :func:`gauss_jordan_inv_plain`, the pivot loop of the JAX fallback
(smallinv.py:119-136).  No pivoting: the callers invert diagonally dominant
preconditioner blocks (mass + penalty).
"""

import torch

from .. import kernels

__all__ = ["gauss_jordan_inv_bl", "gauss_jordan_inv_plain"]


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


def gauss_jordan_inv_bl(A):
    """Inverse of every (n, n) block of a batch-last (n, n, B) tensor."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_plain(A)
    n, n2, B = A.shape
    if n != n2:
        raise ValueError(f"gauss_jordan_inv_bl: blocks must be square, got {tuple(A.shape)}")
    if n > 32:
        raise ValueError(f"gauss_jordan_inv_bl: the CUDA kernel takes n <= 32, got {n}")
    A = A.contiguous()
    dev, code = kernels.check_cuda("gauss_jordan", A)
    out = torch.empty_like(A)
    if B == 0:
        return out
    kernels.launch("gauss_jordan", dev, code, n, A.data_ptr(), out.data_ptr(),
                   B, kernels.stream_ptr(A))
    return out
