"""Batched unpivoted Gauss-Jordan inverse of batch-last (n, n, B) blocks.

Counterpart of incompressibleeulerhdg_tpu/linalg/smallinv.py
``gauss_jordan_inv_bl``.  On a CUDA tensor it launches a kernel chosen by the
block size alone: K4 (``csrc/gauss_jordan.cu``) for n <= 32, K5
(``csrc/gauss_jordan_select.cu``) for 32 < n <= 72 (the JAX Pallas gate is
n <= 48; above it the JAX package inverts with its jnp loop), and K5w
(``csrc/gauss_jordan_wide.cu``) above, for any n: the blocks of k >= 7.  K4
and K5 are instantiations of one register-tiled design
(``csrc/gauss_jordan.cuh``) at a compile-time N; K5w tiles registers at a
run-time n, splits a block's tile rows over a thread-block cluster where
one SM's registers do not hold it, and works in device memory past a
cluster of 8 (:func:`wide_gj_plan` chooses, :func:`launch_plan` describes
any kernel's plan for n).  On a CPU tensor it runs
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
    "wide_gj_plan",
]

K4_MAX_N = 32  # K4's largest instantiation (csrc/gauss_jordan.cu)
SELECT_MAX_N = 72  # K5: up to k = 6 (the JAX Pallas gate is n <= 48, smallinv.py:111-117)
PLAN_KEYS = {
    "gauss_jordan": ("N", "R", "C", "BB", "threads", "smem_bytes"),
    "gauss_jordan_select": ("N", "R", "C", "BB", "threads", "smem_bytes"),
}
SMEM_MAX = 232448  # bytes of shared memory a thread block may use (H100)
# K5w's register tiles, csrc/gauss_jordan_wide.cu GJW_TILES: R (an R x R tile
# a thread) -> the most threads a thread block (its __launch_bounds__), in
# the order of preference
WIDE_GJ_TILES = {
    torch.float32: {10: 384, 9: 448, 8: 512, 6: 640},
    torch.float64: {6: 448, 8: 320, 4: 640},
}
WIDE_GJ_CLUSTER_MAX = 8  # the portable cluster size
WIDE_GJ_WASTE = 1.1  # most padded work, (TR R / n)^2, before a less preferred R
WIDE_GJ_BB_MAX = 8  # batch entries a thread block
WIDE_GJ_DEV_G = 16  # device-memory path: entries a thread block
WIDE_GJ_DEV_THREADS = 1024


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


def _tile_plan(n, size, R, maxt, BB=None, CS=None):
    """K5w's register-tile plan with R x R tiles, or None where no cluster
    of at most 8 thread blocks holds a block."""
    TR = -(-n // R)
    for cs in (CS,) if CS else range(1, WIDE_GJ_CLUSTER_MAX + 1):
        rpc = -(-TR // cs)
        if cs > 1 and (cs - 1) * rpc >= TR:  # a rank without a tile row
            continue
        per = rpc * TR  # threads an entry
        if per > maxt:
            continue
        bb = BB or (min(WIDE_GJ_BB_MAX, maxt // per) if cs == 1 else 1)
        smem = (4 * TR * (R | 1) * bb + 2 * bb) * size
        if bb * per > maxt or smem > SMEM_MAX or cs > WIDE_GJ_CLUSTER_MAX:
            return None
        return {"path": "tiles" if cs == 1 else "cluster", "R": R, "TR": TR, "BB": bb,
                "CS": cs, "rows_per_rank": rpc, "threads": bb * per, "smem_bytes": smem,
                "waste": (TR * R / n) ** 2}
    return None


def wide_gj_plan(n, dtype, R=None, BB=None, CS=None):
    """K5w's launch plan for (n, n) blocks of ``dtype``.

    ``path`` "tiles": an R x R register tile a thread (R of
    :data:`WIDE_GJ_TILES`), TR = ceil(n / R) tile rows and columns a block,
    BB batch entries a thread block (as many as its threads allow, up to
    :data:`WIDE_GJ_BB_MAX`), ``threads`` = BB TR^2; "cluster": the TR tile rows
    split over a cluster of CS thread blocks (``rows_per_rank`` each, the
    last may hold fewer), one batch entry a cluster, where one thread block
    cannot hold a block's tiles; "device": the blocks in device memory (BB
    of them a thread block, RS row slices), where no cluster of 8 holds
    them.  ``smem_bytes``: the pivot buffers (or blocks) a thread block
    stages.  The tile R is the first of the dtype's list whose padded work
    (TR R / n)^2 stays within :data:`WIDE_GJ_WASTE` on the fewest thread
    blocks a block; ``R``, ``BB`` and ``CS`` fix a plan (tools/tune_gj.py),
    and a fixed plan that does not fit raises ValueError.  Raises
    NotImplementedError past every plan (float64 n > 7,264)."""
    size = torch.empty((), dtype=dtype).element_size()
    tiles = WIDE_GJ_TILES[dtype]
    if R is not None:
        if R not in tiles:
            raise ValueError(f"gauss_jordan_wide: no {R} x {R} tile for {dtype}")
        plan = _tile_plan(n, size, R, tiles[R], BB, CS)
        if plan is None:
            raise ValueError(f"gauss_jordan_wide: the plan R={R} BB={BB} CS={CS} does not "
                             f"fit n = {n}")
        return plan
    plans = [p for p in (_tile_plan(n, size, r, m) for r, m in tiles.items()) if p]
    if plans:
        return min(plans, key=lambda p: (p["CS"], p["waste"] > WIDE_GJ_WASTE,
                                         list(tiles).index(p["R"])))
    G = min(WIDE_GJ_DEV_G, SMEM_MAX // (4 * n * size))
    if G < 1:
        raise NotImplementedError(
            f"gauss_jordan_wide: the pivot buffers of one block at n = {n} take "
            f"{4 * n * size} B of shared memory, past the {SMEM_MAX} B a block may use")
    rs = min(max(1, WIDE_GJ_DEV_THREADS // (n * G)), n)
    threads = min(WIDE_GJ_DEV_THREADS, -(-n * G * rs // 32) * 32)
    return {"path": "device", "R": 0, "TR": 0, "BB": G, "CS": 1, "RS": rs,
            "threads": threads, "smem_bytes": 4 * n * G * size}


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
    plan = ()
    if name == "gauss_jordan_wide":
        p = wide_gj_plan(n, A.dtype)
        dev_path = p["path"] == "device"
        plan = (int(dev_path), p["R"], p["BB"], p["RS"] if dev_path else p["CS"],
                p["threads"], p["smem_bytes"])
    kernels.launch(name, dev, code, n, A.data_ptr(), out.data_ptr(), B, *plan,
                   kernels.stream_ptr(A))
    return out


def launch_plan(name, dtype, n):
    """Launch plan of kernel ``name`` ("gauss_jordan", "gauss_jordan_select"
    or "gauss_jordan_wide") for (n, n) blocks of ``dtype``.  K4, K5, from
    their library (built first if needed): the instantiation N >= n, the
    R x C register tile of a thread, the BB blocks of a thread block, its
    threads and its shared-memory bytes; K5w: :func:`wide_gj_plan`."""
    if name == "gauss_jordan_wide":
        return wide_gj_plan(n, dtype)
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
