"""Batched unpivoted Gauss-Jordan inverse of batch-last (n, n, B) blocks.

Counterpart of incompressibleeulerhdg_tpu/linalg/smallinv.py
``gauss_jordan_inv_bl``.  On a CUDA tensor it launches a kernel chosen by the
block size (and, past n = 72, the dtype): K4 (``csrc/gauss_jordan.cu``) for
n <= 32, K5 (``csrc/gauss_jordan_select.cu``) for 32 < n <= 72 (the JAX
Pallas gate is n <= 48; above it the JAX package inverts with its jnp
loop), and above K5w (``csrc/gauss_jordan_wide.cu``) for any n: the blocks
of k >= 7.  K4 and K5's variant 0 are instantiations of one register-tiled
design (``csrc/gauss_jordan.cuh``) at a compile-time N; K5's variant 1 is
the team design (``csrc/gauss_jordan_team.cuh``: a block a team of two
warps, panels of R pivots, a staged batch), taken where
:data:`SELECT_MEASURED` found it faster.  K5w tiles registers at a run-time
n and splits a block's tile rows over a thread-block cluster where one SM's
registers do not hold it; past a cluster of 8, and where
:data:`WIDE_GJ_MEASURED` found it faster, K5b (``gauss_jordan_blocked``, in
the same source) inverts panel by panel, each panel a rank-b update over the
whole card (:func:`wide_gj_plan` chooses, :func:`launch_plan` describes any
kernel's plan for n).  On a CPU tensor it runs :func:`gauss_jordan_inv_plain`,
the pivot loop of the JAX fallback (smallinv.py:119-136).  No pivoting: the
callers invert diagonally dominant preconditioner blocks (mass + penalty).

:func:`gauss_jordan_inv_select` is K5 on its own, beside its plain version
:func:`gauss_jordan_inv_select_plain`: the masked-select formulation of
``tools/microbench_gj.py:_gj_old``; :func:`gauss_jordan_inv_wide` is K5w
(K5b where its plan says so) on its own, :func:`gauss_jordan_inv_blocked`
K5b on its own, beside its plain twin :func:`gauss_jordan_inv_blocked_plain`
(the panel steps in PyTorch, for the tests and chip_smoke.py).
"""

import ctypes

import torch

from .. import kernels

__all__ = [
    "blocked_plan",
    "gauss_jordan_inv_bl",
    "gauss_jordan_inv_blocked",
    "gauss_jordan_inv_blocked_plain",
    "gauss_jordan_inv_plain",
    "gauss_jordan_inv_select",
    "gauss_jordan_inv_select_plain",
    "gauss_jordan_inv_wide",
    "kernel_for",
    "launch_plan",
    "register_plan",
    "select_variant",
    "team_shape",
    "wide_gj_plan",
]

K4_MAX_N = 32  # K4's largest instantiation (csrc/gauss_jordan.cu)
SELECT_MAX_N = 72  # K5: up to k = 6 (the JAX Pallas gate is n <= 48, smallinv.py:111-117)
PLAN_KEYS = {
    "gauss_jordan": ("N", "R", "C", "BB", "threads", "smem_bytes"),
    "gauss_jordan_select": ("N", "R", "C", "BB", "threads", "smem_bytes", "G"),
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
# K5b, the blocked path (csrc/gauss_jordan_wide.cu gauss_jordan_blocked):
# panels of b pivots, 64 x 64 update tiles, a block-major workspace of
# `chunk` blocks at a time (n^2 + 2 b n scalars each) within
# WIDE_GJ_WS_BYTES, and never past WIDE_GJ_WS_MAX for one block
WIDE_GJ_PANEL = 32  # the panel width the kernel is built for
WIDE_GJ_TILE = 64
WIDE_GJ_WS_BYTES = 64 << 20
WIDE_GJ_WS_MAX = 256 << 20
WIDE_GJ_PANEL_THREADS = 256
WIDE_GJ_GRID_Z = 65535  # blocks of a chunk: the update's grid z
# Where a one-process A/B on the card (tools/ab_gj.py, chip_smoke.py phase
# (o); NVIDIA H100 80GB HBM3, 700.00 W) timed K5b against the register-tile
# or cluster plan: the faster, by (n, dtype) (float64 n = 182, 1,024 blocks:
# K5b 3.89 ms, the cluster of 2 4.81 ms; float32 n = 110, 32,768 blocks:
# the tiles 9.49 ms, K5b 20.86 ms).  Past a cluster of 8 K5b is the only
# plan; other widths keep the register tiles or the cluster (not measured).
WIDE_GJ_MEASURED = {(182, torch.float64): "blocked", (110, torch.float32): "tiles"}
# K5's variant by (instantiated N, dtype), from a one-process A/B of the two
# variants on 32,768 blocks (tools/ab_gj.py, tools/tune_gj.py --team,
# chip_smoke.py phase (n); NVIDIA H100 80GB HBM3, 700.00 W): 0 PR 4's
# register-tiled template, 1 the team design; an N not listed takes 0.
# (f32 ms, variant 0 against 1: 0.398/0.647, 1.175/0.777, 1.589/1.213,
# 3.141/2.345 at N = 42, 48, 56, 72; f64: 1.139/1.323, 2.628/1.543,
# 3.351/2.292, 8.474/4.579.)
SELECT_MEASURED = {(42, torch.float32): 0, (48, torch.float32): 1, (56, torch.float32): 1,
                   (72, torch.float32): 1, (42, torch.float64): 0, (48, torch.float64): 1,
                   (56, torch.float64): 1, (72, torch.float64): 1}
SELECT_N = (20, 42, 48, 56, 72)  # K5's instantiations
# K5's team design (csrc/gauss_jordan_team.cuh): (BB teams a thread block,
# G groups of BB blocks it stages at once) by dtype and N, as GtPlan
# instantiates them (tools/tune_gj.py --team)
SELECT_TEAM_PLAN = {torch.float32: {20: (4, 1), 42: (4, 2), 48: (4, 2), 56: (4, 1), 72: (8, 1)},
                    torch.float64: {20: (2, 1), 42: (2, 2), 48: (2, 2), 56: (2, 2), 72: (4, 1)}}
TEAM_TR = 8  # a team's tile rows and columns: 64 threads, two warps


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


def team_shape(N, dtype, BB=None, G=None):
    """The shape of K5's team design at instantiation N (GtShape of
    csrc/gauss_jordan_team.cuh): an R x R register tile a thread (and R
    pivots a panel), TR x TR threads a block (a team), BB teams a thread
    block and G groups of BB blocks it stages at once (by default
    :data:`SELECT_TEAM_PLAN`'s), ``vec`` scalars a 16-byte vector, a tile's
    row of a panel buffer padded to ``rp`` scalars, ``panel`` = two panel
    buffers of R rows (A[P,:], R', and each of the two N'^T buffers is
    one), a staged block of ``plane`` scalars (which also holds its team's
    2 ``panel`` buffers), and the thread block's threads and shared
    bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    bb, g = SELECT_TEAM_PLAN[dtype][N]
    BB, G = BB or bb, G or g
    R = -(-N // TEAM_TR)
    vec = 16 // size
    rp = -(-R // vec) * vec
    plane = -(-N * N // 32) * 32 + -(-(32 // (G * BB)) // vec) * vec
    return {"N": N, "R": R, "TR": TEAM_TR, "BB": BB, "G": G, "vec": vec, "rp": rp,
            "panel": 2 * R * TEAM_TR * rp, "plane": plane, "threads": TEAM_TR * TEAM_TR * BB,
            "smem_bytes": G * BB * plane * size}


def gauss_jordan_inv_blocked_plain(A, b=WIDE_GJ_PANEL):
    """Plain PyTorch Gauss-Jordan over panels of ``b`` pivots (K5b's steps;
    the last panel may be narrower), the plain version's pivot steps
    regrouped: per panel P,
    1. the panel's pivot steps on its own rows (the plain version's
       arithmetic), recording each pivot row k as it is at its pivot,
       scaled (``Rt``), and each other panel row's multiplier at pivot k
       (``mult``);
    2. every other row's multipliers, F[i, k] = A[i, P_k] at pivot k (a
       forward recurrence over the panel's pivots);
    3. the rank-b update A <- A0 + N' R'' (A0: A with the rows and columns of
       P zeroed; N' = -F off P, on P the identity above the panel rows'
       later multipliers; R'' = Rt, zero above the diagonal on P's columns),
    which is the plain version's updates of every entry, summed in the same
    order.  (Inverting A[P,P] first and multiplying by it is the same in
    exact arithmetic but loses most of the float64 accuracy on the blocks of
    k = 18.)"""
    W = A.permute(2, 0, 1).clone()  # (B, n, n)
    n = W.shape[1]
    for k0 in range(0, n, b):
        P = slice(k0, min(k0 + b, n))
        bt = P.stop - k0
        rows = W[:, P, :].clone()
        Rt = torch.empty_like(rows)
        mult = torch.zeros(W.shape[0], bt, bt, dtype=W.dtype, device=W.device)
        for k in range(bt):  # 1.
            g = k0 + k
            inv_p = 1.0 / rows[:, k, g]
            rk = rows[:, k, :] * inv_p[:, None]
            rk[:, g] = inv_p
            Rt[:, k, :] = rk
            f = rows[:, :, g].clone()
            f[:, k] = 0.0
            mult[:, :, k] = f
            rows -= f[:, :, None] * rk[:, None, :]
            rows[:, :, g] = -f * inv_p[:, None]
            rows[:, k, :] = rk
        F = W[:, :, P].clone()  # 2.
        for k in range(bt):
            for j in range(k):
                F[:, :, k] -= F[:, :, j] * Rt[:, j, k0 + k][:, None]
        Np = -F  # 3.
        Np[:, P, :] = torch.eye(bt, dtype=W.dtype, device=W.device) - torch.triu(mult, 1)
        Rpp = Rt.clone()
        Rpp[:, :, P] = torch.tril(Rt[:, :, P])
        W[:, P, :] = 0.0
        W[:, :, P] = 0.0
        W = torch.baddbmm(W, Np, Rpp)
    return W.permute(1, 2, 0).contiguous()


def blocked_plan(n, dtype, b=None, ws_bytes=None):
    """K5b's launch plan for (n, n) blocks of ``dtype``: ``b`` pivots a panel
    (:data:`WIDE_GJ_PANEL`, the one width built), 64 x 64 update tiles, ``chunk`` blocks a pass
    of the workspace (as many as :data:`WIDE_GJ_WS_BYTES`, or ``ws_bytes``,
    holds, at least one), the update kernel's ``threads`` (128 warps of DMMA
    in float64, 256 FFMA threads in float32) and ``smem_bytes``, the panel
    kernel's ``panel_threads`` and ``panel_smem_bytes``, ``tiles`` a block's
    update tiles a side and the workspace bytes a block.  Raises
    NotImplementedError where one block's workspace passes
    :data:`WIDE_GJ_WS_MAX` (float64 n > 5,760)."""
    size = torch.empty((), dtype=dtype).element_size()
    b = b or WIDE_GJ_PANEL
    if b != WIDE_GJ_PANEL:
        raise ValueError(f"gauss_jordan_wide: no blocked plan with panels of {b}")
    per = (n * n + 2 * b * n) * size
    if per > WIDE_GJ_WS_MAX:
        raise NotImplementedError(
            f"gauss_jordan_wide: one block at n = {n} needs {per} B of workspace, past the "
            f"{WIDE_GJ_WS_MAX} B the blocked path allocates")
    chunk = max(1, min(WIDE_GJ_GRID_Z, (ws_bytes or WIDE_GJ_WS_BYTES) // per))
    return {"path": "blocked", "b": b, "tile": WIDE_GJ_TILE, "chunk": chunk,
            "threads": 128 if size == 8 else 256,
            "smem_bytes": 2 * b * (WIDE_GJ_TILE + 4) * size,
            "panel_threads": WIDE_GJ_PANEL_THREADS, "panel_smem_bytes": (3 * b * b + b) * size,
            "tiles": -(-n // WIDE_GJ_TILE), "workspace_bytes_per_block": per}


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
    cannot hold a block's tiles; "blocked": K5b (:func:`blocked_plan`),
    where no cluster of 8 holds a block, and where :data:`WIDE_GJ_MEASURED`
    names it the faster.  ``smem_bytes``: the pivot buffers a thread block
    stages.  The tile R is the first of the dtype's list whose padded work
    (TR R / n)^2 stays within :data:`WIDE_GJ_WASTE` on the fewest thread
    blocks a block; ``R``, ``BB`` and ``CS`` fix a register-tile plan
    (tools/tune_gj.py), and a fixed plan that does not fit raises
    ValueError.  Raises NotImplementedError past every plan (float64
    n > 5,760)."""
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
    plan = register_plan(n, dtype)
    if plan is not None and WIDE_GJ_MEASURED.get((n, dtype)) != "blocked":
        return plan
    return blocked_plan(n, dtype)


def register_plan(n, dtype):
    """K5w's register-tile or cluster plan for (n, n) blocks of ``dtype`` as
    :func:`wide_gj_plan` chooses it, whatever :data:`WIDE_GJ_MEASURED`
    says; None past a cluster of 8."""
    size = torch.empty((), dtype=dtype).element_size()
    tiles = WIDE_GJ_TILES[dtype]
    plans = [p for p in (_tile_plan(n, size, r, m) for r, m in tiles.items()) if p]
    if not plans:
        return None
    return min(plans, key=lambda p: (p["CS"], p["waste"] > WIDE_GJ_WASTE,
                                     list(tiles).index(p["R"])))


def select_variant(n, dtype):
    """K5's variant for (n, n) blocks of ``dtype``: :data:`SELECT_MEASURED`
    at the instantiation N >= n that holds them, else 0."""
    N = next(N for N in SELECT_N if N >= n)
    return SELECT_MEASURED.get((N, dtype), 0)


def _launch_gj(name, A, max_n=None, variant=None):
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
    if name == "gauss_jordan_select":
        plan = (select_variant(n, A.dtype) if variant is None else variant,)
    elif name == "gauss_jordan_wide":
        p = wide_gj_plan(n, A.dtype)
        if p["path"] == "blocked":
            return _launch_blocked(A, out, p)
        plan = (0, p["R"], p["BB"], p["CS"], p["threads"], p["smem_bytes"])
    kernels.launch(name, dev, code, n, A.data_ptr(), out.data_ptr(), B, *plan,
                   kernels.stream_ptr(A))
    return out


def _launch_blocked(A, out, p):
    """K5b on contiguous ``A`` (n, n, B) into ``out`` under plan ``p``: the
    workspace of min(B, chunk) blocks comes from PyTorch's allocator."""
    n, _, B = A.shape
    dev, code = kernels.check_cuda("gauss_jordan_blocked", A, out)
    chunk = min(B, p["chunk"])
    ws = torch.empty(chunk * (n * n + 2 * p["b"] * n), dtype=A.dtype, device=A.device)
    kernels.launch("gauss_jordan_blocked", dev, code, n, A.data_ptr(), out.data_ptr(), B,
                   ws.data_ptr(), p["b"], p["tile"], chunk, p["threads"], p["smem_bytes"],
                   p["panel_threads"], p["panel_smem_bytes"], kernels.stream_ptr(A))
    return out


def launch_plan(name, dtype, n, variant=None):
    """Launch plan of kernel ``name`` ("gauss_jordan", "gauss_jordan_select",
    "gauss_jordan_wide" or "gauss_jordan_blocked") for (n, n) blocks of
    ``dtype``.  K4, K5, from their library (built first if needed): the
    instantiation N >= n, the R x C register tile of a thread, the BB blocks
    of a thread block, its threads and its shared-memory bytes (K5: of
    ``variant``, by default the dispatch's, which the plan names); K5w:
    :func:`wide_gj_plan`; K5b: :func:`blocked_plan`."""
    if name == "gauss_jordan_wide":
        return wide_gj_plan(n, dtype)
    if name == "gauss_jordan_blocked":
        return blocked_plan(n, dtype)
    keys = PLAN_KEYS[name]
    args = ()
    if name == "gauss_jordan_select":
        variant = select_variant(n, dtype) if variant is None else variant
        args = (variant,)
    fn = getattr(kernels._get(name), f"iehdg_{name}_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_int] * len(args),
                   ctypes.POINTER(ctypes.c_int)]
    plan = (ctypes.c_int * len(keys))(*[1] * len(keys))  # K5's variant 0 leaves G at 1
    if fn(kernels.dtype_code(dtype), int(n), *args, plan) != 0:
        raise ValueError(f"{name}: no launch plan for n = {n}")
    out = dict(zip(keys, plan))
    if name == "gauss_jordan_select":
        out["variant"] = variant
    return out


def gauss_jordan_inv_select(A, variant=None):
    """K5: inverse of every (n, n) block of a batch-last (n, n, B) tensor,
    n <= 72, by the masked-select Gauss-Jordan (``variant`` 0 or 1 fixes
    the design; by default :func:`select_variant`)."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_select_plain(A)
    return _launch_gj("gauss_jordan_select", A, SELECT_MAX_N, variant)


def gauss_jordan_inv_wide(A):
    """K5w: inverse of every (n, n) block of a batch-last (n, n, B) tensor,
    any n, by the plain version's pivot steps (K5b's panels where
    :func:`wide_gj_plan` says "blocked")."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_plain(A)
    return _launch_gj("gauss_jordan_wide", A)


def gauss_jordan_inv_blocked(A, plan=None):
    """K5b on its own: inverse of every (n, n) block of a batch-last (n, n,
    B) tensor, any n, panel by panel (``plan`` from :func:`blocked_plan`,
    by default its own)."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_blocked_plain(A, (plan or {}).get("b", WIDE_GJ_PANEL))
    n, n2, B = A.shape
    if n != n2:
        raise ValueError(f"gauss_jordan_blocked: blocks must be square, got {tuple(A.shape)}")
    A = A.contiguous()
    kernels.check_cuda("gauss_jordan_blocked", A)
    out = torch.empty_like(A)
    if B == 0:
        return out
    return _launch_blocked(A, out, plan or blocked_plan(n, A.dtype))


def kernel_for(n, dtype=None):
    """Name of the kernel :func:`gauss_jordan_inv_bl` launches for (n, n)
    blocks: K4 up to n = 32, K5 up to 72, K5w above (with ``dtype``, K5b,
    "gauss_jordan_blocked", where :func:`wide_gj_plan` takes it)."""
    if n <= K4_MAX_N:
        return "gauss_jordan"
    if n <= SELECT_MAX_N:
        return "gauss_jordan_select"
    if dtype is not None and wide_gj_plan(n, dtype)["path"] == "blocked":
        return "gauss_jordan_blocked"
    return "gauss_jordan_wide"


def gauss_jordan_inv_bl(A):
    """Inverse of every (n, n) block of a batch-last (n, n, B) tensor."""
    if A.device.type == "cpu":
        return gauss_jordan_inv_plain(A)
    return _launch_gj(kernel_for(A.shape[0]), A)
