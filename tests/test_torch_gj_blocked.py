"""K5b, the blocked Gauss-Jordan inverse (csrc/gauss_jordan_wide.cu
``gauss_jordan_blocked``), and K5's team design (csrc/gauss_jordan_team.cuh),
on the CPU (no card, no nvcc), against the JAX package in float64.

- ``smallinv.gauss_jordan_inv_blocked_plain``, the panel steps in PyTorch,
  per block against the JAX fallback ``gauss_jordan_inv_bl`` (its jnp pivot
  loop) at n = 100 with b = 32 (a tail panel of 4) and b = 64, and at
  n = 420 with b = 32 on 2 blocks, to 1e-12 relative; the CPU wrappers run
  the plain versions;
- ``smallinv.blocked_plan``: the panel kernel's threads own every entry of
  the diagonal block once and its work items every entry of N' and R' once,
  the update tiles every (block, i, j) once (tests/test_torch_cluster.py
  holds the update's threads), within the H100's limits; the workspace cap;
- ``smallinv.team_shape`` at n = 42, 48, 56, 72: the stage loads every
  (block, entry) of a thread block's batch once and the teams' threads read
  every (block, i, j) of it once; the panels (one tile row each) cover
  every pivot once; a panel buffer's slots are distinct, its vectors
  16-byte aligned, and both buffers fit in the team's plane; limits;
- the measured dispatch tables ``SELECT_MEASURED`` and ``WIDE_GJ_MEASURED``,
  as tests/test_torch_cross_cluster.py holds ``CROSS_PAIR_MEASURED``;
- on a CUDA card only: K5b at float64 n = 100, 420 and float32 n = 552
  against its plain version and twin, both panel widths, and K5's team
  variant at n = 33 .. 72 against its plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.linalg.smallinv import gauss_jordan_inv_bl as j_gj

from incompressibleeulerhdg_tpu_torch import kernels
from incompressibleeulerhdg_tpu_torch.linalg import smallinv as TI

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]
SIZE = {torch.float32: 4, torch.float64: 8}


def _blocks(n, m, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n, m)) * 0.1 + 3.0 * np.eye(n)[:, :, None]


def _per_block_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float((np.abs(got - ref).max(axis=(0, 1)) / np.abs(ref).max(axis=(0, 1))).max())


@pytest.mark.parametrize("n, b, m", [(100, 32, 3), (100, 64, 3), (420, 32, 2)])
def test_blocked_plain_matches_fallback(n, b, m):
    """The panel steps against the JAX fallback's pivot loop, per block."""
    A = _blocks(n, m, n + b)
    ref = np.asarray(j_gj(jnp.asarray(A)))
    got = TI.gauss_jordan_inv_blocked_plain(torch.as_tensor(A), b)
    assert got.shape == (n, n, m)
    assert _per_block_rel(got.numpy(), ref) <= 1e-12
    assert _per_block_rel(TI.gauss_jordan_inv_plain(torch.as_tensor(A)).numpy(), ref) <= 1e-12


def test_blocked_cpu_wrappers_run_plain():
    """On the CPU K5b's wrapper is its plain twin, K5w's and the dispatch
    the pivot loop; nothing launches; the wrappers refuse meta tensors for
    want of a CUDA tensor."""
    A = torch.as_tensor(_blocks(70, 3, 7))
    kernels.reset_launches()
    assert torch.equal(TI.gauss_jordan_inv_blocked(A), TI.gauss_jordan_inv_blocked_plain(A))
    assert torch.equal(TI.gauss_jordan_inv_blocked(A, TI.blocked_plan(70, A.dtype, ws_bytes=1)),
                       TI.gauss_jordan_inv_blocked_plain(A, TI.WIDE_GJ_PANEL))
    assert torch.equal(TI.gauss_jordan_inv_wide(A), TI.gauss_jordan_inv_plain(A))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="gauss_jordan_blocked.*CUDA"):
        TI.gauss_jordan_inv_blocked(torch.empty(420, 420, 4, device="meta", dtype=torch.float64))
    with pytest.raises(ValueError, match="gauss_jordan_wide.*CUDA"):  # before it plans
        TI.gauss_jordan_inv_bl(torch.empty(420, 420, 4, device="meta", dtype=torch.float64))


@pytest.mark.parametrize("n", [100, 130, 385, 420, 541, 552, 1000, 2048])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_blocked_plan_panel_work(n, dtype):
    """The panel kernel: its threads own every (r, c) of the b x b diagonal
    block once (entries tid + s 256), its column items (one a column off
    the panel; the panel's b columns apart) cover every (r, j) of R'' once
    (N' is one row a thread); the update grid's tiles cover
    every (i, j) once; threads, shared bytes, the grid and the workspace
    within their limits."""
    p = TI.blocked_plan(n, dtype)
    b, size = p["b"], SIZE[dtype]
    assert b == TI.WIDE_GJ_PANEL and p["tile"] == 64 and p["panel_threads"] == 256
    assert p["panel_smem_bytes"] == (3 * b * b + b) * size <= TI.SMEM_MAX
    assert p["smem_bytes"] == 2 * b * 68 * size <= TI.SMEM_MAX
    assert p["threads"] == (128 if dtype == torch.float64 else 256)
    per = (n * n + 2 * b * n) * size
    assert p["workspace_bytes_per_block"] == per
    assert p["chunk"] == max(1, min(TI.WIDE_GJ_GRID_Z, TI.WIDE_GJ_WS_BYTES // per))
    assert p["chunk"] * per <= max(TI.WIDE_GJ_WS_BYTES, per)
    per_thread = b * b // p["panel_threads"]
    idx = np.arange(p["panel_threads"])[:, None] + p["panel_threads"] * np.arange(per_thread)
    d = np.zeros((b, b), dtype=int)
    np.add.at(d, (idx // b, idx % b), 1)
    assert (d == 1).all()
    k0 = (n - 1) // b * b  # the last panel, bt = n - k0 pivots
    bt = n - k0
    rt = np.zeros((b, n), dtype=int)
    for j in set(range(n)) - set(range(k0, k0 + bt)):  # a column a thread: rows 0 .. b
        rt[:, j] += 1
    idx = np.arange(b * bt)  # the panel's columns: (k, c) = (idx / bt, idx % bt)
    np.add.at(rt, (idx // bt, k0 + idx % bt), 1)
    assert (rt == 1).all() and 1 <= bt <= b
    cover = np.zeros((p["tiles"] * 64, p["tiles"] * 64), dtype=int)
    for ti in range(p["tiles"]):
        for tj in range(p["tiles"]):
            cover[ti * 64:(ti + 1) * 64, tj * 64:(tj + 1) * 64] += 1
    assert (cover[:n, :n] == 1).all() and p["tiles"] * 64 - n < 64


def test_blocked_plan_limits():
    """The workspace cap: float64 n = 5,760 takes one block a pass, 8,000
    raises NotImplementedError naming K5w; a panel width the kernel is not
    built for raises ValueError; the budget sets the chunk."""
    assert TI.blocked_plan(5760, torch.float64)["chunk"] == 1
    with pytest.raises(NotImplementedError, match="gauss_jordan_wide"):
        TI.blocked_plan(8000, torch.float64)
    for b in (48, 64):
        with pytest.raises(ValueError, match=f"panels of {b}"):
            TI.blocked_plan(420, torch.float64, b=b)
    per = TI.blocked_plan(420, torch.float64)["workspace_bytes_per_block"]
    assert TI.blocked_plan(420, torch.float64, ws_bytes=10 * per)["chunk"] == 10
    assert TI.blocked_plan(420, torch.float64, ws_bytes=1)["chunk"] == 1


@pytest.mark.parametrize("N", [42, 48, 56, 72])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_team_shape_loads_and_owns_once(N, dtype):
    """K5's team design at N (n = N and n = N - 5): the stage's loads
    x = e GB + b cover every (block, entry) of the thread block's GB = G BB
    blocks once; in group g the threads of team t (tid / 64) read every
    (g BB + t, i, j) with i, j < n once from the stage (their R x R tiles),
    so every staged block is inverted once; the panels (tile rows
    kt with kt R < n) take every pivot once; a panel buffer row's slots
    ((l / vec) TR + s) vec + l % vec are distinct and within the row, each
    vector 16-byte aligned, and two panels' N'^T and R' fit in the team's
    plane; threads, named barriers and shared bytes within the H100's
    limits."""
    sh = TI.team_shape(N, dtype)
    BB, R, TR, vec, rp = sh["BB"], sh["R"], sh["TR"], sh["vec"], sh["rp"]
    GB = sh["G"] * BB
    assert TR * R >= N and R == -(-N // TR)
    assert sh["threads"] == 64 * BB <= 1024 and 1 <= BB <= 15
    assert sh["smem_bytes"] == GB * sh["plane"] * SIZE[dtype] <= TI.SMEM_MAX
    assert 2 * sh["panel"] <= sh["plane"] and (sh["plane"] * SIZE[dtype]) % 16 == 0
    assert sh["panel"] == 2 * R * TR * rp and (TR * rp * SIZE[dtype]) % 16 == 0
    for n in (N, N - 5):
        x = np.arange(GB * n * n)
        stage = np.zeros((GB, n * n), dtype=int)
        np.add.at(stage, (x % GB, x // GB), 1)
        assert (stage == 1).all()
        tid = np.arange(sh["threads"])
        team, pos = tid // (TR * TR), tid % (TR * TR)
        tr, tc = pos // TR, pos % TR
        seen = np.zeros((GB, n, n), dtype=int)
        for g in range(sh["G"]):  # group g: team t takes the stage's block g BB + t
            for li in range(R):
                for lj in range(R):
                    i, j = tr * R + li, tc * R + lj
                    keep = (i < n) & (j < n)
                    np.add.at(seen, (g * BB + team[keep], i[keep], j[keep]), 1)
        assert (seen == 1).all()
        pivots = np.concatenate([np.arange(kt * R, (kt + 1) * R) for kt in range(TR) if kt * R < n])
        assert (np.sort(pivots[pivots < n]) == np.arange(n)).all()
    s, l = np.meshgrid(np.arange(TR), np.arange(R), indexing="ij")
    slot = ((l // vec) * TR + s) * vec + l % vec
    assert len(np.unique(slot)) == TR * R and slot.max() < TR * rp
    assert ((((np.arange(rp // vec)[:, None] * TR + np.arange(TR)) * vec) * SIZE[dtype]) % 16
            == 0).all()


def test_measured_tables():
    """The dispatch takes what the one-process A/Bs measured faster: K5's
    variant by instantiation N and dtype (every n that N holds), and K5b or
    the register-tile plan of K5w by (n, dtype); K5b past a cluster of 8
    whatever the table says; ``kernel_for`` with a dtype names K5b there."""
    for (N, dtype), v in TI.SELECT_MEASURED.items():
        assert N in TI.SELECT_N and v in (0, 1)
        lo = max(n for n in (32, *TI.SELECT_N) if n < N)
        for n in range(lo + 1, N + 1):
            assert TI.select_variant(n, dtype) == v
    for dtype in DTYPES:
        assert TI.select_variant(20, dtype) == TI.SELECT_MEASURED.get((20, dtype), 0)
        assert set(TI.SELECT_TEAM_PLAN[dtype]) == set(TI.SELECT_N)
    for (n, dtype), path in TI.WIDE_GJ_MEASURED.items():
        assert path in ("tiles", "cluster", "blocked")
        assert TI.wide_gj_plan(n, dtype)["path"] == path
        assert (TI.kernel_for(n, dtype) == "gauss_jordan_blocked") == (path == "blocked")
    for n, dtype in ((420, torch.float64), (552, torch.float32), (1000, torch.float64)):
        assert TI.wide_gj_plan(n, dtype)["path"] == "blocked"
        assert TI.kernel_for(n, dtype) == "gauss_jordan_blocked"
        assert TI.kernel_for(n) == "gauss_jordan_wide"


# ----------------------------------------------------------------------
# CUDA card only
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("n, dtype, m", [(100, torch.float64, 37), (420, torch.float64, 32),
                                         (552, torch.float32, 8)])
@pytest.mark.parametrize("one_a_pass", [True, False])
def test_cuda_blocked(cuda, n, dtype, m, one_a_pass):
    """K5b against the plain version per block (float64 to 1e-11; float32 to
    twice the plain version's own error against the float64 plain inverse)
    and against its plain twin, on a batch and on a non-contiguous one, with
    one block a pass of the workspace or the default chunk; every call
    launches K5b once."""
    b = TI.WIDE_GJ_PANEL
    A = torch.as_tensor(_blocks(n, 2 * m, n + b), dtype=dtype).to(cuda)
    p = TI.blocked_plan(n, dtype, ws_bytes=1 if one_a_pass else None)
    kernels.reset_launches()
    for X in (A[:, :, :m], A[:, :, 1::2]):
        ref = TI.gauss_jordan_inv_plain(X)
        ref64 = TI.gauss_jordan_inv_plain(X.double())
        rel = lambda g, r: float(((g - r).abs().amax(dim=(0, 1)) / r.abs().amax(dim=(0, 1))).max())
        tol = 1e-11 if dtype == torch.float64 else 2.0 * rel(ref.double(), ref64)
        for plan in (p, None):
            got = TI.gauss_jordan_inv_blocked(X, plan)
            assert rel(got, ref) <= tol
            assert rel(got, TI.gauss_jordan_inv_blocked_plain(X, b)) <= max(tol, 1e-11)
    assert kernels.LAUNCHES["gauss_jordan_blocked"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 42, 48, 49, 56, 57, 72])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cuda_select_team(cuda, n, dtype):
    """K5's team variant against the plain version on batches around its
    thread block's, and its plan from the library as team_shape describes
    it."""
    sh = TI.team_shape(next(N for N in TI.SELECT_N if N >= n), dtype)
    plan = TI.launch_plan("gauss_jordan_select", dtype, n, variant=1)
    assert (plan["R"], plan["BB"], plan["threads"], plan["smem_bytes"], plan["G"]) == \
        (sh["R"], sh["BB"], sh["threads"], sh["smem_bytes"], sh["G"])
    tol = 5e-5 if dtype == torch.float32 else 1e-11
    for m in (1, sh["BB"] + 1, sh["G"] * sh["BB"] + 3, 777):
        A = torch.as_tensor(_blocks(n, m, m), dtype=dtype).to(cuda)
        ref = TI.gauss_jordan_inv_plain(A)
        assert float((TI.gauss_jordan_inv_select(A, variant=1) - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_wide_cluster_plan_182(cuda):
    """K5w's cluster plan at float64 n = 182 (the dispatch takes K5b there),
    launched through its C entry point, against the plain version."""
    n, dtype = 182, torch.float64
    p = TI.wide_gj_plan(n, dtype, R=8)
    assert p["path"] == "cluster"
    A = torch.as_tensor(_blocks(n, 37, 182), dtype=dtype).to(cuda)
    out = torch.empty_like(A)
    kernels.launch("gauss_jordan_wide", 0, kernels.dtype_code(dtype), n, A.data_ptr(),
                   out.data_ptr(), A.shape[2], 0, p["R"], p["BB"], p["CS"], p["threads"],
                   p["smem_bytes"], kernels.stream_ptr(A))
    ref = TI.gauss_jordan_inv_plain(A)
    assert float(((out - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max()) <= 1e-11
