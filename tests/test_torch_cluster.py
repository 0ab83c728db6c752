"""The launch plans of K5w (csrc/gauss_jordan_wide.cu) and K3w
(csrc/patch_solve_wide.cu), which split a block's or a facet tile's rows
over a thread-block cluster, and the width dispatch, on the CPU (no card,
no nvcc).

- ``smallinv.wide_gj_plan`` at n = 90, 110, 132, 182, 506 in float32 and
  float64: the threads of every rank, mapped to (batch entry, tile row,
  tile column) as the kernel maps them, own every tile of every batch entry
  exactly once (the blocked path, K5b: in every panel every entry (i, j)
  of every block is owned by exactly one update tile and one thread's
  accumulator); shared bytes, threads, the cluster size and the grid stay
  within the H100's limits; a plan raises only past every plan;
- ``preconditioners.patch_wide_plan`` at d1 = 28, 36, 45, 55, 78, 81, 91,
  105, 120, 128, 200 in float32 and float64: the ranks own every scalar
  row once, the threads every (component, row, facet) of a rank once,
  within the same limits (every cluster plan at each width); where no
  (F, CS) fits (from d1 = 81: k = 11 .. 14, and past a TMA box's 256 rows)
  the plan without a cluster, whose row slots own every row once;
  NotImplementedError only past both;
- ``patch_wide_plan`` with bfloat16 factors (``IEHDG_PC_BF16=1``) at d1
  = 21, 28, 45, 55, 66, 78, 91, 128: the same ownership and limits, the staged
  rows of Dinv0 counted at 2 bytes an entry and the vectors at 4, a
  cluster rank's bytes below float32's; past d1 = 80 the plan without a
  cluster;
- the dispatch: ``width_kernels`` at d1 = 21, 28, 36 sends the patch
  solve to K3w, K1 to its own instantiations and the cross pair to K2c
  (at d1 = 45 too); ``kernel_for`` by n;
- on a CUDA card only: K3w at d1 = 28, 36, 45, 55, 91, 105, 136 and K5w
  at n = 90, 110 and float64 182 (the cluster path) against their plain
  versions are tests/test_torch_wide.py's ``cuda``-marked cases; here every
  plan K3w may take at d1 = 45 and 91 (the plan without a cluster too)
  against the plain version, and K3w's bfloat16-factor variant under its
  default plan at d1 = 21, 45, 91 and under every plan at d1 = 45.
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu_torch import kernels
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg import smallinv as TI

DTYPES = [torch.float32, torch.float64]
SIZE = {torch.float32: 4, torch.float64: 8}


def _gj_tile_owners(plan):
    """(batch entry, tile row, tile column) of every active thread of every
    rank, as gauss_jordan_wide_kernel maps threadIdx.x and the cluster rank."""
    TR, BB, CS, rpc = plan["TR"], plan["BB"], plan["CS"], plan["rows_per_rank"]
    tid = np.arange(plan["threads"])
    b, pos = tid % BB, tid // BB
    owners = []
    for rank in range(CS):
        tr, tc = rank * rpc + pos // TR, pos % TR
        act = tr < TR
        owners.append(np.stack([b[act], tr[act], tc[act]], axis=1))
    return np.concatenate(owners)


def _blocked_owners(plan, n, batch):
    """(block, i, j) of every accumulator of every thread of every update
    tile of K5b's update kernel, as it maps them (float64: four warps of
    4 x 4 DMMA tiles, accumulator rows lane / 4, columns 2 (lane % 4) + h;
    float32: a 4 x 4 register tile a thread), past-n entries dropped."""
    T = plan["tile"]
    tid = np.arange(plan["threads"])
    if plan["threads"] == 128:
        warp, lane = tid // 32, tid % 32
        wi, wj, g, t = (warp // 2) * 32, (warp % 2) * 32, lane // 4, lane % 4
        parts = [(wi + mi * 8 + g, wj + ni * 8 + 2 * t + h)
                 for mi in range(4) for ni in range(4) for h in range(2)]
    else:
        ri, cj = 4 * (tid // 16), 4 * (tid % 16)
        parts = [(ri + a, cj + b) for a in range(4) for b in range(4)]
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    owners = []
    for blk in range(batch):
        for ti in range(plan["tiles"]):
            for tj in range(plan["tiles"]):
                i, j = ti * T + r, tj * T + c
                keep = (i < n) & (j < n)
                owners.append(np.stack([np.full(keep.sum(), blk), i[keep], j[keep]], axis=1))
    return np.concatenate(owners)


@pytest.mark.parametrize("n", [90, 110, 132, 182, 506])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_wide_gj_plan_owns_every_tile_once(n, dtype):
    plan = TI.wide_gj_plan(n, dtype)
    assert plan["smem_bytes"] <= TI.SMEM_MAX
    if plan["path"] == "blocked":
        assert plan["threads"] <= 1024 and plan["panel_threads"] <= 1024
        assert plan["smem_bytes"] == 2 * plan["b"] * (plan["tile"] + 4) * SIZE[dtype]
        assert plan["panel_smem_bytes"] == (3 * plan["b"] ** 2 + plan["b"]) * SIZE[dtype]
        assert plan["panel_smem_bytes"] <= TI.SMEM_MAX
        assert plan["tiles"] == -(-n // plan["tile"]) and plan["tiles"] <= 65535
        assert 1 <= plan["chunk"] <= TI.WIDE_GJ_GRID_Z
        count = np.zeros((3, n, n), dtype=int)  # the same update tiles in every panel
        for blk, i, j in _blocked_owners(plan, n, 3):
            count[blk, i, j] += 1
        assert (count == 1).all()
        if TI.WIDE_GJ_MEASURED.get((n, dtype)) != "blocked":  # past a cluster of 8:
            with pytest.raises(ValueError):  # no register tile holds this block on 8 ranks
                TI.wide_gj_plan(n, dtype, R=max(TI.WIDE_GJ_TILES[dtype]), CS=8)
        return
    assert plan["CS"] <= TI.WIDE_GJ_CLUSTER_MAX
    R, TR = plan["R"], plan["TR"]
    assert R in TI.WIDE_GJ_TILES[dtype] and TR == -(-n // R)
    assert plan["threads"] <= TI.WIDE_GJ_TILES[dtype][R]
    assert plan["threads"] == plan["BB"] * plan["rows_per_rank"] * TR
    assert plan["smem_bytes"] == (4 * TR * (R | 1) * plan["BB"] + 2 * plan["BB"]) * SIZE[dtype]
    assert (plan["path"] == "cluster") == (plan["CS"] > 1)
    owners = _gj_tile_owners(plan)
    assert len(owners) == plan["BB"] * TR * TR
    assert len(np.unique(owners, axis=0)) == len(owners)


def test_wide_gj_plan_paths():
    """float32 n = 90, 110 on one thread block; float64 n = 182 (66,248
    registers for the block alone) on the blocked path, which the A/B
    measured faster than its register tiles split over a cluster of 2 to 4
    (the plan with R = 8 fixed); float64 n = 506 on the blocked path,
    float32 n = 506 still on a cluster; a fixed plan that does not fit
    raises ValueError, a block past every plan NotImplementedError."""
    for n in (90, 110):
        assert TI.wide_gj_plan(n, torch.float32)["path"] == "tiles"
    assert TI.wide_gj_plan(182, torch.float64)["path"] == "blocked"
    p = TI.wide_gj_plan(182, torch.float64, R=8)
    assert p["path"] == "cluster" and 2 <= p["CS"] <= 4
    assert TI.wide_gj_plan(506, torch.float64)["path"] == "blocked"
    assert TI.wide_gj_plan(506, torch.float32)["path"] == "cluster"
    assert TI.launch_plan("gauss_jordan_wide", torch.float32, 90) == \
        TI.wide_gj_plan(90, torch.float32)
    with pytest.raises(ValueError, match="gauss_jordan_wide"):
        TI.wide_gj_plan(182, torch.float64, R=6, CS=1)
    with pytest.raises(ValueError, match="no 7 x 7 tile"):
        TI.wide_gj_plan(90, torch.float32, R=7)
    with pytest.raises(NotImplementedError, match="gauss_jordan_wide"):
        TI.wide_gj_plan(8000, torch.float64)


def _patch_fits(d1, dtype):
    """Whether any (F, CS) of K3w's cluster plans fits the H100's limits."""
    size = SIZE[dtype]
    for rb in TP.PATCH_WIDE_ROW_BYTES:
        F = rb // size
        for cs in range(1, min(d1, TP.PATCH_WIDE_CLUSTER_MAX) + 1):
            rs = -(-d1 // cs)
            if 2 * d1 <= 256 and 2 * rs * F <= TP.PATCH_WIDE_THREADS_MAX and \
                    TP.patch_wide_smem(d1, F, cs, size) <= TP.SMEM_MAX:
                return True
    return False


def _patch_plans(d1, dtype, factors=None):
    """Every cluster plan K3w admits at d1 (each F and CS asked for)."""
    plans = []
    for rb in TP.PATCH_WIDE_ROW_BYTES:
        for cs in range(1, TP.PATCH_WIDE_CLUSTER_MAX + 1):
            try:
                plans.append(TP.patch_wide_plan(d1, dtype, F=rb // SIZE[dtype], CS=cs,
                                                factors=factors))
            except NotImplementedError:
                continue
    return plans


def _check_patch_cluster_plan(plan, d1, dtype, tsize=None):
    """The ranks own every scalar row once, the threads every (component,
    row, facet) of a rank once, within the H100's limits (``tsize`` the
    bytes of a factor entry, default the vectors')."""
    F, CS, RS = plan["F"], plan["CS"], plan["RS"]
    assert plan["path"] == "cluster"
    assert F * SIZE[dtype] in TP.PATCH_WIDE_ROW_BYTES
    assert 1 <= CS <= TP.PATCH_WIDE_CLUSTER_MAX == 8 and RS == -(-d1 // CS)
    assert plan["threads"] == 2 * RS * F <= TP.PATCH_WIDE_THREADS_MAX
    assert plan["smem_bytes"] == TP.patch_wide_smem(d1, F, CS, SIZE[dtype], tsize) <= TP.SMEM_MAX
    rows = []
    for rank in range(CS):  # as patch_solve_wide_kernel splits d1 and maps threadIdx.x
        i0, i1 = rank * d1 // CS, (rank + 1) * d1 // CS
        assert 1 <= i1 - i0 <= RS
        tid = np.arange(plan["threads"])
        lane, slot = tid % F, tid // F
        a = (slot >= RS).astype(int)
        il = slot - a * RS
        act = il < i1 - i0
        rows.append(np.stack([a[act], i0 + il[act], lane[act]], axis=1))
    rows = np.concatenate(rows)
    assert len(rows) == 2 * d1 * F  # every (component, row, facet) one thread
    assert len(np.unique(rows, axis=0)) == len(rows)


@pytest.mark.parametrize("d1", [28, 36, 45, 55, 78, 81, 91, 105, 120, 128, 200])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_patch_wide_plan_owns_every_row_once(d1, dtype):
    """The default plan and every cluster plan at d1: up to d1 = 80 the
    default is one of the cluster plans; past it no cluster of 8 holds a
    rank's rows of Dinv0 and the default is the plan without a cluster
    (measured faster at d1 = 91 .. 120 than clusters of up to 16 on
    32-byte table rows), whose row slots own every row once."""
    plan = TP.patch_wide_plan(d1, dtype)
    assert plan["smem_bytes"] <= TP.SMEM_MAX == 232448
    assert plan["threads"] <= TP.PATCH_WIDE_THREADS_MAX
    assert _patch_fits(d1, dtype) == (d1 <= 80)
    plans = _patch_plans(d1, dtype)
    assert bool(plans) == (d1 <= 80)
    for p in plans:
        _check_patch_cluster_plan(p, d1, dtype)
    if d1 > 80:  # one thread block a tile, Dinv0 from device memory
        F = plan["F"]
        assert plan["path"] == "device" and plan["CS"] == 0 and plan["RS"] == d1
        assert F in TP.PATCH_WIDE_DEV_FACETS and plan["threads"] == TP.PATCH_WIDE_DEV_THREADS
        assert plan["smem_bytes"] == 3 * 2 * d1 * F * SIZE[dtype]
        assert all(3 * 2 * d1 * f * SIZE[dtype] > TP.SMEM_MAX
                   for f in TP.PATCH_WIDE_DEV_FACETS if f > F)
        slots = plan["threads"] // F  # rows slot, slot + slots, ... of every lane
        count = np.zeros((2 * d1, F), dtype=int)
        for slot in range(slots):
            count[slot::slots] += 1
        assert (count == 1).all()
        return
    assert plan in plans


@pytest.mark.parametrize("d1", [21, 28, 45, 55, 66, 78, 91, 128])
def test_patch_wide_plan_bf16_factors(d1):
    """float32 vectors with bfloat16 factors: every cluster plan owns every
    row once within the limits, its staged rows of Dinv0 at 2 bytes an
    entry (the vectors at 4), fewer bytes than the float32 plan of the
    same (F, CS); past d1 = 80 the plan without a cluster, its three
    float32 vectors within a thread block; the default is the measured
    plan (tools/ab_patch.py --sweep --bf16; at d1 = 78 the plan without a
    cluster)."""
    f32, bf16 = torch.float32, torch.bfloat16
    plan = TP.patch_wide_plan(d1, f32, factors=bf16)
    assert plan["smem_bytes"] <= TP.SMEM_MAX and plan["threads"] <= TP.PATCH_WIDE_THREADS_MAX
    plans = _patch_plans(d1, f32, bf16)
    assert bool(plans) == (d1 <= TP.PATCH_WIDE_CLUSTER_D1_MAX == 80)
    assert len(plans) >= len(_patch_plans(d1, f32))
    for p in plans:
        _check_patch_cluster_plan(p, d1, f32, tsize=2)
        nu, rs = 2 * d1, p["RS"]
        assert p["smem_bytes"] == 2 * rs * -(-nu * p["F"] * 2 // 128) * 128 + \
            2 * -(-nu * p["F"] * 4 // 128) * 128 + 2 * rs * 8
        assert p["smem_bytes"] < TP.patch_wide_smem(d1, p["F"], p["CS"], 4)
    measured = TP.PATCH_WIDE_MEASURED.get((d1, bf16))
    if d1 > 80 or (measured and measured[1] == 0):
        assert (plan["path"], plan["CS"], plan["RS"]) == ("device", 0, d1)
        assert plan["smem_bytes"] == 3 * 2 * d1 * plan["F"] * 4
        assert d1 <= 80 or plan == TP.patch_wide_plan(d1, f32)
    else:
        assert plan in plans


def test_patch_wide_plan_fixed_and_past_every_plan():
    """A fixed (F, CS) that does not fit raises NotImplementedError naming
    the kernel; CS = 0 fixes the plan without a cluster at any width; a
    width past a TMA box's 256 rows takes that plan, and one whose facet
    vectors fit no thread block raises.  The default plans are the
    measured fastest on the H100 (PATCH_WIDE_MEASURED)."""
    with pytest.raises(NotImplementedError, match="patch_solve_wide"):
        TP.patch_wide_plan(45, torch.float32, F=32, CS=1)
    with pytest.raises(NotImplementedError, match="patch_solve_wide"):
        TP.patch_wide_plan(45, torch.float32, F=16, CS=9)  # past a portable cluster
    with pytest.raises(NotImplementedError, match="patch_solve_wide"):
        TP.patch_wide_plan(45, torch.float32, F=8, CS=5)  # 32-byte rows
    assert TP.patch_wide_plan(129, torch.float32)["path"] == "device"
    for dtype in DTYPES:
        assert TP.patch_wide_plan(200, dtype)["path"] == "device"
        for d1 in (91, 200):
            p = TP.patch_wide_plan(d1, dtype, CS=0)
            assert (p["path"], p["CS"], p["RS"]) == ("device", 0, d1)
    assert TP.patch_wide_plan(45, torch.float32, CS=0)["path"] == "device"
    assert TP.patch_wide_plan(45, torch.float64, F=8, CS=0)["smem_bytes"] == 3 * 90 * 8 * 8
    for d1, dtype in ((606, torch.float64), (1211, torch.float32)):
        with pytest.raises(NotImplementedError, match="patch_solve_wide"):
            TP.patch_wide_plan(d1, dtype)
    assert TP.patch_wide_plan(605, torch.float64)["F"] == 8
    p = TP.patch_wide_plan(45, torch.float32)
    assert TP.patch_wide_plan(45, torch.float32, F=p["F"], CS=p["CS"]) == p
    for (d1, factors), (F, CS) in TP.PATCH_WIDE_MEASURED.items():
        dtype = torch.float32 if factors == torch.bfloat16 else factors
        p = TP.patch_wide_plan(d1, dtype, factors=factors)
        assert (p["path"], p["F"], p["CS"]) == ("device" if CS == 0 else "cluster", F, CS)


def test_width_dispatch():
    """K1 takes its own instantiations up to d1 = 36 and K1w above; the
    cross pair K2 up to d1 = 15, K2c at d1 = 21 .. 91 (measured) and K2w
    above; the patch solve K3 up to d1 = 15 and K3w from d1 = 21; the
    Gauss-Jordan inverse K4 to n = 32, K5 to 72, K5w above."""
    assert TP.width_kernels(15) == ("fact_apply", "cross_pair", "patch_solve")
    for d1 in (21, 28, 36):
        assert TP.width_kernels(d1) == ("fact_apply", "cross_pair_cluster", "patch_solve_wide")
    assert TP.width_kernels(45) == ("fact_apply_wide", "cross_pair_cluster", "patch_solve_wide")
    assert TP.width_kernels(55) == ("fact_apply_wide", "cross_pair_cluster", "patch_solve_wide")
    assert TP.width_kernels(105) == ("fact_apply_wide", "cross_pair_cluster", "patch_solve_wide")
    assert TP.width_kernels(105, torch.float64)[1] == TP.width_kernels(120)[1] == \
        "cross_pair_wide"
    assert TP.PATCH_D1 == tuple(d for d in TP.CUDA_D1 if d <= 15)
    for n, name in ((20, "gauss_jordan"), (32, "gauss_jordan"), (42, "gauss_jordan_select"),
                    (72, "gauss_jordan_select"), (73, "gauss_jordan_wide"),
                    (90, "gauss_jordan_wide"), (182, "gauss_jordan_wide")):
        assert TI.kernel_for(n) == name


def test_wide_wrappers_refuse_cpu_free_tensors():
    """The wrappers check the device before they plan: K3w at d1 = 28 and
    K5w at n = 182 on meta tensors raise for want of a CUDA tensor."""
    d1, nu = 28, 56
    A = torch.empty(d1, d1, 10, device="meta")
    D = torch.empty(nu, nu, 10, device="meta")
    x = torch.empty(nu, 10, device="meta")
    Pm = torch.empty(nu, nu, device="meta")
    with pytest.raises(ValueError, match="patch_solve_wide.*CUDA"):
        TP.patch_solve(D, D, A, A, Pm, Pm, x, x, 0)
    with pytest.raises(ValueError, match="gauss_jordan_wide.*CUDA"):
        TI.gauss_jordan_inv_bl(torch.empty(182, 182, 10, device="meta"))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ----------------------------------------------------------------------
# CUDA card only
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _bf16_colour(d1, cuda):
    """Seeded tables and sides of a colour at an unaligned offset, the
    factors bfloat16 (their own padded stride), the rest float32."""
    nu, nf = 2 * d1, 2 * 301 + 1
    g = torch.Generator().manual_seed(d1 + 7)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float32).to(cuda)
    K01, K10 = TP.pad_table(rnd(d1, d1, nf)), TP.pad_table(rnd(d1, d1, nf))
    Di = TP.pad_table((rnd(nu, nu, nf) / nu).to(torch.bfloat16))
    Si = TP.pad_table((rnd(nu, nu, nf) / nu).to(torch.bfloat16))
    off, m = 133, 301 - 4
    return (Di, Si, K01, K10, rnd(nu, nu) / nu, rnd(nu, nu) / nu, rnd(nu, m), rnd(nu, m), off)


@pytest.mark.cuda
@pytest.mark.parametrize("d1", [21, 45, 91])
def test_cuda_patch_wide_bf16(cuda, d1):
    """K3w's bfloat16-factor variant through the wrapper (its default plan:
    a cluster at d1 = 21, 45, the plan without one at 91) against the plain
    version, which upcasts the factors, within 1e-4 of the largest entry;
    it launches the bf16 variant and not the float32 kernel."""
    args = _bf16_colour(d1, cuda)
    ref = TP.patch_solve_plain(*args)
    kernels.reset_launches()
    got = TP.patch_solve(*args)
    assert kernels.LAUNCHES["patch_solve_wide_bf16"] == 1
    assert kernels.LAUNCHES["patch_solve_wide"] == 0
    for g_, want in zip(got, ref):
        assert float((g_ - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_patch_wide_bf16_every_plan(cuda):
    """K3w's bfloat16-factor variant at d1 = 45 under every plan (each
    cluster (F, CS) and each F without a cluster) through its C entry
    point, against the plain version; a float64 vector with bfloat16
    factors raises before any launch."""
    d1 = 45
    Di, Si, K01, K10, Bk, Ck, r0, r1, off = args = _bf16_colour(d1, cuda)
    ref = TP.patch_solve_plain(*args)
    m, nu = r0.shape[1], 2 * d1
    plans = _patch_plans(d1, torch.float32, torch.bfloat16) + [
        TP.patch_wide_plan(d1, torch.float32, F=f, CS=0, factors=torch.bfloat16)
        for f in TP.PATCH_WIDE_DEV_FACETS if 3 * nu * f * 4 <= TP.SMEM_MAX]
    assert len(plans) >= 5
    for p in plans:
        y0, y1 = torch.empty_like(r0), torch.empty_like(r0)
        kernels.launch("patch_solve_wide_bf16", 0, 2, d1, p["F"], p["CS"], p["threads"],
                       p["smem_bytes"], Di.data_ptr(), Si.data_ptr(), K01.data_ptr(),
                       K10.data_ptr(), Di.stride(1), K01.stride(1), off, Bk.data_ptr(),
                       Ck.data_ptr(), r0.data_ptr(), r1.data_ptr(), y0.data_ptr(),
                       y1.data_ptr(), m, kernels.stream_ptr(r0))
        for got, want in zip((y0, y1), ref):
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-4, p
    with pytest.raises(TypeError):
        TP.patch_solve(Di, Si, K01.double(), K10.double(), Bk.double(), Ck.double(),
                       r0.double(), r1.double(), off)


@pytest.mark.cuda
@pytest.mark.parametrize("d1", [45, 91])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cuda_patch_wide_every_plan(cuda, dtype, d1):
    """K3w at d1 = 45 and 91 under every plan that fits (each F and cluster
    size, and each F without a cluster; at d1 = 91 only the latter fit),
    launched through its C entry point, against the plain version on a
    colour at an unaligned offset."""
    nu, nf = 2 * d1, 2 * 301 + 1
    g = torch.Generator().manual_seed(d1)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(cuda)
    K01, K10 = TP.pad_table(rnd(d1, d1, nf)), TP.pad_table(rnd(d1, d1, nf))
    Di, Si = TP.pad_table(rnd(nu, nu, nf)), TP.pad_table(rnd(nu, nu, nf))
    Bk, Ck = rnd(nu, nu), rnd(nu, nu)
    off, m = 133, 301 - 4
    r0, r1 = rnd(nu, m), rnd(nu, m)
    ref = TP.patch_solve_plain(Di, Si, K01, K10, Bk, Ck, r0, r1, off)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    code = kernels.dtype_code(dtype)
    plans = [TP.patch_wide_plan(d1, dtype, F=f, CS=0) for f in TP.PATCH_WIDE_DEV_FACETS
             if 3 * nu * f * SIZE[dtype] <= TP.SMEM_MAX]
    for rb in TP.PATCH_WIDE_ROW_BYTES:
        for cs in range(1, TP.PATCH_WIDE_CLUSTER_MAX + 1):
            try:
                plans.append(TP.patch_wide_plan(d1, dtype, F=rb // SIZE[dtype], CS=cs))
            except NotImplementedError:
                continue
    for p in plans:
        y0, y1 = torch.empty_like(r0), torch.empty_like(r0)
        kernels.launch("patch_solve_wide", 0, code, d1, p["F"], p["CS"], p["threads"],
                       p["smem_bytes"], Di.data_ptr(), Si.data_ptr(), K01.data_ptr(),
                       K10.data_ptr(), K01.stride(1), off, Bk.data_ptr(), Ck.data_ptr(),
                       r0.data_ptr(), r1.data_ptr(), y0.data_ptr(), y1.data_ptr(), m,
                       kernels.stream_ptr(r0))
        for got, want in zip((y0, y1), ref):
            assert float((got - want).abs().max() / want.abs().max()) <= tol, p
    assert len(plans) >= (5 if d1 <= 80 else 3)
    default = TP.patch_wide_plan(d1, dtype)  # past d1 = 80 the plan without a cluster
    assert default["path"] == ("device" if d1 > 80 else "cluster")
