"""The launch plan of K2c (csrc/cross_pair_cluster.cu), which splits a facet
tile's scalar rows over a thread-block cluster, and the cross pair's
dispatch, on the CPU (no card, no nvcc).

- ``preconditioners.cross_pair_plan`` at d1 = 21, 28, 36, 45, 55 in float32
  and float64, under every plan it admits: the ranks own every scalar row
  once, the threads of a rank every (side, row, 16-byte group of facets)
  once, as cross_pair_cluster_kernel maps threadIdx.x and the cluster rank,
  and the rank's x pushes cover every (input, row, group) of the tile once,
  at most two a thread; threads, shared bytes and the cluster size stay
  within the H100's limits;
- a fixed (F, CS) that does not fit raises NotImplementedError naming the
  kernel;
- the dispatch: ``width_kernels`` names the kernel of
  ``CROSS_PAIR_MEASURED`` at the measured widths (K2c at d1 = 21 .. 91),
  K2 at its own instantiations and K2w elsewhere; the wrapper refuses
  tensors off the card before it plans;
- on a CUDA card only: K2c at d1 = 21, 28, 36, 45, 55, 66, 78, 91 against
  ``cross_pair_plain`` in float32 and float64 (a misaligned column offset,
  an odd facet count, one colour, the full field with its tail, a segment
  edge inside a tile), every plan at d1 = 28, and K3w at d1 = 21 against
  ``patch_solve_plain``.
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu_torch import kernels
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP

DTYPES = [torch.float32, torch.float64]
SIZE = {torch.float32: 4, torch.float64: 8}
WIDTHS = [21, 28, 36, 45, 55]


def _plans(d1, dtype):
    plans = []
    for rb in TP.CROSS_CLUSTER_ROW_BYTES:
        for cs in range(1, TP.CROSS_CLUSTER_MAX + 1):
            try:
                plans.append(TP.cross_pair_plan(d1, dtype, F=rb // SIZE[dtype], CS=cs))
            except NotImplementedError:
                continue
    return plans


def _owners(plan, d1, dtype):
    """(side, scalar row, facet group) of every active thread of every rank,
    and (input, row, facet group) of every x group a rank pushes, as
    cross_pair_cluster_kernel maps threadIdx.x and the cluster rank."""
    Q = plan["F"] // (16 // SIZE[dtype])
    CS, RS, nt = plan["CS"], plan["RS"], plan["threads"]
    rows, pushes = [], []
    for rank in range(CS):
        i0, i1 = rank * d1 // CS, (rank + 1) * d1 // CS
        rs = i1 - i0
        assert 1 <= rs <= RS
        tid = np.arange(nt)
        q, slot = tid % Q, tid // Q
        side = (slot >= RS).astype(int)
        il = slot - side * RS
        act = il < rs
        rows.append(np.stack([side[act], i0 + il[act], q[act]], axis=1))
        g = np.arange(4 * rs * Q)
        assert len(g) <= 2 * nt  # two x groups a thread at most
        inp, r = g // (2 * rs * Q), (g // Q) % (2 * rs)
        pushes.append(np.stack([inp, (r // rs) * d1 + i0 + r % rs, g % Q], axis=1))
    return np.concatenate(rows), np.concatenate(pushes)


@pytest.mark.parametrize("d1", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cross_pair_plan_owns_every_row_once(d1, dtype):
    plans = _plans(d1, dtype)
    assert TP.cross_pair_plan(d1, dtype) in plans
    vec = 16 // SIZE[dtype]
    for plan in plans:
        F, CS, RS = plan["F"], plan["CS"], plan["RS"]
        assert F * SIZE[dtype] in TP.CROSS_CLUSTER_ROW_BYTES
        assert 1 <= CS <= TP.CROSS_CLUSTER_MAX and RS == -(-d1 // CS)
        assert plan["threads"] == 2 * RS * (F // vec) <= min(1024, TP.CROSS_CLUSTER_THREADS_MAX)
        assert plan["smem_bytes"] == TP.cross_pair_smem(d1, F, CS, SIZE[dtype]) <= 232448
        rows, pushes = _owners(plan, d1, dtype)
        Q = F // vec
        assert len(rows) == 2 * d1 * Q and len(np.unique(rows, axis=0)) == len(rows)
        assert len(pushes) == 2 * 2 * d1 * Q and len(np.unique(pushes, axis=0)) == len(pushes)


def test_cross_pair_plan_fixed_and_limits():
    """A fixed plan is returned as asked; one past the thread or cluster
    limits raises NotImplementedError naming the kernel; the default plans
    at the measured widths are the measured fastest."""
    p = TP.cross_pair_plan(36, torch.float32, F=32, CS=4)
    assert (p["F"], p["CS"], p["RS"], p["threads"]) == (32, 4, 9, 144)
    np_ = 72  # nu = 72 floats is a whole number of 16-byte groups
    assert p["smem_bytes"] == (4 * np_ * 32 + 4 * 9 * np_) * 4
    assert TP.cross_pair_smem(21, 16, 3, 4) == (4 * 44 * 16 + 4 * 7 * 44) * 4  # nu = 42 -> 44
    with pytest.raises(NotImplementedError, match="cross_pair_cluster"):
        TP.cross_pair_plan(36, torch.float32, F=64, CS=1)  # 1,152 threads
    with pytest.raises(NotImplementedError, match="cross_pair_cluster"):
        TP.cross_pair_plan(36, torch.float32, F=32, CS=9)
    with pytest.raises(NotImplementedError, match="cross_pair_cluster"):
        TP.cross_pair_plan(36, torch.float32, F=24)
    for (d1, dtype), (F, CS) in TP.CROSS_CLUSTER_MEASURED.items():
        p = TP.cross_pair_plan(d1, dtype)
        assert (p["F"], p["CS"]) == (F, CS)


def test_cross_pair_dispatch():
    """The cross pair takes the measured kernel where the one-process A/B
    measured one (K2c at d1 = 21 .. 91 in both dtypes and at d1 = 105 in
    float32), K2 at its other instantiated widths and K2w elsewhere; K1
    keeps d1 <= 36 and the patch solve takes K3 only up to d1 = 15."""
    for (d1, dtype), name in TP.CROSS_PAIR_MEASURED.items():
        assert name in kernels.KERNELS and name.startswith("cross_pair")
        assert TP.width_kernels(d1, dtype)[1] == name
        if name == "cross_pair":
            assert d1 in TP.CROSS_D1
    for dtype in DTYPES:
        for d1 in (21, 28, 36, 45):
            assert TP.width_kernels(d1, dtype)[1] == "cross_pair_cluster"
            assert (d1, dtype) in TP.CROSS_CLUSTER_MEASURED
        assert TP.width_kernels(10, dtype) == ("fact_apply", "cross_pair", "patch_solve")
        assert TP.width_kernels(21, dtype)[2] == "patch_solve_wide"
        # k = 12, 13 (tools/ab_cross.py --widths 105,120): K2c faster on one
        # colour only at d1 = 105 in float32 (at 120 in float32 within 1%)
        for d1 in (105, 120):
            want = "cross_pair_cluster" if (d1, dtype) == (105, torch.float32) else \
                "cross_pair_wide"
            assert TP.width_kernels(d1, dtype)[1] == want
    assert TP.CROSS_D1 == TP.PATCH_D1 == tuple(d for d in TP.CUDA_D1 if d <= 15)


@pytest.mark.parametrize("d1", [55, 66, 78, 91])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cross_pair_dispatch_k8_to_k11(d1, dtype):
    """k = 8 .. 11: the one-process A/B of K2w and K2c (tools/ab_cross.py
    --widths 55,66,78,91) measured K2c faster on one colour in both
    dtypes, under its measured plan, which fits the H100's limits and owns
    every row once."""
    assert TP.width_kernels(d1, dtype) == ("fact_apply_wide", "cross_pair_cluster",
                                           "patch_solve_wide")
    plan = TP.cross_pair_plan(d1, dtype)
    assert (plan["F"], plan["CS"]) == TP.CROSS_CLUSTER_MEASURED[(d1, dtype)]
    assert plan["threads"] <= TP.CROSS_CLUSTER_THREADS_MAX and plan["smem_bytes"] <= TP.SMEM_MAX
    rows, pushes = _owners(plan, d1, dtype)
    Q = plan["F"] // (16 // SIZE[dtype])
    assert len(rows) == 2 * d1 * Q and len(np.unique(rows, axis=0)) == len(rows)
    assert len(pushes) == 4 * d1 * Q and len(np.unique(pushes, axis=0)) == len(pushes)


def test_cross_pair_cluster_refuses_cpu_free_tensors():
    """At d1 = 28 the wrapper checks the device before it plans: meta
    tensors raise for want of a CUDA tensor, and nothing launches."""
    d1, nu = 28, 56
    A = torch.empty(d1, d1, 10, device="meta")
    x = torch.empty(nu, 10, device="meta")
    Pm = torch.empty(1, nu, nu, device="meta")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="cross_pair_cluster.*CUDA"):
        TP.cross_pair(A, A, Pm, Pm, (0, 10), x, x)
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


def _launch_k2c(plan, K01, K10, Bp, Cp, bounds, x0, x1, aoff):
    """K2c under ``plan`` through its C entry point."""
    seg, nseg = kernels.seg_array(bounds)
    y0, y1 = torch.empty_like(x0), torch.empty_like(x0)
    kernels.launch("cross_pair_cluster", 0, kernels.dtype_code(x0.dtype), K01.shape[0],
                   plan["F"], plan["CS"], plan["threads"], plan["smem_bytes"], K01.data_ptr(),
                   K10.data_ptr(), K01.stride(1), aoff, Bp.data_ptr(), Cp.data_ptr(), seg, nseg,
                   x0.data_ptr(), x1.data_ptr(), y0.data_ptr(), y1.data_ptr(), x0.shape[1],
                   kernels.stream_ptr(x0))
    return y0, y1


def _cross_cases(d1, dtype, cuda, seed):
    """(K01, K10, Bp, Cp, bounds, x0, x1, aoff) cases: the full field of
    three colours and a tail (edges inside tiles), one colour at a
    misaligned offset with an odd count, and a single facet."""
    nu, nf = 2 * d1, 3 * 301 + 17
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(cuda)
    K01, K10 = TP.pad_table(rnd(d1, d1, nf)), TP.pad_table(rnd(d1, d1, nf))
    Bp, Cp = rnd(3, nu, nu), rnd(3, nu, nu)
    x0, x1 = rnd(nu, nf), rnd(nu, nf)
    b = (0, 301, 602, 903)
    m = 297
    return [(K01, K10, Bp, Cp, b, x0, x1, 0),
            (K01, K10, Bp[1:2], Cp[1:2], (0, m), x0[:, :m].contiguous(),
             x1[:, :m].contiguous(), 305),
            (K01, K10, Bp[2:], Cp[2:], (0, 1), x0[:, :1].contiguous(), x1[:, :1].contiguous(),
             nf - 1)]


def _rel(got, ref):
    return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("d1", [21, 28, 36, 45, 55, 66, 78, 91])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cuda_cross_pair_cluster(cuda, dtype, d1):
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    plan = TP.cross_pair_plan(d1, dtype)
    kernels.reset_launches()
    for case in _cross_cases(d1, dtype, cuda, d1):
        ref = TP.cross_pair_plain(*case[:7], aoff=case[7])
        assert _rel(_launch_k2c(plan, *case), ref) <= tol
    assert kernels.LAUNCHES["cross_pair_cluster"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cuda_cross_pair_cluster_every_plan(cuda, dtype):
    """K2c at d1 = 28 under every plan it admits, and the dispatch, on the
    same cases."""
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    cases = _cross_cases(28, dtype, cuda, 28)
    refs = [TP.cross_pair_plain(*c[:7], aoff=c[7]) for c in cases]
    plans = _plans(28, dtype)
    for plan in plans:
        for case, ref in zip(cases, refs):
            assert _rel(_launch_k2c(plan, *case), ref) <= tol, plan
    kernels.reset_launches()
    for case, ref in zip(cases, refs):
        assert _rel(TP.cross_pair(*case[:7], aoff=case[7]), ref) <= tol
    assert kernels.LAUNCHES[TP.width_kernels(28, dtype)[1]] == 3
    assert len(plans) >= 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cuda_patch_wide_d1_21(cuda, dtype):
    """The patch solve at d1 = 21 launches K3w, and holds its plain version
    on a colour at an unaligned offset, a whole tail and one facet."""
    d1, nu, nf = 21, 42, 2 * 301 + 1
    g = torch.Generator().manual_seed(21)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(cuda)
    K01, K10 = TP.pad_table(rnd(d1, d1, nf)), TP.pad_table(rnd(d1, d1, nf))
    Di, Si = TP.pad_table(rnd(nu, nu, nf)), TP.pad_table(rnd(nu, nu, nf))
    Bk, Ck = rnd(nu, nu), rnd(nu, nu)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    kernels.reset_launches()
    for off, m in ((133, 301 - 4), (301, nf - 301), (nf - 1, 1)):
        r0, r1 = rnd(nu, m), rnd(nu, m)
        args = (Di, Si, K01, K10, Bk, Ck, r0, r1, off)
        assert _rel(TP.patch_solve(*args), TP.patch_solve_plain(*args)) <= tol
    assert kernels.LAUNCHES["patch_solve_wide"] == 3 and kernels.LAUNCHES["patch_solve"] == 0


@pytest.mark.cuda
def test_cuda_graph_ms_reads_k2c(cuda):
    """The A/B timer captures K2c's launches in a CUDA graph (a cluster
    launch through cudaLaunchKernelEx): a positive time a launch, one
    counted launch for the warm-up call and each captured call, and the
    graph's replays leave the outputs the plain version gives."""
    from incompressibleeulerhdg_tpu_torch.tools.ab_cross_patch import graph_ms

    case = _cross_cases(28, torch.float32, cuda, 28)[0]
    plan = TP.cross_pair_plan(28, torch.float32)
    ref = TP.cross_pair_plain(*case[:7], aoff=case[7])
    out = []
    kernels.reset_launches()
    assert graph_ms(lambda: out.append(_launch_k2c(plan, *case)), reps=4, replays=2) > 0
    assert kernels.LAUNCHES["cross_pair_cluster"] == 5
    assert _rel(out[-1], ref) <= 1e-4
