"""k = 5, 6 and 7 in the PyTorch port: the widths d1 = 28, 36, 45 of K1-K3
and n = 56 .. 110 of the Gauss-Jordan inverse, against the JAX package in
float64.

- the plain K1-K3 at d1 = 28, 36 and 45 against the JAX fallbacks on a real
  factored operator (a non-periodic 4 x 2 mesh), at 1e-12 relative, as
  tests/test_torch_kernels.py does at d1 = 21;
- the plain Gauss-Jordan inverses (K4's indexed and K5's masked-select
  pivot steps) at n = 56, 72, 90 and 110 against the JAX fallback's jnp
  loop;
- ``build_tentative_operator`` at k = 5 and k = 7 on the 2^2 square: every
  table at 1e-12 relative;
- one SSP2 step at k = 5 on the 2^2 square from the same state: the stage
  states within 1e-10 and every Krylov count equal (k = 7:
  tests/test_torch_degree7.py);
- on a CUDA card only: K1, K2 and K3w at d1 = 28, 36 and K5 at n = 56, 72
  against their plain versions, and the dispatch of n = 56, 72 blocks to
  K5; the runtime-width kernels K1w-K3w at d1 = 45, 55 and K5w at n = 73,
  90, 110, float64 182 (a cluster of thread blocks) and 506 (the blocked
  path, K5b), and the dispatch to them.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.ops.forms import star_fields as j_star_fields
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.linalg.smallinv import gauss_jordan_inv_bl as j_gj
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch import convert, kernels
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg import smallinv as TI
from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh as t_mesh
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields as t_star_fields
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)

torch.set_num_threads(1)

WIDTHS = {5: 28, 6: 36, 7: 45}  # degree -> d1


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module", params=sorted(WIDTHS), ids=lambda k: f"k{k}")
def wide(request):
    """Flat factored operator at k = 5, 6 or 7 on a non-periodic 4 x 2 mesh."""
    k = request.param
    disc = JDisc(unit_square_mesh(4, 2), k)
    geom = disc.geom
    assert geom.d1 == WIDTHS[k]
    rng = np.random.default_rng(40 + k)
    star = j_star_fields(geom, jnp.asarray(rng.standard_normal((2, geom.d1, geom.n_cells))))
    jop = JP.build_tentative_operator(geom, star, 0.01, 1.0, True)
    assert jop.Sown is not None and jop.Ks01.ndim == 3
    return disc, geom, jop, convert.tentative_operator_from_jax(jop), rng


def test_fact_apply_plain_matches_fallback_wide(wide):
    disc, geom, jop, top, rng = wide
    nu = 2 * geom.d1
    nch = geom.shift[0] * geom.shift[1]
    xc = rng.standard_normal((nu, geom.n_cells))
    close(TP.fact_apply_plain(top.Sown, top.Pcell, (0, nch, geom.n_cells), t(xc)),
          JP._fact_apply(geom, jop.Sown, jop.Pcell, jnp.asarray(xc), per="half"), 1e-12)
    xf = rng.standard_normal((nu, geom.n_facets))
    close(TP.fact_apply_plain(top.Ks01, top.Bp, geom.fcol_bounds, t(xf)),
          JP._fact_apply(geom, jop.Ks01, jop.Bp, jnp.asarray(xf), per="color"), 1e-12)


def test_cross_pair_plain_matches_fallback_wide(wide):
    disc, geom, jop, top, rng = wide
    u0, u1 = rng.standard_normal((2, 2 * geom.d1, geom.n_facets))
    got = TP.cross_pair_plain(top.Ks01, top.Ks10, top.Bp, top.Cp, geom.fcol_bounds, t(u0), t(u1))
    ref = JP._cross_pair_full(geom, jop, jnp.asarray(u0), jnp.asarray(u1))
    close(got[0], ref[0], 1e-12)
    close(got[1], ref[1], 1e-12)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_patch_solve_plain_matches_fallback_wide(wide, k):
    disc, geom, jop, top, rng = wide
    rb = rng.standard_normal((2 * geom.d1, geom.n_cells))
    close(TP._patch_color_structured(convert.geom_from_jax(disc), top, k, t(rb)),
          JP._patch_color_structured(geom, jop, k, jnp.asarray(rb)), 1e-12)


@pytest.mark.parametrize("n", [56, 72, 90, 110])
def test_gauss_jordan_plain_matches_fallback_wide(n):
    """Both plain pivot steps (K4's and K5's) against the JAX fallback's jnp
    loop, and numpy's inverse, in float64."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n, 40)) * 0.1 + 3.0 * np.eye(n)[:, :, None]
    ref = j_gj(jnp.asarray(A))
    close(TI.gauss_jordan_inv_plain(t(A)), ref, 1e-12)
    close(TI.gauss_jordan_inv_select_plain(t(A)), ref, 1e-12)
    close(TI.gauss_jordan_inv_plain(t(A)), np.linalg.inv(A.transpose(2, 0, 1)).transpose(1, 2, 0),
          1e-12)


def _check_build(k, seed):
    """Every table of the degree-k stage operator on the 2^2 square."""
    jd = JDisc(unit_square_mesh(2), k)
    td = TDisc(t_mesh(2), k, device="cpu")
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((2, jd.geom.d1, jd.geom.n_cells))
    jop = JP.build_tentative_operator(jd.geom, j_star_fields(jd.geom, jnp.asarray(u)), 0.02)
    top = TP.build_tentative_operator(td.geom, t_star_fields(td.geom, t(u)), 0.02)
    for name in ("Dinv", "Sinv", "Dinv0", "Sown", "Pcell", "Ks01", "Ks10", "Bp", "Cp"):
        close(getattr(top, name), getattr(jop, name), 1e-12)


def test_build_tentative_operator_k5():
    _check_build(5, 55)


def test_build_tentative_operator_k7():
    """k = 7 (d1 = 45, n = 90: the Gauss-Jordan blocks K5w inverts on the
    card)."""
    _check_build(7, 77)


def test_step_k5_matches_jax():
    """One SSP2 step at k = 5 on the 2^2 square, from the same initial
    state: every stage state within 1e-10 and every Krylov count equal."""
    dt = 0.1
    jd = JDisc(unit_square_mesh(2), 5)
    js, jp = JSSP2(jd, dt), JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    z = lambda a: [a] + [jnp.zeros_like(a)] * (s - 1)
    step = js._get_step(jp.f_rhs(), False)
    jQ, jpr, jl, _, jc = step(jd.geom, js._proj, js._cs, js._gtmg, z(Q), z(p), z(lam),
                              jnp.asarray(0.0), jnp.zeros_like(p), None)

    td = TDisc(t_mesh(2), 5, device="cpu")
    ts, tp = TSSP2(td, dt), TTG(td)
    tQ, tpr, tl, tc = ts.step(*ts.initial_state(*tp.initial_condition()), 0.0, tp.f_rhs())
    for tlist, jlist in ((tQ, jQ), (tpr, jpr), (tl, jl)):
        for a, b in zip(tlist, jlist):
            close(a, b, 1e-10)
    assert tc["tentative"] == [int(n) for n in np.asarray(jc["tentative"])]
    assert tc["pressure"] == [int(n) for n in np.asarray(jc["pressure"])]
    assert tc["final_pressure"] == int(jc["final_pressure"])
    assert tc["reconstruction"] == int(jc["reconstruction"])
    assert min(tc["tentative"] + tc["pressure"]) > 0


# ----------------------------------------------------------------------
# CUDA card only
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _check_kernels_width(d1, dtype, device):
    """K1, the cross pair (K2c at d1 = 28, 36) and the patch solve (K3w from
    d1 = 21) at width d1 against their plain versions: a colour offset, a
    column count that is not a multiple of a thread block or a tile, a padded
    table of an odd column count, a tile-aligned and an unaligned offset, and
    segments that start and end inside tiles."""
    g = torch.Generator().manual_seed(d1)
    nu, nf = 2 * d1, 2 * 701 + 1
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(device)
    A = rnd(d1, d1, nf)
    K01, K10 = TP.pad_table(rnd(d1, d1, nf)), TP.pad_table(rnd(d1, d1, nf))
    Di, Si = TP.pad_table(rnd(nu, nu, nf)), TP.pad_table(rnd(nu, nu, nf))
    P4, Q4 = rnd(4, nu, nu), rnd(4, nu, nu)
    off, m = 333, 701 - 4
    x0, x1 = rnd(nu, nf - off), rnd(nu, nf - off)
    b = (0, 35, 37, 301, m - 7)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    kernels.reset_launches()
    for aoff in (0, off):
        assert _rel(TP.fact_apply(A, P4, b, x0[:, :m], aoff=aoff),
                    TP.fact_apply_plain(A, P4, b, x0[:, :m], aoff=aoff)) <= tol
        got = TP.cross_pair(K01, K10, P4, Q4, b, x0[:, :m], x1[:, :m], aoff=aoff)
        ref = TP.cross_pair_plain(K01, K10, P4, Q4, b, x0[:, :m], x1[:, :m], aoff=aoff)
        assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol
    for mm in (m, nf - off, 1):
        got = TP.patch_solve(Di, Si, K01, K10, P4[0], Q4[0], x0[:, :mm], x1[:, :mm], off)
        ref = TP.patch_solve_plain(Di, Si, K01, K10, P4[0], Q4[0], x0[:, :mm], x1[:, :mm], off)
        assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol
    k1, k2, k3 = TP.width_kernels(d1, dtype)
    assert kernels.LAUNCHES[k1] == 2 and kernels.LAUNCHES[k2] == 2
    assert kernels.LAUNCHES[k3] == 3
    assert sum(kernels.LAUNCHES.values()) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_d1_28(cuda, dtype):
    _check_kernels_width(28, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_d1_36(cuda, dtype):
    _check_kernels_width(36, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [49, 56, 57, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gauss_jordan(cuda, dtype, n):
    """K5 at the widths of k = 5, 6 (and the n between) against its plain
    version on batches around its thread block's, and the main-path
    dispatch of the same blocks to K5."""
    g = torch.Generator().manual_seed(n)
    tol = 5e-5 if dtype == torch.float32 else 1e-11
    bb = TI.launch_plan("gauss_jordan_select", dtype, n)["BB"]
    blocks = lambda m: (0.1 * torch.randn(n, n, m, generator=g, dtype=dtype)
                        + 3.0 * torch.eye(n, dtype=dtype)[:, :, None]).to(cuda)
    cases = [blocks(m) for m in (1, bb + 1, 777)] + [blocks(2 * 777)[:, :, 1::2]]
    kernels.reset_launches()
    for A in cases:
        ref = TI.gauss_jordan_inv_plain(A)
        assert float((TI.gauss_jordan_inv_select(A) - ref).abs().max()) <= tol
        assert float((TI.gauss_jordan_inv_bl(A) - ref).abs().max()) <= tol
    assert kernels.LAUNCHES["gauss_jordan_select"] == 2 * len(cases)
    assert kernels.LAUNCHES["gauss_jordan"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d1", [45, 55, 91, 105, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_wide(cuda, dtype, d1):
    """K1w-K3w at d1 = 45, 55, 91, 105, 136 (k = 7, 8, 11, 12, 14; K3w's
    cluster plan up to d1 = 80, past that its plan without a cluster): an
    unaligned colour offset, a segment edge inside a thread block, a padded
    table of an odd column count."""
    assert TP.patch_wide_plan(d1, dtype)["path"] == ("device" if d1 > 80 else "cluster")
    _check_kernels_width(d1, dtype, cuda)


def _per_block_rel(got, ref):
    """Largest over the batch-last blocks of each block's error relative to
    its largest entry."""
    return float(((got - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n, dtype", [(73, torch.float32), (90, torch.float32),
                                      (110, torch.float32), (73, torch.float64),
                                      (90, torch.float64), (110, torch.float64),
                                      (182, torch.float64), (506, torch.float64)])
def test_cuda_gauss_jordan_wide(cuda, dtype, n):
    """K5w against its plain version on batches around its thread block's
    (float64 n = 182 and 506 take the blocked path, K5b: at 182 measured
    faster than the cluster), and the main-path dispatch of the same
    blocks to K5w (K5b at 182, 506).  K5w's
    updates are FMAs: float32 is held to twice the plain version's own
    float32 error against the float64 plain inverse (per block), against
    both; float64 to 1e-11."""
    g = torch.Generator().manual_seed(n)
    plan = TI.launch_plan("gauss_jordan_wide", dtype, n)
    assert plan["path"] == {182: "blocked", 506: "blocked"}.get(n, "tiles")
    name = TI.kernel_for(n, dtype)
    blocks = lambda m: (0.1 * torch.randn(n, n, m, generator=g, dtype=dtype)
                        + 3.0 * torch.eye(n, dtype=dtype)[:, :, None]).to(cuda)
    cases = [blocks(m) for m in (1, plan.get("BB", 1) + 1, 77)] + [blocks(2 * 77)[:, :, 1::2]]
    kernels.reset_launches()
    for A in cases:
        ref = TI.gauss_jordan_inv_plain(A)
        ref64 = TI.gauss_jordan_inv_plain(A.double())
        tol = 2.0 * _per_block_rel(ref.double(), ref64) if dtype == torch.float32 else 1e-11
        for got in (TI.gauss_jordan_inv_wide(A), TI.gauss_jordan_inv_bl(A)):
            assert _per_block_rel(got, ref) <= tol
            assert _per_block_rel(got.double(), ref64) <= max(tol, 1e-11)
    assert kernels.LAUNCHES[name] == 2 * len(cases)
    assert kernels.LAUNCHES["gauss_jordan"] == kernels.LAUNCHES["gauss_jordan_select"] == 0
