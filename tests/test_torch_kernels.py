"""Kernels K1-K5 of the PyTorch port: their plain versions against the JAX
package's Pallas kernels and JAX fallbacks, and (on a CUDA card only) the
hand-written CUDA kernels against their plain versions.

- float32: each plain version against the Pallas kernel run in interpret
  mode on the CPU, with the tolerances of the JAX package's own kernel tests
  (tests/test_structured.py, tests/test_linalg.py);
- float64: each plain version against the JAX fallback path on a real
  operator, at 1e-12 relative, including colour offsets and the misaligned
  colour sizes of a non-periodic 16 x 8 mesh;
- the CPU dispatch: a wrapper given CPU tensors runs its plain version;
- k = 4 (d1 = 21, n = 42): the plain versions of K1-K3 against the JAX
  fallbacks, K5's plain version against the ``_gj_old`` Pallas kernel of
  tools/microbench_gj.py in interpret mode, and the widths the card refuses;
- the kernel timer of chip_smoke.py and tools/ab_cross_patch.py, with the
  profiler stubbed.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.ops.forms import star_fields as j_star_fields
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.linalg.smallinv import _gj_pallas, gauss_jordan_inv_bl as j_gj

from incompressibleeulerhdg_tpu_torch import convert, kernels
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg import smallinv as TI

torch.set_num_threads(1)

D1, BLOCK, NTILE = 6, 128, 3  # d1 = 6 is k = 1, an instantiated kernel width


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ----------------------------------------------------------------------
# float32: plain version vs the Pallas kernel (interpret mode)
# ----------------------------------------------------------------------


def test_fact_apply_plain_matches_pallas():
    rng = np.random.default_rng(11)
    nu, M = 2 * D1, BLOCK * NTILE
    A, P, x = f32(rng, D1, D1, M), f32(rng, NTILE, nu, nu), f32(rng, nu, M)
    tiles = tuple(BLOCK * i for i in range(NTILE + 1))
    ref = JP._fact_pallas(JP.tile_table(jnp.asarray(A), BLOCK), jnp.asarray(P),
                          jnp.asarray(x), BLOCK, interpret=True)
    got = TP.fact_apply_plain(t(A), t(P), tiles, t(x))
    assert maxerr(got, ref) <= 1e-4
    # a nonzero offset: tiles 1, 2 only
    ref2 = JP._fact_pallas(JP.tile_table(jnp.asarray(A), BLOCK), jnp.asarray(P[1:]),
                           jnp.asarray(x[:, BLOCK:]), BLOCK, offset=BLOCK, interpret=True)
    got2 = TP.fact_apply_plain(t(A), t(P[1:]), tiles[:3], t(x[:, BLOCK:]), aoff=BLOCK)
    assert maxerr(got2, ref2) <= 1e-4


def test_cross_pair_plain_matches_pallas():
    rng = np.random.default_rng(17)
    nu, M = 2 * D1, BLOCK * NTILE
    K01, K10 = f32(rng, D1, D1, M), f32(rng, D1, D1, M)
    BpT, CpT = f32(rng, NTILE, nu, nu), f32(rng, NTILE, nu, nu)
    x0, x1 = f32(rng, nu, M), f32(rng, nu, M)
    tiles = tuple(BLOCK * i for i in range(NTILE + 1))
    tt = lambda a: JP.tile_table(jnp.asarray(a), BLOCK)
    ref = JP._cross_pair_pallas(tt(K01), tt(K10), jnp.asarray(BpT), jnp.asarray(CpT),
                                jnp.asarray(x0), jnp.asarray(x1), BLOCK, interpret=True)
    got = TP.cross_pair_plain(t(K01), t(K10), t(BpT), t(CpT), tiles, t(x0), t(x1))
    assert max(maxerr(got[0], ref[0]), maxerr(got[1], ref[1])) <= 1e-4
    sl = slice(BLOCK, None)
    ref2 = JP._cross_pair_pallas(tt(K01), tt(K10), jnp.asarray(BpT[1:]), jnp.asarray(CpT[1:]),
                                 jnp.asarray(x0[:, sl]), jnp.asarray(x1[:, sl]), BLOCK,
                                 offset=BLOCK, interpret=True)
    got2 = TP.cross_pair_plain(t(K01), t(K10), t(BpT[1:]), t(CpT[1:]), tiles[:3],
                               t(x0[:, sl]), t(x1[:, sl]), aoff=BLOCK)
    assert max(maxerr(got2[0], ref2[0]), maxerr(got2[1], ref2[1])) <= 1e-4


def test_patch_solve_plain_matches_pallas():
    rng = np.random.default_rng(13)
    nu, M = 2 * D1, BLOCK * NTILE
    Di, Si = f32(rng, nu, nu, M), f32(rng, nu, nu, M)
    K01, K10 = f32(rng, D1, D1, M), f32(rng, D1, D1, M)
    Bp, Cp = f32(rng, nu, nu), f32(rng, nu, nu)
    r0, r1 = f32(rng, nu, M), f32(rng, nu, M)
    tt = lambda a: JP.tile_table(jnp.asarray(a), BLOCK)
    sl = slice(BLOCK, None)  # the colour starts at a nonzero offset
    ref = JP._patch_pallas(tt(Di), tt(Si), tt(K01), tt(K10), jnp.asarray(Bp), jnp.asarray(Cp),
                           jnp.asarray(r0[:, sl]), jnp.asarray(r1[:, sl]), BLOCK,
                           offset=BLOCK, interpret=True)
    got = TP.patch_solve_plain(t(Di), t(Si), t(K01), t(K10), t(Bp), t(Cp),
                               t(r0[:, sl]), t(r1[:, sl]), BLOCK)
    scale = max(1.0, float(np.abs(np.asarray(ref[0])).max()))
    # the Pallas test's tolerance (atol 1e-3), relative to the solution size
    assert maxerr(got[0], ref[0]) <= 1e-3 * scale
    assert maxerr(got[1], ref[1]) <= 1e-3 * scale


@pytest.mark.parametrize("n", [8, 12, 20, 30])
def test_gauss_jordan_plain_matches_pallas(n):
    """K4's plain version against ``_gj_pallas`` in interpret mode at the
    block sizes of k = 1, 2, 3 (and n = 8), over a batch that is no multiple
    of the Pallas block (1024): two grid steps, the second padded."""
    rng = np.random.default_rng(5 + n)
    m = 1100
    A = (rng.standard_normal((n, n, m)) * 0.1 + 3.0 * np.eye(n)[:, :, None]).astype(np.float32)
    ref = _gj_pallas(jnp.asarray(A), interpret=True)
    assert maxerr(TI.gauss_jordan_inv_plain(t(A)), ref) <= 5e-5


# ----------------------------------------------------------------------
# float64: plain version vs the JAX fallback on a real operator
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def misaligned():
    """Flat factored operator on the misaligned non-periodic 16 x 8 mesh."""
    disc = JDisc(unit_square_mesh(16, 8), 1)
    geom = disc.geom
    rng = np.random.default_rng(29)
    star = j_star_fields(geom, jnp.asarray(rng.standard_normal((2, geom.d1, geom.n_cells))))
    jop = JP.build_tentative_operator(geom, star, 0.01, 1.0, True)
    assert jop.Sown is not None and jop.Ks01.ndim == 3
    assert any((b1 - b0) % 128 for b0, b1 in zip(geom.fcol_bounds, geom.fcol_bounds[1:]))
    return disc, geom, jop, convert.tentative_operator_from_jax(jop), rng


def close64(got, ref):
    ref = np.asarray(ref)
    assert maxerr(got, ref) <= 1e-12 * np.abs(ref).max()


def test_fact_apply_plain_matches_fallback(misaligned):
    disc, geom, jop, top, rng = misaligned
    nu = 2 * geom.d1
    nch = geom.shift[0] * geom.shift[1]
    xc = rng.standard_normal((nu, geom.n_cells))
    close64(TP.fact_apply_plain(top.Sown, top.Pcell, (0, nch, geom.n_cells), t(xc)),
            JP._fact_apply(geom, jop.Sown, jop.Pcell, jnp.asarray(xc), per="half"))
    xf = rng.standard_normal((nu, geom.n_facets))
    close64(TP.fact_apply_plain(top.Ks01, top.Bp, geom.fcol_bounds, t(xf)),
            JP._fact_apply(geom, jop.Ks01, jop.Bp, jnp.asarray(xf), per="color"))
    for k in range(len(geom.fcol_bounds) - 1):
        b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
        xk = xf[:, : b1 - b0]
        close64(TP.fact_apply_plain(top.Ks10, top.Cp[k:k + 1], (0, b1 - b0), t(xk), aoff=b0),
                JP._fact_color_apply(geom, jop.Ks10, jop.Cp[k], jnp.asarray(xk), k))


def test_cross_pair_plain_matches_fallback(misaligned):
    disc, geom, jop, top, rng = misaligned
    nu = 2 * geom.d1
    u0, u1 = rng.standard_normal((2, nu, geom.n_facets))
    got = TP.cross_pair_plain(top.Ks01, top.Ks10, top.Bp, top.Cp, geom.fcol_bounds, t(u0), t(u1))
    ref = JP._cross_pair_full(geom, jop, jnp.asarray(u0), jnp.asarray(u1))
    close64(got[0], ref[0])
    close64(got[1], ref[1])
    k = 2
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    got = TP.cross_pair_plain(top.Ks01, top.Ks10, top.Bp[k:k + 1], top.Cp[k:k + 1],
                              (0, b1 - b0), t(u0[:, : b1 - b0]), t(u1[:, : b1 - b0]), aoff=b0)
    ref = JP._cross_pair_color(geom, jop, k, jnp.asarray(u0[:, : b1 - b0]),
                               jnp.asarray(u1[:, : b1 - b0]))
    close64(got[0], ref[0])
    close64(got[1], ref[1])


@pytest.mark.parametrize("k", [0, 1, 2])
def test_patch_solve_plain_matches_fallback(misaligned, k):
    """K3's plain version inside the port's colour patch solve against the
    JAX factored branch (preconditioners.py:1374-1379), every colour."""
    disc, geom, jop, top, rng = misaligned
    tgeom = convert.geom_from_jax(disc)
    rb = rng.standard_normal((2 * geom.d1, geom.n_cells))
    close64(TP._patch_color_structured(tgeom, top, k, t(rb)),
            JP._patch_color_structured(geom, jop, k, jnp.asarray(rb)))


@pytest.mark.parametrize("n", [12, 20, 30])
def test_gauss_jordan_plain_matches_fallback(n):
    """Both plain versions (K4's indexed and K5's masked-select pivot step)
    against the JAX fallback ``gauss_jordan_inv_bl`` in float64."""
    rng = np.random.default_rng(6 + n)
    m = 300
    A = rng.standard_normal((n, n, m)) * 0.1 + 3.0 * np.eye(n)[:, :, None]
    ref = j_gj(jnp.asarray(A))
    close64(TI.gauss_jordan_inv_plain(t(A)), ref)
    close64(TI.gauss_jordan_inv_select_plain(t(A)), ref)
    close64(TI.gauss_jordan_inv_plain(t(A)),
            np.linalg.inv(A.transpose(2, 0, 1)).transpose(1, 2, 0))


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor goes to the plain version and launches no kernel."""
    rng = np.random.default_rng(3)
    kernels.reset_launches()
    nu, m = 2 * D1, 50
    A, P, x = (t(rng.standard_normal(s)) for s in ((D1, D1, m), (1, nu, nu), (nu, m)))
    assert torch.equal(TP.fact_apply(A, P, (0, m), x), TP.fact_apply_plain(A, P, (0, m), x))
    y = TP.cross_pair(A, A, P, P, (0, m), x, x)
    assert all(torch.equal(a, b) for a, b in zip(y, TP.cross_pair_plain(A, A, P, P, (0, m), x, x)))
    Di = t(rng.standard_normal((nu, nu, m)))
    y = TP.patch_solve(Di, Di, A, A, P[0], P[0], x, x, 0)
    ref = TP.patch_solve_plain(Di, Di, A, A, P[0], P[0], x, x, 0)
    assert all(torch.equal(a, b) for a, b in zip(y, ref))
    G = Di + 5.0 * torch.eye(nu, dtype=Di.dtype)[:, :, None]
    assert torch.equal(TI.gauss_jordan_inv_bl(G), TI.gauss_jordan_inv_plain(G))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_kernel_sources_and_metadata():
    """Every kernel has its CUDA source, names the Pallas function it
    replaces, and notes the bound and the design in its header."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    assert set(kernels.KERNELS) == {"fact_apply", "cross_pair", "patch_solve", "gauss_jordan",
                                    "gauss_jordan_select", "fact_apply_wide", "cross_pair_wide",
                                    "cross_pair_cluster", "patch_solve_wide", "gauss_jordan_wide",
                                    "gauss_jordan_blocked", "patch_solve_bf16",
                                    "patch_solve_wide_bf16"}
    assert kernels.all_sources() == ["fact_apply", "cross_pair", "patch_solve", "gauss_jordan",
                                     "gauss_jordan_select", "wide_apply", "cross_pair_cluster",
                                     "patch_solve_wide", "gauss_jordan_wide"]
    for name, (entry, argtypes, replaces) in kernels.KERNELS.items():
        src = (root / kernels.source_path(name)).read_text()
        fn = replaces.split()[-1]
        path, line = replaces.split()[0].split(":")
        assert fn in src and entry in src and "What bounds it" in src
        assert f"def {fn}(" in (root / path).read_text().splitlines()[int(line) - 1]


# ----------------------------------------------------------------------
# k = 4: d1 = 21 tables and n = 42 inverses
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    """Flat factored operator at k = 4 on a non-periodic 4 x 2 mesh."""
    disc = JDisc(unit_square_mesh(4, 2), 4)
    geom = disc.geom
    assert geom.d1 == 21
    rng = np.random.default_rng(31)
    star = j_star_fields(geom, jnp.asarray(rng.standard_normal((2, geom.d1, geom.n_cells))))
    jop = JP.build_tentative_operator(geom, star, 0.01, 1.0, True)
    assert jop.Sown is not None and jop.Ks01.ndim == 3
    return disc, geom, jop, convert.tentative_operator_from_jax(jop), rng


def test_fact_apply_plain_matches_fallback_k4(wide):
    disc, geom, jop, top, rng = wide
    nch = geom.shift[0] * geom.shift[1]
    xc = rng.standard_normal((42, geom.n_cells))
    close64(TP.fact_apply_plain(top.Sown, top.Pcell, (0, nch, geom.n_cells), t(xc)),
            JP._fact_apply(geom, jop.Sown, jop.Pcell, jnp.asarray(xc), per="half"))
    xf = rng.standard_normal((42, geom.n_facets))
    close64(TP.fact_apply_plain(top.Ks01, top.Bp, geom.fcol_bounds, t(xf)),
            JP._fact_apply(geom, jop.Ks01, jop.Bp, jnp.asarray(xf), per="color"))


def test_cross_pair_plain_matches_fallback_k4(wide):
    disc, geom, jop, top, rng = wide
    u0, u1 = rng.standard_normal((2, 42, geom.n_facets))
    got = TP.cross_pair_plain(top.Ks01, top.Ks10, top.Bp, top.Cp, geom.fcol_bounds, t(u0), t(u1))
    ref = JP._cross_pair_full(geom, jop, jnp.asarray(u0), jnp.asarray(u1))
    close64(got[0], ref[0])
    close64(got[1], ref[1])


@pytest.mark.parametrize("k", [0, 1, 2])
def test_patch_solve_plain_matches_fallback_k4(wide, k):
    disc, geom, jop, top, rng = wide
    rb = rng.standard_normal((42, geom.n_cells))
    close64(TP._patch_color_structured(convert.geom_from_jax(disc), top, k, t(rb)),
            JP._patch_color_structured(geom, jop, k, jnp.asarray(rb)))


def _gj_old_interpret(A, block):
    """tools/microbench_gj.py's ``_gj_old`` Pallas kernel in interpret mode.
    Importing the tool sets three jax.config values; they are restored."""
    import jax
    from jax.experimental import pallas as pl

    names = ("jax_default_matmul_precision", "jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    try:
        path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "microbench_gj.py"
        spec = importlib.util.spec_from_file_location("_microbench_gj", path)
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    n, _, m = A.shape
    spec = pl.BlockSpec((n, n, block), lambda i: (0, 0, i))
    return pl.pallas_call(tool._gj_old_kernel_factory(n), grid=(m // block,), in_specs=[spec],
                          out_specs=spec, out_shape=jax.ShapeDtypeStruct(A.shape, A.dtype),
                          interpret=True)(A)


@pytest.mark.parametrize("n, dtype", [(8, np.float32), (42, np.float32), (42, np.float64)])
def test_gauss_jordan_select_plain_matches_pallas(n, dtype):
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((n, n, 256)) * 0.1 + 3.0 * np.eye(n)[:, :, None]).astype(dtype)
    ref = _gj_old_interpret(jnp.asarray(A), 128)
    got = TI.gauss_jordan_inv_select_plain(t(A))
    if dtype == np.float32:
        assert maxerr(got, ref) <= 5e-5
    else:
        close64(got, ref)
        close64(got, np.linalg.inv(A.transpose(2, 0, 1)).transpose(1, 2, 0))


def test_gauss_jordan_select_on_cpu():
    """K5's wrapper on CPU tensors is its plain version; the main-path
    dispatch inverts n = 42 blocks on the CPU too."""
    rng = np.random.default_rng(9)
    A = t(rng.standard_normal((42, 42, 30)) * 0.1 + 3.0 * np.eye(42)[:, :, None])
    kernels.reset_launches()
    assert torch.equal(TI.gauss_jordan_inv_select(A), TI.gauss_jordan_inv_select_plain(A))
    close64(TI.gauss_jordan_inv_bl(A), TI.gauss_jordan_inv_select_plain(A).numpy())
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_card_refuses_widths_beyond_k4():
    """On the card every width passes the width dispatch: d1 = 21, 28, 36
    (k = 4 .. 6) go to K1, K2c and K3w, d1 = 45, 55, 78 (k = 7, 8, 10) to
    K1w, K2c and K3w,
    n = 42 .. 72 to K5 and n = 90, 110, 182 (k = 7, 8, 11) to K5w, and each
    fails only for want of a CUDA tensor.  K5's own entry point still takes
    n <= 72; K3w has a plan at d1 = 91 and 200 (k = 11, 18: without a
    cluster) and refuses a width whose facet vectors fit no thread block,
    K5w none short of float64 n = 7,264."""

    def tables(d1):
        nu = 2 * d1
        A = torch.empty(d1, d1, 10, device="meta")
        Pm = torch.empty(1, nu, nu, device="meta")
        x = torch.empty(nu, 10, device="meta")
        D = torch.empty(nu, nu, 10, device="meta")
        return (lambda: TP.fact_apply(A, Pm, (0, 10), x),
                lambda: TP.cross_pair(A, A, Pm, Pm, (0, 10), x, x),
                lambda: TP.patch_solve(D, D, A, A, Pm[0], Pm[0], x, x, 0))

    for d1 in (21, 28, 36, 45, 55, 78):
        assert (d1 in TP.CUDA_D1) == (d1 <= 36)
        assert (d1 in TP.CROSS_D1) == (d1 <= 15)
        assert (d1 in TP.PATCH_D1) == (d1 <= 15)
        assert TP.width_kernels(d1)[1] == "cross_pair_cluster"  # measured faster to d1 = 91
        for call in tables(d1):
            with pytest.raises(ValueError, match="CUDA"):
                call()
    for n in (42, 56, 72, 90, 110, 182):
        with pytest.raises(ValueError, match="CUDA"):
            TI.gauss_jordan_inv_bl(torch.empty(n, n, 10, device="meta"))
        with pytest.raises(ValueError, match="CUDA"):
            TI.gauss_jordan_inv_wide(torch.empty(n, n, 10, device="meta"))
        if n <= 72:
            with pytest.raises(ValueError, match="CUDA"):
                TI.gauss_jordan_inv_select(torch.empty(n, n, 10, device="meta"))
        else:
            with pytest.raises(NotImplementedError, match="gauss_jordan_wide"):
                TI.gauss_jordan_inv_select(torch.empty(n, n, 10, device="meta"))
    for d1 in (28, 36, 45, 55):
        for dtype in (torch.float32, torch.float64):
            assert TP.patch_wide_plan(d1, dtype)["CS"] <= TP.PATCH_WIDE_CLUSTER_MAX
    # k = 11: the plan without a cluster (no cluster of 8 holds a rank's
    # rows of Dinv0 there)
    assert TP.patch_wide_plan(91, torch.float64)["CS"] == 0
    with pytest.raises(NotImplementedError, match="patch_solve_wide"):
        TP.patch_wide_plan(91, torch.float64, F=8, CS=8)
    assert TP.patch_wide_plan(200, torch.float64)["F"] == 16
    with pytest.raises(NotImplementedError, match="patch_solve_wide"):
        TP.patch_wide_plan(700, torch.float64)
    assert TI.wide_gj_plan(1000, torch.float64)["path"] == "blocked"
    with pytest.raises(NotImplementedError, match="gauss_jordan_wide"):
        TI.wide_gj_plan(8000, torch.float64)


# ----------------------------------------------------------------------
# CUDA card only: each kernel against its plain version
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_fact_apply(cuda, dtype):
    g = torch.Generator().manual_seed(1)
    d1, m = 10, 1000
    A = torch.randn(d1, d1, m + 77, generator=g, dtype=dtype).to(cuda)
    P = torch.randn(2, 2 * d1, 2 * d1, generator=g, dtype=dtype).to(cuda)
    x = torch.randn(2 * d1, m, generator=g, dtype=dtype).to(cuda)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert _rel(TP.fact_apply(A, P, (0, 300, 900), x, aoff=77),
                TP.fact_apply_plain(A, P, (0, 300, 900), x, aoff=77)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cross_pair(cuda, dtype):
    g = torch.Generator().manual_seed(2)
    d1, m = 6, 1000
    K = torch.randn(2, d1, d1, m + 5, generator=g, dtype=dtype).to(cuda)
    P = torch.randn(2, 3, 2 * d1, 2 * d1, generator=g, dtype=dtype).to(cuda)
    x = torch.randn(2, 2 * d1, m, generator=g, dtype=dtype).to(cuda)
    b = (0, 100, 500, 990)
    with pytest.raises(ValueError, match="pad_table"):  # 1005 columns: rows not 16-byte aligned
        TP.cross_pair(K[0], K[1], P[0], P[1], b, x[0], x[1], aoff=5)
    K = [TP.pad_table(k) for k in K]
    got = TP.cross_pair(K[0], K[1], P[0], P[1], b, x[0], x[1], aoff=5)
    ref = TP.cross_pair_plain(K[0], K[1], P[0], P[1], b, x[0], x[1], aoff=5)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_patch_solve(cuda, dtype):
    g = torch.Generator().manual_seed(3)
    d1, ld, m, off = 10, 1200, 1001, 150
    Di, Si = torch.randn(2, 2 * d1, 2 * d1, ld, generator=g, dtype=dtype).to(cuda)
    K01, K10 = torch.randn(2, d1, d1, ld, generator=g, dtype=dtype).to(cuda)
    Bp, Cp = torch.randn(2, 2 * d1, 2 * d1, generator=g, dtype=dtype).to(cuda)
    r0, r1 = torch.randn(2, 2 * d1, m, generator=g, dtype=dtype).to(cuda)
    got = TP.patch_solve(Di, Si, K01, K10, Bp, Cp, r0, r1, off)
    ref = TP.patch_solve_plain(Di, Si, K01, K10, Bp, Cp, r0, r1, off)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d1", [3, 6, 10, 15])
def test_cuda_patch_solve_bf16(cuda, d1):
    """K3's bfloat16-factor variant (IEHDG_PC_BF16=1): bfloat16 Dinv0/Sinv
    of one column stride, float32 K01/K10 of another, against the plain
    version (which upcasts the factors) within 1e-4 of the largest entry;
    it launches the variant, never the float32 kernel; factors of any other
    dtype, or with float64 vectors, raise before a launch."""
    g = torch.Generator().manual_seed(30 + d1)
    nu, m, off = 2 * d1, 1001, 150
    f = lambda *s: torch.randn(*s, generator=g).to(cuda)
    fac = (f(2, nu, nu, 1208) / nu).to(torch.bfloat16)
    Di, Si = fac[:, :, :, :1200]
    K01, K10 = f(2, d1, d1, 1204)[:, :, :, :1200]
    Bp, Cp = f(2, nu, nu) / nu
    r0, r1 = f(2, nu, m)
    assert Di.stride(1) == 1208 and K01.stride(1) == 1204
    kernels.reset_launches()
    got = TP.patch_solve(Di, Si, K01, K10, Bp, Cp, r0, r1, off)
    assert kernels.LAUNCHES["patch_solve_bf16"] == 1 and kernels.LAUNCHES["patch_solve"] == 0
    ref = TP.patch_solve_plain(Di, Si, K01, K10, Bp, Cp, r0, r1, off)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= 1e-4
    for fac, vec in ((torch.float16, torch.float32), (torch.bfloat16, torch.float64)):
        with pytest.raises(TypeError):
            TP.patch_solve(Di.to(fac), Si.to(fac), K01.to(vec), K10.to(vec), Bp.to(vec),
                           Cp.to(vec), r0.to(vec), r1.to(vec), off)
    assert kernels.LAUNCHES["patch_solve_bf16"] == 1 and kernels.LAUNCHES["patch_solve"] == 0


def _check_gj_batches(name, wrapper, plain, n, dtype, seed, device):
    """``wrapper`` against ``plain`` on (n, n, B) blocks for B = 1, one less
    and one more than the kernel's batch per thread block, and 777, and on a
    non-contiguous view; every call launches kernel ``name`` once."""
    g = torch.Generator().manual_seed(seed)
    tol = 5e-5 if dtype == torch.float32 else 1e-11
    bb = TI.launch_plan(name, dtype, n)["BB"]
    blocks = lambda m: (0.1 * torch.randn(n, n, m, generator=g, dtype=dtype)
                        + 3.0 * torch.eye(n, dtype=dtype)[:, :, None]).to(device)
    cases = [blocks(m) for m in (1, bb - 1, bb + 1, 777)]
    cases.append(blocks(2 * 777)[:, :, 1::2])
    assert not cases[-1].is_contiguous()
    kernels.reset_launches()
    for A in cases:
        assert float((wrapper(A) - plain(A)).abs().max()) <= tol
    assert kernels.LAUNCHES[name] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 20, 30, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gauss_jordan(cuda, dtype, n):
    _check_gj_batches("gauss_jordan", TI.gauss_jordan_inv_bl, TI.gauss_jordan_inv_plain,
                      n, dtype, 4 + n, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_d1_21(cuda, dtype):
    """K1, the cross pair (K2c) and the patch solve (K3w) at the k = 4
    width against their plain versions, with a colour offset and a column
    count that is not a multiple of the thread block."""
    g = torch.Generator().manual_seed(5)
    d1, ld, m, off = 21, 1300, 1001, 150
    nu = 2 * d1
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(cuda)
    A, K01, K10 = rnd(d1, d1, ld), rnd(d1, d1, ld), rnd(d1, d1, ld)  # 1300: aligned rows
    P3, Q3 = rnd(3, nu, nu), rnd(3, nu, nu)
    x0, x1 = rnd(nu, m), rnd(nu, m)
    Di, Si = rnd(nu, nu, ld), rnd(nu, nu, ld)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    b = (0, 100, 500, 990)
    assert _rel(TP.fact_apply(A, P3, b, x0, aoff=off),
                TP.fact_apply_plain(A, P3, b, x0, aoff=off)) <= tol
    got = TP.cross_pair(K01, K10, P3, Q3, b, x0, x1, aoff=off)
    ref = TP.cross_pair_plain(K01, K10, P3, Q3, b, x0, x1, aoff=off)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol
    got = TP.patch_solve(Di, Si, K01, K10, P3[0], Q3[0], x0, x1, off)
    ref = TP.patch_solve_plain(Di, Si, K01, K10, P3[0], Q3[0], x0, x1, off)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 33, 42, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gauss_jordan_select(cuda, dtype, n):
    """K5 against the select formulation's plain version, and the main-path
    dispatch of n = 42 blocks to K5."""
    _check_gj_batches("gauss_jordan_select", TI.gauss_jordan_inv_select,
                      TI.gauss_jordan_inv_select_plain, n, dtype, 6 + n, cuda)
    if n > TI.K4_MAX_N:
        g = torch.Generator().manual_seed(6)
        tol = 5e-5 if dtype == torch.float32 else 1e-11
        A = (0.1 * torch.randn(n, n, 777, generator=g, dtype=dtype)
             + 3.0 * torch.eye(n, dtype=dtype)[:, :, None]).to(cuda)
        kernels.reset_launches()
        assert float((TI.gauss_jordan_inv_bl(A) - TI.gauss_jordan_inv_plain(A)).abs().max()) <= tol
        assert kernels.LAUNCHES["gauss_jordan_select"] == 1 and kernels.LAUNCHES["gauss_jordan"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d1", [10, 21])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tma_kernels_ragged(cuda, dtype, d1):
    """The cross pair (K2 at d1 = 10, K2c at 21) and the patch solve (TMA
    tiles: K3 at d1 = 10, K3w at 21) against their plain versions on a
    padded table of an odd column count, a colour at an odd offset whose
    size is not a multiple of the tile, and (the cross pair) segments that
    start and end inside tiles, one shorter than a tile, and a
    penalty-free tail."""
    g = torch.Generator().manual_seed(7 + d1)
    nu, nf = 2 * d1, 2 * 1001 + 1  # odd: the padded stride differs from nf
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(cuda)
    K01, K10 = TP.pad_table(rnd(d1, d1, nf)), TP.pad_table(rnd(d1, d1, nf))
    Di, Si = TP.pad_table(rnd(nu, nu, nf)), TP.pad_table(rnd(nu, nu, nf))
    assert K01.stride(1) == kernels.padded_ld(nf, dtype) > nf
    tc2, tc3 = TP.tile_facets("cross_pair", d1, dtype), TP.tile_facets("patch_solve", d1, dtype)
    off, m = 333, 1001 - 4  # odd: no multiple of any tile, unaligned tiles
    assert m % tc2 and m % tc3 and off % tc3
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    P4, Q4 = rnd(4, nu, nu), rnd(4, nu, nu)
    b = (0, tc2 + 3, tc2 + 5, 4 * tc2 + 1, m - 7)
    x0, x1 = rnd(nu, nf - off), rnd(nu, nf - off)
    kernels.reset_launches()
    for aoff in (0, off):
        got = TP.cross_pair(K01, K10, P4, Q4, b, x0[:, :m], x1[:, :m], aoff=aoff)
        ref = TP.cross_pair_plain(K01, K10, P4, Q4, b, x0[:, :m], x1[:, :m], aoff=aoff)
        assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol
    for mm in (m, nf - off, 1):  # ragged, up to the last column, one facet
        got = TP.patch_solve(Di, Si, K01, K10, P4[0], Q4[0], x0[:, :mm], x1[:, :mm], off)
        ref = TP.patch_solve_plain(Di, Si, K01, K10, P4[0], Q4[0], x0[:, :mm], x1[:, :mm], off)
        assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= tol
    assert kernels.LAUNCHES[TP.width_kernels(d1, dtype)[1]] == 2
    assert kernels.LAUNCHES[TP.width_kernels(d1, dtype)[2]] == 3


@pytest.mark.cuda
def test_cuda_operator_tables_padded(cuda):
    """build_tentative_operator on the card allocates the tables the TMA
    kernels read (odd nx, so nf is odd), and one fused sweep through K2 and
    K3 matches the same sweep on the CPU."""
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh as t_mesh
    from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields

    mesh = t_mesh(9, 7)
    out = []
    for dev in ("cpu", cuda):
        disc = HDGDiscretisation(mesh, 2, dtype=torch.float64, device=dev)
        geom = disc.geom
        rng = np.random.default_rng(12)
        u = torch.as_tensor(rng.standard_normal((2, geom.d1, geom.n_cells)), device=dev)
        op = TP.build_tentative_operator(geom, star_fields(geom, u), 0.01)
        assert geom.n_facets % 2 == 1
        kernels.table_ld("check", op.Dinv0, op.Sinv, op.Ks01, op.Ks10)
        v = torch.as_tensor(rng.standard_normal((2 * geom.d1, geom.n_cells)), device=dev)
        out.append([a.cpu() for a in TP._colored_apply_fused_bl(geom, op, v)])
    for a, b in zip(*out):
        assert _rel(b, a) <= 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gauss_jordan_identity_blocks(cuda, dtype):
    """K4 on one batch that mixes identity blocks (pivots of exactly 1, the
    boundary facets of the disk's Schur batch) with blocks whose pivots span
    three decades, S (I + 0.05 R) S with S = diag(10^-1.5 .. 1) (the disk's
    blocks are mass-scaled like this), against its plain version."""
    g = torch.Generator().manual_seed(21)
    n, m = 20, 2 * 777
    S = torch.logspace(-1.5, 0, n, dtype=dtype)
    A = S[:, None, None] * (torch.eye(n, dtype=dtype)[:, :, None]
                            + 0.05 * torch.randn(n, n, m, generator=g, dtype=dtype)) * S[None, :, None]
    A[:, :, ::3] = torch.eye(n, dtype=dtype)[:, :, None]
    A = A.to(cuda)
    kernels.reset_launches()
    got, ref = TI.gauss_jordan_inv_bl(A), TI.gauss_jordan_inv_plain(A)
    assert kernels.LAUNCHES["gauss_jordan"] == 1
    assert torch.equal(got[:, :, ::3], A[:, :, ::3])
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    assert _rel(got, ref) <= tol


def _build_on(dev, mesh, k, dtype, seed):
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields

    disc = HDGDiscretisation(mesh, k, dtype=dtype, device=dev)
    geom = disc.geom
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((2, geom.d1, geom.n_cells)), dtype=dtype, device=dev)
    v = torch.as_tensor(rng.standard_normal((2 * geom.d1, geom.n_cells)), dtype=dtype, device=dev)
    kernels.reset_launches()
    op = TP.build_tentative_operator(geom, star_fields(geom, u), 0.01)
    return geom, op, v, dict(kernels.LAUNCHES)


@pytest.mark.cuda
def test_cuda_periodic_path(cuda):
    """The wrapped 8^2, k = 2 mesh on the card: three colours of 64 facets
    at offsets 0, 64 and 128 and no tail; the operator build (K4), the fused
    sweep (K1-K3) and the multiplicative sweep match the CPU in float64."""
    from incompressibleeulerhdg_tpu_torch.mesh import periodic_square_mesh

    mesh = periodic_square_mesh(8)
    out = []
    for dev in ("cpu", cuda):
        geom, op, v, built = _build_on(dev, mesh, 2, torch.float64, 13)
        assert geom.fcol_bounds == (0, 64, 128, 192) and geom.n_int == geom.n_facets
        kernels.reset_launches()
        res = [*TP._colored_apply_fused_bl(geom, op, v), TP._matvec_bl(geom, op, v),
               TP._colored_apply_bl(geom, op, v, symmetric=True), op.Sinv, op.Dinv0]
        out.append([a.cpu() for a in res])
        if dev != "cpu":
            assert built["gauss_jordan"] == 4  # own cells, then one per colour
            assert all(kernels.LAUNCHES[n] > 0 for n in ("fact_apply", "cross_pair",
                                                         "patch_solve"))
    for a, b in zip(*out):
        assert _rel(b, a) <= 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_disk_path(cuda, dtype):
    """The unit disk (refinement 3, k = 2) on the card: the dense operator's
    two inverses go to K4 (the Schur batch with its identity blocks), K1-K3
    never launch, and the sweep and the tentative solve match the CPU."""
    from incompressibleeulerhdg_tpu_torch.linalg.tentative import tentative_solve
    from incompressibleeulerhdg_tpu_torch.mesh import unit_disk_mesh

    mesh = unit_disk_mesh(3)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    out = []
    for dev in ("cpu", cuda):
        geom, op, v, built = _build_on(dev, mesh, 2, dtype, 14)
        kernels.reset_launches()
        z = TP._colored_apply_bl(geom, op, v, symmetric=True)
        u, its, _ = tentative_solve(geom, op, v.reshape(2, geom.d1, -1), rtol=1e-6, restart=28)
        out.append(([a.cpu() for a in (op.Dinv, op.Sinv, z, u)], its))
        if dev != "cpu":
            assert built["gauss_jordan"] == 2
            assert sum(kernels.LAUNCHES[n] for n in ("fact_apply", "cross_pair",
                                                     "patch_solve")) == 0
    (cpu, its_cpu), (card, its_card) = out
    for a, b in zip(card, cpu):
        assert _rel(a, b) <= tol
    assert its_card == its_cpu > 0


def test_pad_table_layout():
    """pad_table: 16-byte rows, same values, the plain versions read the view;
    an aligned contiguous table comes back as it is."""
    rng = np.random.default_rng(4)
    for dtype, per in ((torch.float32, 4), (torch.float64, 2)):
        for n in (1, 5, 8, 1003):
            A = torch.as_tensor(rng.standard_normal((3, 4, n)), dtype=dtype)
            Ap = TP.pad_table(A)
            ld = kernels.padded_ld(n, dtype)
            assert ld % per == 0 and n <= ld < n + per
            assert Ap.shape == A.shape and Ap.stride() == (4 * ld, ld, 1) and torch.equal(Ap, A)
            assert kernels.table_ld("t", Ap) == ld
            assert (TP.pad_table(Ap) is Ap) and ((n % per == 0) == (TP.pad_table(A) is A))
            if n % per:
                with pytest.raises(ValueError, match="pad_table"):
                    kernels.table_ld("t", A)
    x = torch.as_tensor(rng.standard_normal((8, 1003)))
    K = torch.as_tensor(rng.standard_normal((4, 4, 1003)))
    P = torch.as_tensor(rng.standard_normal((1, 8, 8)))
    assert torch.equal(TP.fact_apply_plain(TP.pad_table(K), P, (0, 1000), x[:, :1000], aoff=3),
                       TP.fact_apply_plain(K, P, (0, 1000), x[:, :1000], aoff=3))


@pytest.mark.parametrize("kernel", ["cross_pair", "patch_solve"])
def test_tile_facets(kernel):
    """The TMA tiles: 16-byte facet groups, table rows of 16 to 128 bytes,
    and (K3) a block's four tables under a third of the SM's shared memory
    at d1 <= 10 (three blocks an SM), under the 227 KB a block may use."""
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        for d1 in TP.CUDA_D1 if kernel == "cross_pair" else TP.PATCH_D1:
            tc = TP.tile_facets(kernel, d1, dtype)
            assert (tc * size) % 16 == 0 and 16 <= tc * size <= 128
            nu = 2 * d1
            rows = 2 * d1 * d1 + (2 * nu * nu if kernel == "patch_solve" else 0)
            assert rows * tc * size <= (76_000 if d1 <= 10 else 232_448)
    with pytest.raises(ValueError):
        TP.tile_facets("fact_apply", 10, torch.float32)


def test_operator_tables_padded_on_cpu():
    """build_tentative_operator allocates Dinv0, Sinv, Ks01 and Ks10 with
    16-byte rows also on the CPU (odd nf), and the fused sweep over the
    padded tables equals the sweep over contiguous copies."""
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh as t_mesh
    from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields

    disc = HDGDiscretisation(t_mesh(5, 3), 1, dtype=torch.float32, device="cpu")
    geom = disc.geom
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.standard_normal((2, geom.d1, geom.n_cells)), dtype=torch.float32)
    op = TP.build_tentative_operator(geom, star_fields(geom, u), 0.01)
    assert geom.n_facets % 4
    ld = kernels.table_ld("t", op.Dinv0, op.Sinv, op.Ks01, op.Ks10)
    assert ld == kernels.padded_ld(geom.n_facets, torch.float32) > geom.n_facets
    dense = TP.TentativeOperator(**{f: getattr(op, f).contiguous() for f in op.__dataclass_fields__
                                    if getattr(op, f) is not None})
    v = torch.as_tensor(rng.standard_normal((2 * geom.d1, geom.n_cells)), dtype=torch.float32)
    for a, b in zip(TP._colored_apply_fused_bl(geom, op, v), TP._colored_apply_fused_bl(geom, dense, v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("empty_sessions", [0, 1, 3])
def test_device_time_retries_then_falls_back(monkeypatch, empty_sessions):
    """The kernel timer of chip_smoke.py and tools/ab_cross_patch.py repeats a
    profiler session that recorded no device time and, after three empty
    sessions, times with CUDA events; it never returns a time of zero.  The
    profiler and the events are stubbed here, where there is no card."""
    from incompressibleeulerhdg_tpu_torch.tools import ab_cross_patch as AB

    sessions = []

    def profiled_us(fn, reps, match):
        sessions.append(match)
        return (0.0, 0) if len(sessions) <= empty_sessions else (500.0 * reps, reps)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(AB, "_profiled_us", profiled_us)
    # within EVENTS_RATIO of the profiler's read, which the events check keeps
    monkeypatch.setattr(AB, "_events_ms", lambda fn, reps: 0.55)
    calls = []
    ms, timer = AB.device_time(lambda: calls.append(1), reps=4, match="k_kernel")
    if empty_sessions < AB.PROFILER_ATTEMPTS:
        assert (ms, timer) == (0.5, "profiler")
        assert sessions == ["k_kernel"] * (empty_sessions + 1)
    else:
        assert (ms, timer) == (0.55, "cuda events")
        assert sessions == ["k_kernel"] * AB.PROFILER_ATTEMPTS
    assert calls == [1]  # the warm-up call; the stubs make no calls of their own


def test_device_time_divides_by_recorded_launches(monkeypatch):
    """With ``match``, the kernel's time is divided by the launches the
    profiler recorded, so a session that lost some launches still reads the
    time of one; without ``match``, by the number of calls."""
    from incompressibleeulerhdg_tpu_torch.tools import ab_cross_patch as AB

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(AB, "_profiled_us", lambda fn, reps, match: (300.0 * (reps - 2), reps - 2))
    monkeypatch.setattr(AB, "_events_ms", lambda fn, reps: 0.25)  # checked reads: close
    assert AB.device_time(lambda: None, reps=10, match="k_kernel") == (0.3, "profiler")
    assert AB.device_time(lambda: None, reps=10) == (0.24, "profiler")


@pytest.mark.parametrize("reads", [1, 4, 5])
def test_in_turns_reverses_order_and_keeps_the_median(reads):
    """The A/B timer of tools/ab_cross.py and tools/ab_patch.py reads every
    kernel ``reads`` times, the order reversed on every other turn, and
    keeps the median read: one short read (a profiler session that lost
    part of a launch's time) does not decide the A/B."""
    from incompressibleeulerhdg_tpu_torch.tools import ab_cross_patch as AB

    order, times = [], {"a": [2.0, 0.5, 2.0, 2.0, 2.0], "b": [1.5] * 5}

    def timer(run):
        order.append(run)
        return times[run][sum(r == run for r in order) - 1]

    best, got = AB.in_turns({"a": "a", "b": "b"}, timer, reads)
    assert order == [n for t in range(reads) for n in ("ab" if t % 2 == 0 else "ba")]
    assert got == {n: v[:reads] for n, v in times.items()}
    assert best == {"a": 2.0, "b": 1.5}


def test_graph_ms_times_replays_of_captured_calls(monkeypatch):
    """graph_ms makes one warm-up call, captures ``reps`` calls in one CUDA
    graph, replays it once to warm up and ``replays`` times between two
    events, and divides their interval by ``replays * reps``.  The graph
    and the events are stubbed here, where there is no card."""
    from incompressibleeulerhdg_tpu_torch.tools import ab_cross_patch as AB

    log = []

    class Graph:
        def replay(self):
            log.append("replay")

        def reset(self):
            log.append("reset")

    class Capture:
        def __init__(self, graph):
            assert isinstance(graph, Graph)

        def __enter__(self):
            log.append("capture")

        def __exit__(self, *exc):
            log.append("captured")

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            log.append("event")

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 60.0

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    assert AB.graph_ms(lambda: log.append("call"), reps=4, replays=3) == 5.0
    assert log == ["call", "capture", *["call"] * 4, "captured", "replay", "event",
                   *["replay"] * 3, "event", "reset"]


@pytest.mark.parametrize("events_ms, expected",
                         [(0.75, (0.75, "cuda events (longer than the profiler's)")),
                          (0.55, (0.5, "profiler"))])
def test_device_time_checks_long_kernels_against_events(monkeypatch, events_ms, expected):
    """A profiler read of 0.2 ms or more a call is checked against CUDA
    events, with ``match`` or without: a session that kept part of a
    launch's time (events more than 1.2 times longer) gives way to the
    events; a close read stays the profiler's.  Shorter reads skip the
    events."""
    from incompressibleeulerhdg_tpu_torch.tools import ab_cross_patch as AB

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(AB, "_profiled_us", lambda fn, reps, match: (500.0 * reps, reps))
    monkeypatch.setattr(AB, "_events_ms", lambda fn, reps: events_ms)
    assert AB.device_time(lambda: None, reps=4, match="k_kernel") == expected
    assert AB.device_time(lambda: None, reps=4) == expected
    monkeypatch.setattr(AB, "_profiled_us", lambda fn, reps, match: (100.0 * reps, reps))
    monkeypatch.setattr(AB, "_events_ms", lambda fn, reps: pytest.fail("events read"))
    assert AB.device_time(lambda: None, reps=4, match="k_kernel") == (0.1, "profiler")
