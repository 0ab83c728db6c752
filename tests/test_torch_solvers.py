"""Parity of the PyTorch port's solvers with the JAX package: GMRES, the GTMG
preconditioner, the pressure solve, the per-stage tentative operator and its
fused colored Schwarz sweep, and the tentative solve.

float64 on the CPU; Krylov solves must take the same number of iterations
and agree to 1e-10, operators and tables to 1e-12 (relative to the
reference's largest entry).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.ops.forms import star_fields as j_star
from incompressibleeulerhdg_tpu.linalg import condense as JC
from incompressibleeulerhdg_tpu.linalg import gtmg as JG
from incompressibleeulerhdg_tpu.linalg import krylov as JK
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.linalg.pressure import pressure_solve as j_pressure_solve
from incompressibleeulerhdg_tpu.linalg import tentative as JT

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields as t_star
from incompressibleeulerhdg_tpu_torch.linalg import condense as TC
from incompressibleeulerhdg_tpu_torch.linalg import gtmg as TG
from incompressibleeulerhdg_tpu_torch.linalg import krylov as TK
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.linalg.pressure import pressure_solve as t_pressure_solve
from incompressibleeulerhdg_tpu_torch.linalg import tentative as TT

torch.set_num_threads(1)


def close(got, ref, rtol=1e-12):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


# ----------------------------------------------------------------------
# linalg/krylov.py
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(41)
    n = 80
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.6 / np.sqrt(n)
    A[np.arange(n), np.arange(n)] += np.linspace(0.0, 6.0, n)
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    return A, b, dinv


@pytest.mark.parametrize("restart", [6, 40])
def test_gmres_left(system, restart):
    A, b, dinv = system
    jx, jit, jres = JK.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             M=lambda v: jnp.asarray(dinv) * v, rtol=1e-11, restart=restart)
    tA, tdinv = torch.as_tensor(A), torch.as_tensor(dinv)
    tx, tit, tres = TK.gmres(lambda v: tA @ v, torch.as_tensor(b), M=lambda v: tdinv * v,
                             rtol=1e-11, restart=restart)
    assert tit == int(jit) and tit > restart * (restart < 20)
    close(tx, jx, 1e-10)
    np.testing.assert_allclose(tres, float(jres), rtol=1e-6)


@pytest.mark.parametrize("restart", [6, 40])
def test_gmres_right(system, restart):
    A, b, dinv = system
    jA, jd = jnp.asarray(A), jnp.asarray(dinv)
    tA, td = torch.as_tensor(A), torch.as_tensor(dinv)
    jx, jit, jres = JK.gmres_right(lambda v: (jd * v, jA @ (jd * v)), lambda v: jA @ v,
                                   jnp.asarray(b), rtol=1e-11, restart=restart)
    tx, tit, tres = TK.gmres_right(lambda v: (td * v, tA @ (td * v)), lambda v: tA @ v,
                                   torch.as_tensor(b), rtol=1e-11, restart=restart)
    assert tit == int(jit)
    close(tx, jx, 1e-10)
    # the true final residual is recomputed from x: at 1e-12 it is rounding noise
    assert tres < 1e-11 and float(jres) < 1e-11


def test_deflate_constant():
    v = np.random.default_rng(2).standard_normal(30)
    nv = np.ones(30) / np.sqrt(30)
    close(TK.deflate_constant(torch.as_tensor(nv))(torch.as_tensor(v)),
          JK.deflate_constant(jnp.asarray(nv))(jnp.asarray(v)))


# ----------------------------------------------------------------------
# pressure side: GTMG and the pressure solve
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pressure():
    jd = JDisc(unit_square_mesh(6, 5), 1)
    td = TDisc(unit_square_mesh(6, 5), 1, device="cpu")
    jcs = JC.build_condensed_system(jd)
    tcs = TC.build_condensed_system(td)
    return jd, td, jcs, tcs, JG.build_gtmg(jd, jcs), TG.build_gtmg(td, tcs)


def test_gtmg_tables(pressure):
    jd, td, jcs, tcs, jpc, tpc = pressure
    for name in ("Sdiag_inv", "trace_nodes", "coarse_eig_inv", "coarse_scale"):
        close(getattr(tpc, name), getattr(jpc, name))
    assert tpc.vshift == jpc.vshift and tpc.grid_shape == jpc.grid_shape
    assert tpc.sign == float(jpc.sign)
    np.testing.assert_allclose(tpc.lmax_fine, jpc.lmax_fine, rtol=1e-12)
    conv = convert.gtmg_from_jax(jpc)
    assert conv.vshift == tpc.vshift and conv.lmax_fine == jpc.lmax_fine


def test_gtmg_apply_and_transfers(pressure):
    jd, td, jcs, tcs, jpc, tpc = pressure
    rng = np.random.default_rng(9)
    zc = rng.standard_normal(jpc.n_vertices)
    close(TG.prolong(tpc, torch.as_tensor(zc)), JG.prolong(jpc, jnp.asarray(zc)))
    lam = rng.standard_normal((jcs.nt, jd.geom.n_facets))
    close(TG.restrict(tpc, torch.as_tensor(lam)), JG.restrict(jpc, jnp.asarray(lam)))
    rc = rng.standard_normal(jpc.n_vertices)
    close(TG._coarse_solve(tpc, torch.as_tensor(rc)), JG._coarse_solve(jpc, jnp.asarray(rc)))
    r = lam.ravel()
    close(TG.gtmg_apply(td.geom, tcs, tpc, torch.as_tensor(r)),
          JG.gtmg_apply(jd.geom, jcs, jpc, jnp.asarray(r)))


def test_pressure_solve(pressure):
    jd, td, jcs, tcs, jpc, tpc = pressure
    g = jd.geom
    rng = np.random.default_rng(10)
    f_u = rng.standard_normal((2, g.d1, g.n_cells))
    f_p = rng.standard_normal((g.d0, g.n_cells))
    f_lam = rng.standard_normal((g.nt, g.n_facets))
    jout = j_pressure_solve(g, jcs, *map(jnp.asarray, (f_u, f_p, f_lam)),
                            precond=lambda v: JG.gtmg_apply(g, jcs, jpc, v))
    tout = t_pressure_solve(td.geom, tcs, *map(torch.as_tensor, (f_u, f_p, f_lam)),
                            precond=lambda v: TG.gtmg_apply(td.geom, tcs, tpc, v))
    assert tout[3] == int(jout[3]) and tout[3] > 0
    for a, b in zip(tout[:3], jout[:3]):
        close(a, b, 1e-10)


# ----------------------------------------------------------------------
# tentative side: operator build, matvec, fused sweep, solve
# ----------------------------------------------------------------------


class Tent:
    def __init__(self, nx, ny, k, c):
        self.jd = JDisc(unit_square_mesh(nx, ny), k)
        self.td = TDisc(unit_square_mesh(nx, ny), k, device="cpu")
        g = self.jd.geom
        rng = np.random.default_rng(7 * nx + k)
        self.S = rng.standard_normal((2, g.d1, g.n_cells))
        self.u = rng.standard_normal((2, g.d1, g.n_cells))
        self.c = c
        self.jstar = j_star(g, jnp.asarray(self.S))
        self.tstar = t_star(self.td.geom, torch.as_tensor(self.S))
        self.jop = JP.build_tentative_operator(g, self.jstar, c, 1.0, True)
        self.top = TP.build_tentative_operator(self.td.geom, self.tstar, c, 1.0, True)


@pytest.fixture(scope="module", params=[(6, 5, 1), (4, 5, 2)], ids=["6x5k1", "4x5k2"])
def tent(request):
    return Tent(*request.param, c=0.01)


def test_tentative_operator_tables(tent):
    for name in ("Dinv", "Sinv", "Dinv0", "Sown", "Pcell", "Ks01", "Ks10", "Bp", "Cp"):
        close(getattr(tent.top, name), getattr(tent.jop, name))


def test_tentative_operator_blocks(tent):
    for a, b in zip(TP.dense_blocks(tent.td.geom, tent.top),
                    JP.dense_blocks(tent.jd.geom, tent.jop)):
        close(a, b)


def test_tentative_matvec_matches_weak_form(tent):
    """The assembled operator applies M - c f_impl of the weak form."""
    tg, jg = tent.td.geom, tent.jd.geom
    weak = JT.tentative_matvec(jg, tent.jstar, jnp.asarray(tent.u), tent.c)
    nu, nc = 2 * tg.d1, tg.n_cells
    assembled = TP._matvec_bl(tg, tent.top, torch.as_tensor(tent.u).reshape(nu, nc))
    close(assembled.reshape(tent.u.shape), weak)
    close(TT.tentative_matvec(tg, tent.tstar, torch.as_tensor(tent.u), tent.c), weak)


def test_fused_sweep(tent):
    tg, jg = tent.td.geom, tent.jd.geom
    nu = 2 * tg.d1
    v = tent.u.reshape(nu, -1)
    tz, tAz = TP._colored_apply_fused_bl(tg, tent.top, torch.as_tensor(v))
    jz, jAz = JP._colored_apply_fused_bl(jg, tent.jop, jnp.asarray(v), symmetric=True)
    close(tz, jz)
    close(tAz, jAz)


def test_tentative_solve(tent):
    tg, jg = tent.td.geom, tent.jd.geom
    rhs = tent.u
    ju, jit, _ = JT.tentative_solve(jg, tent.jstar, jnp.asarray(rhs), tent.c, op=tent.jop,
                                    restart=28, fused=1)
    tu, tit, trel = TT.tentative_solve(tg, tent.top, torch.as_tensor(rhs), restart=28)
    assert tit == int(jit) and tit > 0 and trel < 1e-9
    close(tu, ju, 1e-10)


def test_fused_sweep_refuses_orphan_cells(tent):
    import dataclasses

    g = dataclasses.replace(tent.td.geom, fcol_orphans=True)
    with pytest.raises(ValueError):
        TP._colored_apply_fused_bl(g, tent.top, torch.zeros(2 * g.d1, g.n_cells,
                                                            dtype=torch.float64))
    assert not tent.td.geom.fcol_orphans
