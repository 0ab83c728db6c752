"""Parity of the PyTorch port's geometry, field, form and condensation
modules with the JAX package, module by module.

Inputs are made with numpy from a seed and handed to both packages; JAX runs
in float64 (tests/conftest.py), the port in torch.float64 on the CPU.  Every
comparison is relative to the reference's largest entry, at 1e-12.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTaylorGreen
from incompressibleeulerhdg_tpu.ops import fields as JF
from incompressibleeulerhdg_tpu.ops import forms as JForms
from incompressibleeulerhdg_tpu.ops import structured as JS
from incompressibleeulerhdg_tpu.ops.projection import (
    build_bdm_projection as j_build_bdm,
    project_bdm as j_project_bdm,
)
from incompressibleeulerhdg_tpu.ops.reconstruction import (
    pressure_reconstruction_rhs as j_recon_rhs,
)
from incompressibleeulerhdg_tpu.linalg import condense as JC
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTaylorGreen
from incompressibleeulerhdg_tpu_torch.ops import fields as TF
from incompressibleeulerhdg_tpu_torch.ops import forms as TForms
from incompressibleeulerhdg_tpu_torch.ops import structured as TS
from incompressibleeulerhdg_tpu_torch.ops.projection import (
    build_bdm_projection as t_build_bdm,
    project_bdm as t_project_bdm,
)
from incompressibleeulerhdg_tpu_torch.ops.reconstruction import (
    pressure_reconstruction_rhs as t_recon_rhs,
)
from incompressibleeulerhdg_tpu_torch.linalg import condense as TC
from incompressibleeulerhdg_tpu_torch.timesteppers.common import IncompressibleEuler

torch.set_num_threads(1)

RTOL = 1e-12
# (nx, ny, k): a non-square grid catches transposed grid axes
CASES = [(6, 5, 1), (4, 5, 2)]


def close(got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-300) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rtol * scale, (err, scale)


class Pair:
    """One mesh/degree with both packages' discretisations and random
    fields (numpy, seeded) in the batch-last layouts."""

    def __init__(self, nx, ny, k):
        mesh = unit_square_mesh(nx, ny)
        self.jd = JDisc(mesh, k)
        self.td = TDisc(unit_square_mesh(nx, ny), k, device="cpu")
        self.jg, self.tg = self.jd.geom, self.td.geom
        g = self.jg
        rng = np.random.default_rng(100 * nx + 10 * ny + k)
        self.Q = rng.standard_normal((2, g.d1, g.n_cells))
        self.S = rng.standard_normal((2, g.d1, g.n_cells))
        self.F = rng.standard_normal((2, g.d1, g.n_cells))
        self.p = rng.standard_normal((g.d0, g.n_cells))
        self.lam = rng.standard_normal((g.nt, g.n_facets))
        self.cellf = rng.standard_normal((3, g.n_cells))
        self.facetf = rng.standard_normal((3, g.n_facets))

    def j(self, a):
        return jnp.asarray(a)

    def t(self, a):
        return torch.as_tensor(a)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}x{c[1]}k{c[2]}")
def pair(request):
    return Pair(*request.param)


# ----------------------------------------------------------------------
# fem/discretisation.py
# ----------------------------------------------------------------------


def test_geom_host_tables_match(pair):
    """The port's own host build equals the JAX package's Geom, field by field."""
    conv = convert.geom_from_jax(pair.jd)
    for name, v in vars(pair.tg).items():
        ref = getattr(pair.jg, name)
        if isinstance(v, torch.Tensor):
            close(v.to(torch.float64), np.asarray(ref, dtype=np.float64))
            assert torch.equal(getattr(conv, name), v), name
        else:
            assert v == ref, name


def test_interpolation(pair):
    tg_ = JTaylorGreen(pair.jd)
    Qf, pf = tg_.initial_condition()
    Qt, pt = TTaylorGreen(pair.td).initial_condition()
    close(pair.td.interpolate_velocity(Qt), pair.jd.interpolate_velocity(Qf))
    close(pair.td.interpolate_pressure(pt), pair.jd.interpolate_pressure(pf))


# ----------------------------------------------------------------------
# ops/structured.py
# ----------------------------------------------------------------------


def test_structured_gathers_and_scatters(pair):
    u, gf = pair.cellf, pair.facetf
    close(TS.gather_plus(pair.tg, pair.t(u)), JS.gather_plus(pair.jg, pair.j(u)))
    close(TS.gather_minus(pair.tg, pair.t(u)), JS.gather_minus(pair.jg, pair.j(u)))
    close(TS.scatter_sides_sum(pair.tg, pair.t(gf), pair.t(2 * gf)),
          JS.scatter_sides_sum(pair.jg, pair.j(gf), pair.j(2 * gf)))
    for a, b in zip(TS.slot_gather(pair.tg, pair.t(gf)), JS.slot_gather(pair.jg, pair.j(gf))):
        close(a, b)
    slots = [u[0], u[1], u[2]]
    close(TS.slot_scatter(pair.tg, [pair.t(s) for s in slots]),
          JS.slot_scatter(pair.jg, [pair.j(s) for s in slots]))


@pytest.mark.parametrize("off", [(1, 0), (0, -1), (-2, 3), (7, 0)])
def test_structured_shifts(pair, off):
    nx, ny = pair.tg.shift[0], pair.tg.shift[1]
    a = np.random.default_rng(5).standard_normal((3, nx, ny))
    close(TS.roll2(pair.tg, pair.t(a), off), JS.roll2(pair.jg, pair.j(a), off))
    for wrap in (False, True):
        close(TS.shift2(pair.t(a), off, wrap), JS.shift2(pair.j(a), off, wrap))
    halves = TS.grid_halves(pair.tg, pair.t(pair.cellf))
    close(TS.grid_join(pair.tg, *halves), pair.cellf)
    rect = pair.tg.shift[4][0][2:6]
    close(TS.rect_flat(pair.t(a), rect), JS.rect_flat(pair.j(a), rect))
    seg = a[0, : rect[2], : rect[3]].reshape(-1)
    close(TS.rect_pad(pair.tg, pair.t(seg), rect), JS.rect_pad(pair.jg, pair.j(seg), rect))
    assert TS.dist_axis(pair.tg) is None


# ----------------------------------------------------------------------
# ops/fields.py
# ----------------------------------------------------------------------


def test_cell_fields(pair):
    tg, jg, Q, p = pair.tg, pair.jg, pair.Q, pair.p
    close(TF.cell_values(tg.phi1, pair.t(Q)), JF.cell_values(jg.phi1, pair.j(Q)))
    close(TF.cell_grads(tg, tg.gphi1, pair.t(Q)), JF.cell_grads(jg, jg.gphi1, pair.j(Q)))
    close(TF.cell_div(tg, pair.t(Q)), JF.cell_div(jg, pair.j(Q)))
    close(TF.mass_apply(tg, tg.m1, pair.t(Q)), JF.mass_apply(jg, jg.m1, pair.j(Q)))
    close(TF.mass_solve(tg, tg.m0inv, pair.t(p)), JF.mass_solve(jg, jg.m0inv, pair.j(p)))
    close(TF.integral(tg, tg.phi0, pair.t(p)), JF.integral(jg, jg.phi0, pair.j(p)))
    close(TF.l2_norm_sq(tg, tg.phi1, pair.t(Q)), JF.l2_norm_sq(jg, jg.phi1, pair.j(Q)))
    close(TF.l2_norm_sq(tg, tg.phi0, pair.t(p)), JF.l2_norm_sq(jg, jg.phi0, pair.j(p)))
    qv = np.random.default_rng(1).standard_normal((2, jg.wq.shape[0], jg.n_cells))
    close(TF.cell_integrate(tg, tg.phi1, pair.t(qv)),
          JF.cell_integrate(jg, jg.phi1, pair.j(qv)))


def test_facet_fields(pair):
    tg, jg, Q, lam = pair.tg, pair.jg, pair.Q, pair.lam
    mask = np.array(JF.interior_mask(jg))
    close(TF.interior_mask(tg), mask)
    for a, b in zip(TF.facet_traces(tg, tg.tphi1, pair.t(Q)),
                    JF.facet_traces(jg, jg.tphi1, pair.j(Q))):
        # the minus trace is garbage on boundary facets in both packages
        close(a * torch.as_tensor(mask), np.asarray(b) * mask)
    close(TF.trace_values(tg, pair.t(lam)), JF.trace_values(jg, pair.j(lam)))
    g = np.random.default_rng(2).standard_normal((jg.wqf.shape[0], jg.n_facets))
    close(TF.facet_integrate_trace(tg, pair.t(g)), JF.facet_integrate_trace(jg, pair.j(g)))
    g2 = np.random.default_rng(3).standard_normal((2,) + g.shape)
    close(TF.scatter_facets(tg, tg.tphi1, pair.t(g2), pair.t(-g2)),
          JF.scatter_facets(jg, jg.tphi1, pair.j(g2), pair.j(-g2)))


# ----------------------------------------------------------------------
# models/problems.py
# ----------------------------------------------------------------------


def test_taylor_green(pair):
    jp = JTaylorGreen(pair.jd)
    tp = TTaylorGreen(pair.td)
    for t in (0.0, 0.3):
        close(pair.td.interpolate_velocity(tp.f_rhs()(t)),
              pair.jd.interpolate_velocity(jp.f_rhs()(jnp.asarray(t))))
        for a, b in zip(tp.solution(t), jp.solution(t)):
            close(a, b)


# ----------------------------------------------------------------------
# ops/projection.py, ops/forms.py, ops/reconstruction.py
# ----------------------------------------------------------------------


def test_bdm_projection(pair):
    jp = j_build_bdm(pair.jd)
    tp = t_build_bdm(pair.td)
    for name in ("leg", "vhat", "recon", "class_id"):
        close(getattr(tp, name), getattr(jp, name))
    close(t_project_bdm(pair.tg, tp, pair.t(pair.Q)), j_project_bdm(pair.jg, jp, pair.j(pair.Q)))
    # the projection of a projected field is itself
    P1 = t_project_bdm(pair.tg, tp, pair.t(pair.Q))
    close(t_project_bdm(pair.tg, tp, P1), P1, rtol=1e-10)


@pytest.mark.parametrize("upwind", [True, False])
def test_f_impl_apply(pair, upwind):
    ts = TForms.star_fields(pair.tg, pair.t(pair.S))
    js = JForms.star_fields(pair.jg, pair.j(pair.S))
    close(ts[1], js[1])
    close(TForms.f_impl_apply(pair.tg, ts, pair.t(pair.Q), 1.0, upwind),
          JForms.f_impl_apply(pair.jg, js, pair.j(pair.Q), 1.0, upwind))


def test_pressure_and_divergence_forms(pair):
    tg, jg = pair.tg, pair.jg
    close(TForms.pressure_gradient_apply(tg, pair.t(pair.p), pair.t(pair.lam)),
          JForms.pressure_gradient_apply(jg, pair.j(pair.p), pair.j(pair.lam)))
    close(TForms.weak_divergence_apply(tg, pair.t(pair.Q)),
          JForms.weak_divergence_apply(jg, pair.j(pair.Q)))
    close(TForms.trace_mass_apply(tg, pair.t(pair.lam)),
          JForms.trace_mass_apply(jg, pair.j(pair.lam)))
    close(TForms.reconstruct_trace_rhs(tg, pair.t(pair.Q), pair.t(pair.p)),
          JForms.reconstruct_trace_rhs(jg, pair.j(pair.Q), pair.j(pair.p)))


def test_pressure_reconstruction_rhs(pair):
    a = t_recon_rhs(pair.tg, pair.t(pair.Q), pair.t(pair.F))
    b = j_recon_rhs(pair.jg, pair.j(pair.Q), pair.j(pair.F))
    close(a[0], b[0])
    close(a[1], b[1])


# ----------------------------------------------------------------------
# linalg/condense.py
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def condensed(pair):
    return pair, TC.build_condensed_system(pair.td), JC.build_condensed_system(pair.jd)


def test_condensed_system_tables(condensed):
    pair, tcs, jcs = condensed
    for name in ("S", "Ainv", "AinvB", "CAinv", "class_id", "Sdiag_inv", "nullvec"):
        close(getattr(tcs, name), getattr(jcs, name))
    assert (tcs.nt, tcs.tau) == (jcs.nt, jcs.tau)


def test_condensed_apply(condensed):
    pair, tcs, jcs = condensed
    tg, jg = pair.tg, pair.jg
    close(TC.trace_matvec(tg, tcs, pair.t(pair.lam)), JC.trace_matvec(jg, jcs, pair.j(pair.lam)))
    args = (pair.Q, pair.p, pair.lam)
    close(TC.condense_rhs(tg, tcs, *map(pair.t, args)), JC.condense_rhs(jg, jcs, *map(pair.j, args)))
    for a, b in zip(TC.back_substitute(tg, tcs, *map(pair.t, args)),
                    JC.back_substitute(jg, jcs, *map(pair.j, args))):
        close(a, b)


# ----------------------------------------------------------------------
# timesteppers/common.py
# ----------------------------------------------------------------------


class _Stepper(IncompressibleEuler):
    pass


def test_timestepper_common(pair):
    ts = _Stepper(pair.td, 0.1)
    js = JSSP2.__new__(JSSP2)  # the JAX base methods without the solver set-up
    js.disc, js.geom, js._dt = pair.jd, pair.jg, 0.1
    js.domain_volume = pair.jd.domain_volume
    js._proj = j_build_bdm(pair.jd)
    assert ts.get_timesteps(0.5, False) == js.get_timesteps(0.5, False) == 5
    assert ts.get_timesteps(0.5, True) == 1
    with pytest.raises(ValueError):
        ts.get_timesteps(0.55, False)
    close(ts.shift_pressure(pair.t(pair.p)), js.shift_pressure(pair.j(pair.p)))
    close(ts.project_bdm(pair.t(pair.Q)), js.project_bdm(pair.j(pair.Q)))
    Qe = 0.5 * pair.Q
    pe = 0.5 * pair.p
    np.testing.assert_allclose(
        ts.velocity_error_norm(pair.t(pair.Q), pair.t(Qe)),
        js.velocity_error_norm(pair.j(pair.Q), pair.j(Qe)), rtol=RTOL)
    np.testing.assert_allclose(
        ts.pressure_error_norm(pair.t(pair.p), pair.t(pe)),
        js.pressure_error_norm(pair.j(pair.p), pair.j(pe)), rtol=RTOL)
    assert (ts.rtol_pressure, ts.rtol_tentative) == (js.rtol_pressure, js.rtol_tentative)
