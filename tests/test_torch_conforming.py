"""The conforming RT1 x DG0 scheme (the port's ops/rt.py,
timesteppers/conforming_implicit.py) and ``krylov.cg`` against the JAX
package, on the CPU in float64.

- ``cg`` with and without a projector and a preconditioner, from zero and
  from a start vector: equal iteration counts, solutions <= 1e-10, and the
  same stopping rule at ``maxiter`` and at ``atol``;
- the RT tables of the degree-0 discretisation and each of the 11 ``rt_*``
  functions on the unit square and the unit disk: <= 1e-12 relative (the
  minus-side facet values on interior facets only: on the boundary they are
  not data);
- one conforming step on the 8^2 square, projection and monolithic: equal
  Krylov counts (the first mass solve and the Schur CG, or the FGMRES),
  states <= 1e-10;
- the CLI: projection on the square and the disk, monolithic (the default)
  on the square: the same errors and checkpointed final state.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.linalg import krylov as JK
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops import rt as JRT
from incompressibleeulerhdg_tpu.timesteppers import conforming_implicit as JCI

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.linalg import krylov as TK
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops import fields as TFd
from incompressibleeulerhdg_tpu_torch.ops import rt as TRT
from incompressibleeulerhdg_tpu_torch.timesteppers.conforming_implicit import (
    IncompressibleEulerConformingImplicit as TConforming,
)

from test_torch_dg import KrylovSpy, check_cli_parity, close

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# conjugate gradients
# ----------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "jacobi_projected", "x0", "maxiter", "atol"])
def test_cg_matches_jax(variant):
    rng = np.random.default_rng(11)
    n = 40
    A = rng.standard_normal((n, n))
    A = A @ A.T / n + np.eye(n)  # well conditioned: the count is not a rounding edge case
    b = rng.standard_normal(n)
    d = 1.0 / np.diag(A)
    kw = {}
    if variant == "jacobi_projected":  # the mean projected out, Jacobi preconditioned
        kw = dict(project=lambda v: v - v.mean(), M=None)
    elif variant == "x0":
        kw = dict(x0=rng.standard_normal(n))
    elif variant == "maxiter":
        kw = dict(maxiter=5)
    elif variant == "atol":
        kw = dict(rtol=0.0, atol=1e-3)
    tkw = {k: (torch.as_tensor(v) if k == "x0" else v) for k, v in kw.items()}
    jkw = {k: (jnp.asarray(v) if k == "x0" else v) for k, v in kw.items()}
    if "M" in kw:
        tkw["M"] = lambda v: v * torch.as_tensor(d)
        jkw["M"] = lambda v: v * jnp.asarray(d)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    tx, tit, trel = TK.cg(lambda v: tA @ v, torch.as_tensor(b), **tkw)
    jx, jit, jrel = JK.cg(lambda v: jA @ v, jnp.asarray(b), **jkw)
    assert tit == int(jit) > 0
    assert trel == pytest.approx(float(jrel), rel=1e-8)
    close(tx, jx, 1e-10)
    if variant == "maxiter":
        assert tit == 5
    if variant == "atol":
        assert trel * np.linalg.norm(b) <= 1e-3 < np.linalg.norm(b)


# ----------------------------------------------------------------------
# the RT element layer
# ----------------------------------------------------------------------


class RTCase:
    def __init__(self, mesh, arg):
        self.jd = JDisc(getattr(JM, mesh)(arg), 0)
        self.td = TDisc(getattr(TM, mesh)(arg), 0, device="cpu")
        self.jg, self.tg = self.jd.geom, self.td.geom
        self.jrt, self.trt = JRT.build_rt_tables(self.jd), TRT.build_rt_tables(self.td)
        g = self.jg
        rng = np.random.default_rng(arg)
        self.g = rng.standard_normal(g.n_facets)
        self.q = rng.standard_normal(g.n_cells)
        self.x = rng.standard_normal((2, 5, g.n_cells))
        self.G = rng.standard_normal((2, g.wq.shape[0], g.n_cells))
        nqf = g.wqf.shape[0]
        mask = TFd.interior_mask(self.tg, 3).numpy()
        self.G0 = rng.standard_normal((2, nqf, g.n_facets))
        self.G1 = rng.standard_normal((2, nqf, g.n_facets)) * mask


@pytest.fixture(scope="module", params=[("unit_square_mesh", 4), ("unit_disk_mesh", 2)],
                ids=["square4", "disk2"])
def rt_case(request):
    return RTCase(*request.param)


def test_rt_tables_match_jax(rt_case):
    c = rt_case
    assert c.tg.d1 == 3 and c.tg.d0 == 1
    for name in ("P_opp", "area", "mass_elem", "mass_diag_inv", "xqf", "bnd_mask",
                 "int_dof_mask"):
        close(getattr(c.trt, name), getattr(c.jrt, name))
    conv = convert.rt_tables_from_jax(c.jrt, c.tg)
    assert torch.equal(conv.fslot, c.trt.fslot)
    close(TRT.rt_mass_apply(c.tg, conv, torch.as_tensor(c.g)),
          JRT.rt_mass_apply(c.jg, c.jrt, jnp.asarray(c.g)))


RT_FUNCTIONS = {
    "rt_cell_coeffs": ("g",), "rt_eval": ("g", "x"), "rt_eval_cellq": ("g",),
    "rt_facet_values": ("g",), "rt_divergence": ("g",), "rt_div_adjoint": ("q",),
    "rt_mass_apply": ("g",), "rt_volume_adjoint": ("G",), "rt_facet_adjoint": ("G0", "G1"),
    "rt_to_dg1": ("g",),
}


@pytest.mark.parametrize("name", [*RT_FUNCTIONS, "rt_interpolate"])
def test_rt_functions_match_jax(rt_case, name):
    c = rt_case
    if name == "rt_interpolate":
        got = TRT.rt_interpolate(c.td, c.trt, TTG._Q_stationary)
        ref = JRT.rt_interpolate(c.jd, c.jrt, JTG._Q_stationary)
        close(got, ref)
        return
    args = [getattr(c, a) for a in RT_FUNCTIONS[name]]
    got = getattr(TRT, name)(c.tg, c.trt, *map(torch.as_tensor, args))
    ref = getattr(JRT, name)(c.jg, c.jrt, *map(jnp.asarray, args))
    if name == "rt_facet_values":
        mask = TFd.interior_mask(c.tg, 3).numpy()
        close(got[0], ref[0])
        close(got[1] * mask, np.asarray(ref[1]) * mask)
    elif isinstance(ref, tuple):
        for a, b in zip(got, ref):
            close(a, b)
    else:
        close(got, ref)


# ----------------------------------------------------------------------
# one step, the CLI
# ----------------------------------------------------------------------


@pytest.mark.parametrize("projection", [True, False], ids=["projection", "monolithic"])
def test_conforming_step_matches_jax(projection, monkeypatch):
    cg_spy = KrylovSpy(monkeypatch, JCI, "cg_solve")
    fgmres_spy = KrylovSpy(monkeypatch, JCI, "fgmres")
    dt = 0.05
    # 8^2: on 4^2 the Schur CG ends by exhausting its 15-dimensional Krylov
    # space, where the iteration that crosses 1e-12 is a rounding accident
    jd, td = JDisc(JM.unit_square_mesh(8), 0), TDisc(TM.unit_square_mesh(8), 0, device="cpu")
    js = JCI.IncompressibleEulerConformingImplicit(jd, dt, use_projection_method=projection)
    ts = TConforming(td, dt, use_projection_method=projection)
    jp, tp = JTG(jd), TTG(td)
    Q0, p0 = jp.initial_condition()
    jQ = JRT.rt_interpolate(jd, js._rt, Q0) * js._rt.int_dof_mask
    xc = jnp.mean(jd.geom.xnodes1, axis=1)
    jpp = p0(xc[0], xc[1])
    jpp = jpp - jnp.sum(jpp * js._rt.area) / js.domain_volume
    jf = JRT.rt_interpolate(jd, js._rt, jp.f_rhs()(0.0))
    jQ1, jp1 = js._make_step()(jd.geom, js._rt, jQ, jpp, jf)
    tQ, tpp = ts.initial_fields(*tp.initial_condition())
    close(tQ, jQ)
    close(tpp, jpp)
    tQ1, tp1, counts = ts.advance(tQ, tpp, ts.forcing(tp.f_rhs()(0.0)))
    if projection:
        assert counts["mass"][0] == cg_spy.counts[200][0] > 0
        assert counts["schur"] == cg_spy.counts[300] and counts["schur"][0] > 0
        assert not fgmres_spy.counts
    else:
        assert counts["fgmres"] == fgmres_spy.counts[100] and counts["fgmres"][0] > 0
    close(tQ1, jQ1, 1e-10)
    close(tp1, jp1, 1e-10)
    close(ts.velocity_dg(tQ1), js.velocity_dg(jQ1), 1e-10)


CLI_CASES = {
    "projection_square": ["--nx", "4", "--dt", "0.05", "--tfinal", "0.1",
                          "--use_projection_method"],
    "projection_disk": ["--problem", "kelvinhelmholtz", "--refinement", "2", "--dt", "0.05",
                        "--tfinal", "0.1", "--use_projection_method"],
    "monolithic_square": ["--nx", "4", "--dt", "0.05", "--tfinal", "0.1"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_conforming_matches_jax(case, tmp_path, monkeypatch, capsys):
    """The CLI builds the scheme at degree 0 whatever ``--degree`` says."""
    res, out, _, _ = check_cli_parity(
        CLI_CASES[case] + ["--degree", "2", "--discretisation", "conforming", "--timestepper",
                           "implicit"], tmp_path, monkeypatch, capsys)
    assert "Warning: ignoring degree for conforming method" in out
    assert res["timestepper"].disc.degree == 0 and res["Q"].shape[:2] == (2, 3)
    assert res["p"].shape[0] == 1
    assert ("velocity_error" in res) == case.endswith("square")
