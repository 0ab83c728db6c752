"""The tracer, the CG spaces and the animation output (the port's fem/cg.py,
ops/tracer.py, ops/vorticity.py, utils/callbacks.py and the tracer of the
schemes) against the JAX package, on the CPU in float64.

- the CG(k+1) numbering and tables on the unit square (k=1), the periodic
  square (k=2, with interior dofs) and the unit disk (k=1): equal dof maps,
  tables <= 1e-12;
- ``cg_mass_solve``, ``cg_project_dg``, ``tracer_advection_apply``,
  ``tracer_step`` (with the CG-projected velocity) and ``vorticity_project``
  on the same seeded fields: equal CG iteration counts, <= 1e-12 relative;
- the tracer of one SSP2(3,3,2) projection step (each stage advects with
  its own CG-projected velocity): <= 1e-10;
- the CLI with ``--tracer_advection`` under projection SSP2 and HDG
  implicit: the same counts, errors and checkpointed state, tracer
  included (tests/test_torch_animation.py compares the ``--animation``
  output).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.fem import cg as JCG
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops import tracer as JTr
from incompressibleeulerhdg_tpu.ops import vorticity as JV
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)
from incompressibleeulerhdg_tpu.utils.callbacks import AnimationCallback as JAnim

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.cli.driver import tracer_initial_condition
from incompressibleeulerhdg_tpu_torch.fem import cg as TCG
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops import tracer as TTr
from incompressibleeulerhdg_tpu_torch.ops import vorticity as TV
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)
from incompressibleeulerhdg_tpu_torch.utils.callbacks import AnimationCallback as TAnim

from test_torch_dg import check_cli_parity, close

torch.set_num_threads(1)


class CGCase:
    def __init__(self, mesh, arg, k):
        self.jd = JDisc(getattr(JM, mesh)(arg), k)
        self.td = TDisc(getattr(TM, mesh)(arg), k, device="cpu")
        self.jg, self.tg = self.jd.geom, self.td.geom
        self.jcg, self.tcg = JCG.build_cg_space(self.jd, k + 1), TCG.build_cg_space(self.td, k + 1)
        g = self.jg
        rng = np.random.default_rng(5 * arg + k)
        self.u = rng.standard_normal((2, g.d1, g.n_cells))
        self.q = rng.standard_normal((g.d0, g.n_cells))
        self.b = rng.standard_normal((2, self.jcg.n_dofs))


@pytest.fixture(scope="module", params=[("unit_square_mesh", 4, 1), ("periodic_square_mesh", 6, 2),
                                        ("unit_disk_mesh", 2, 1)],
                ids=["square4k1", "periodic6k2", "disk2k1"])
def cg_case(request):
    return CGCase(*request.param)


def test_cg_space_matches_jax(cg_case):
    j, t = cg_case.jcg, cg_case.tcg
    assert (t.degree, t.n_dofs) == (j.degree, j.n_dofs)
    np.testing.assert_array_equal(t.dofmap.numpy(), np.asarray(j.dofmap))
    for name in ("phi_at_q1", "mass_diag", "node_coords"):
        close(getattr(t, name), getattr(j, name))
    conv = convert.cg_space_from_jax(j)
    assert torch.equal(conv.dofmap, t.dofmap) and conv.n_dofs == t.n_dofs
    # the P1 space numbers its dofs by the mesh vertices, as linalg/gtmg.py
    # does with mesh.cells (its local order is the lattice's: v0, v2, v1)
    p1 = TCG.build_cg_space(cg_case.td, 1)
    np.testing.assert_array_equal(p1.dofmap.numpy(), cg_case.td.mesh.cells[:, [0, 2, 1]].T)


@pytest.mark.parametrize("name", ["cg_mass_solve", "cg_project_dg", "tracer_advection_apply",
                                  "tracer_step", "vorticity_project"])
def test_cg_and_tracer_ops_match_jax(cg_case, name):
    c = cg_case
    tu, ju = torch.as_tensor(c.u), jnp.asarray(c.u)
    tq, jq = torch.as_tensor(c.q), jnp.asarray(c.q)
    its = None
    if name == "cg_mass_solve":
        (got, its), (ref, jits) = (TCG.cg_mass_solve(c.tg, c.tcg, torch.as_tensor(c.b)),
                                   JCG.cg_mass_solve(c.jg, c.jcg, jnp.asarray(c.b)))
    elif name == "cg_project_dg":
        (got, its), (ref, jits) = (TCG.cg_project_dg(c.tg, c.tcg, tu),
                                   JCG.cg_project_dg(c.jg, c.jcg, ju))
        close(TCG.cg_eval_at_q(c.tg, c.tcg, got), JCG.cg_eval_at_q(c.jg, c.jcg, ref), 1e-11)
    elif name == "tracer_advection_apply":
        got, ref = (TTr.tracer_advection_apply(c.tg, tq, tu),
                    JTr.tracer_advection_apply(c.jg, jq, ju))
    elif name == "tracer_step":
        got = TTr.tracer_step(c.tg, tq, tu, 0.01, cg_space=c.tcg)
        ref = JTr.tracer_step(c.jg, jq, ju, 0.01, cg_space=c.jcg)
        close(TTr.tracer_step(c.tg, tq, tu, 0.01), JTr.tracer_step(c.jg, jq, ju, 0.01))
    else:
        janim, tanim = JAnim(c.jd, "unused.pvd"), TAnim(c.td, "unused.pvd")
        jspace, jproject = janim._vorticity_solver()
        tspace, _, _ = tanim._vorticity_solver()
        degree = c.jd.degree + 1
        from incompressibleeulerhdg_tpu_torch.fem.lagrange import triangle_basis
        from incompressibleeulerhdg_tpu_torch.fem.spaces import facet_ref_points

        basis = triangle_basis(degree)
        gphi = basis.tabulate_grad(c.td.V1.qp)
        tphi = np.stack([basis.tabulate(facet_ref_points(l, f, c.td.Vt.sq))
                         for l in range(3) for f in (0, 1)])
        got, its = TV.vorticity_project(c.td, tspace, tu, torch.as_tensor(gphi),
                                        torch.as_tensor(tphi))
        ref, jits = JV.vorticity_project(c.jd, jspace, ju, jnp.asarray(gphi), jnp.asarray(tphi))
        close(got, jproject(ju))
    if its is not None:
        assert its == int(jits) > 0
    close(got, ref, 1e-11 if its is not None else 1e-12)


def test_imex_tracer_step_matches_jax():
    """The tracer of one projection SSP2 step from the Taylor-Green state,
    4^2, k=1: stage i advects the tableau-combined tracer stages with stage
    i's own CG-projected velocity, the final tracer each stage's flux with
    that stage's velocity."""
    dt = 0.05
    jd, td = JDisc(JM.unit_square_mesh(4), 1), TDisc(TM.unit_square_mesh(4), 1, device="cpu")
    js, ts = JSSP2(jd, dt), TSSP2(td, dt)
    jp, tp = JTG(jd), TTG(td)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    q = jd.interpolate_pressure(lambda x, y: jnp.sin(2 * jnp.pi * x) * jnp.sin(2 * jnp.pi * y))
    s = js.nstages
    jstate = ([Q] + [jnp.zeros_like(Q)] * (s - 1), [p] + [jnp.zeros_like(p)] * (s - 1),
              [lam] + [jnp.zeros_like(lam)] * (s - 1))
    step = js._get_step(jp.f_rhs(), True)
    jQ, _, _, jq, _ = step(jd.geom, js._proj, js._cs, js._gtmg, *jstate, jnp.asarray(0.0), q,
                           js.tracer_cg_space())
    tstate = ts.initial_state(*tp.initial_condition())
    tq = ts.initial_tracer(tracer_initial_condition)
    close(tq, q)
    tQ, _, _, _ = ts.step(*tstate, 0.0, tp.f_rhs())
    close(tQ[0], jQ[0], 1e-10)
    close(ts.tracer_step(tq, [tstate[0][0]] + tQ[1:]), jq, 1e-10)


TRACER_CLI = {
    "ssp2_projection": (["--use_projection_method"], 4),
    "implicit_projection": (["--timestepper", "implicit", "--use_projection_method"], 0),
}


@pytest.mark.parametrize("scheme", list(TRACER_CLI))
def test_cli_tracer_matches_jax(scheme, tmp_path, monkeypatch, capsys):
    flags, n_counts = TRACER_CLI[scheme]
    res, out, port_dir, _ = check_cli_parity(
        ["--nx", "4", "--degree", "1", "--dt", "0.05", "--tfinal", "0.1", "--tracer_advection",
         *flags], tmp_path, monkeypatch, capsys, n_counts)
    assert "advect tracer = True" in out
    from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint

    state, _, _ = load_checkpoint(port_dir / "state.npz")
    assert state["q_tracer"].shape == (3, 32) and np.all(np.isfinite(state["q_tracer"]))
