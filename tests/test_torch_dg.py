"""DG implicit (the port's timesteppers/dg_implicit.py) against the JAX
package, on the CPU in float64.

- ``pressure_gradient_dg_apply`` on the unit square, the periodic square and
  the unit disk: <= 1e-12 relative;
- one DG step on the 4^2 unit square, k=1, from the Taylor-Green state, at
  dt nx = 1/8 and at dt nx = 1, where the coupled FGMRES stops at its cap of
  100 iterations in both packages: equal FGMRES counts, states <= 1e-10;
- the CLI (``--discretisation dg --timestepper implicit``) on the square:
  the same printed errors and the same checkpointed final state.

``check_cli_parity`` is the CLI comparison the other tests of this slice
share (the conforming scheme, the tracer, the animation, DG on the other
meshes).
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.cli import driver as jdriver
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops import forms as JF
from incompressibleeulerhdg_tpu.timesteppers import dg_implicit as JDG

from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops import forms as TF
from incompressibleeulerhdg_tpu_torch.timesteppers.dg_implicit import (
    IncompressibleEulerDGImplicit as TDGImplicit,
)
from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint
from incompressibleeulerhdg_tpu_torch.utils.diagnostics import averaged_counts

torch.set_num_threads(1)


def close(got, ref, rtol=1e-12):
    """Largest entry error at most ``rtol`` times the largest reference entry."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rtol * float(np.max(np.abs(ref))), err


def printed(out, name):
    m = re.search(rf"^{name} = (\S+)$", out, re.M)
    return None if m is None else float(m.group(1))


class KrylovSpy:
    """Records the iteration counts that a JAX Krylov function returns while
    a step runs eagerly, keyed by its ``maxiter``; counts of solves nested
    inside another solve's loop are traced values and are not recorded."""

    def __init__(self, monkeypatch, module, name):
        self.counts = {}
        real = getattr(module, name)

        def spy(*args, **kw):
            out = real(*args, **kw)
            try:
                self.counts.setdefault(kw.get("maxiter"), []).append(int(out[1]))
            except TypeError:  # a tracer: a solve inside another solve's loop
                pass
            return out

        monkeypatch.setattr(module, name, spy)


def check_cli_parity(argv, tmp_path, monkeypatch, capsys, n_counts=0):
    """The port's driver and the JAX driver on the same flags, each in its own
    directory, with a checkpoint after every step: the same ``n_counts``
    averaged iteration counts, the same printed error norms (relative 1e-10,
    where the problem has an exact solution), the same final state (each
    array <= 1e-10 of its largest entry, tracer included) and the same output
    files.  Returns (port result, port output, port dir, JAX dir)."""
    argv = argv + ["--checkpoint_every", "1", "--checkpoint_file", "state.npz"]
    dirs = tmp_path / "port", tmp_path / "jax"
    for d in dirs:
        d.mkdir()
    capsys.readouterr()
    monkeypatch.chdir(dirs[0])
    res = tdriver.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    monkeypatch.chdir(dirs[1])
    jdriver.main(argv)
    jout = capsys.readouterr().out
    counts, jcounts = averaged_counts(out), averaged_counts(jout)
    assert len(counts) == n_counts and counts == jcounts, (counts, jcounts)
    for name in ("velocity error", "pressure error"):
        a, b = printed(out, name), printed(jout, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert a == pytest.approx(b, rel=1e-10, abs=1e-14), (name, a, b)
    (state, t, _), (jstate, jt, _) = (load_checkpoint(d / "state.npz") for d in dirs)
    assert t == pytest.approx(jt, abs=1e-12) and state.keys() == jstate.keys()
    for name, ref in jstate.items():
        for a, b in zip(*((v if isinstance(v, list) else [v]) for v in (state[name], ref))):
            close(a, b, 1e-10)
    assert sorted(p.name for p in dirs[0].iterdir()) == sorted(p.name for p in dirs[1].iterdir())
    assert bool(torch.isfinite(res["Q"]).all())
    return res, out, dirs[0], dirs[1]


@pytest.mark.parametrize("mesh, arg, k", [("unit_square_mesh", 4, 1),
                                          ("periodic_square_mesh", 6, 2),
                                          ("unit_disk_mesh", 2, 1)],
                         ids=["square4k1", "periodic6k2", "disk2k1"])
def test_pressure_gradient_dg_matches_jax(mesh, arg, k):
    jd = JDisc(getattr(JM, mesh)(arg), k)
    td = TDisc(getattr(TM, mesh)(arg), k, device="cpu")
    p = np.random.default_rng(arg + k).standard_normal((jd.geom.d0, jd.geom.n_cells))
    close(TF.pressure_gradient_dg_apply(td.geom, torch.as_tensor(p)),
          JF.pressure_gradient_dg_apply(jd.geom, jnp.asarray(p)))


@pytest.mark.parametrize("dt, iters", [(1.0 / 32, 40), (0.25, 100)], ids=["dtnx1_8", "dtnx1"])
def test_dg_step_matches_jax(dt, iters, monkeypatch):
    """One step from the Taylor-Green state; at dt nx = 1 the coupled FGMRES
    of both packages stops at its cap (ROADMAP Queue 3)."""
    spy = KrylovSpy(monkeypatch, JDG, "fgmres")
    jd, td = JDisc(JM.unit_square_mesh(4), 1), TDisc(TM.unit_square_mesh(4), 1, device="cpu")
    js, ts = JDG.IncompressibleEulerDGImplicit(jd, dt), TDGImplicit(td, dt)
    jp, tp = JTG(jd), TTG(td)
    Q0, p0 = jp.initial_condition()
    jQ = jd.interpolate_velocity(Q0)
    jpp = js.shift_pressure(jd.interpolate_pressure(p0))
    jf = jd.interpolate_velocity(jp.f_rhs()(0.0))
    jQ1, jp1 = js._make_step()(jd.geom, js._proj, js._cs, js._gtmg, jQ, jpp, jf)
    tQ, tpp = ts.initial_fields(*tp.initial_condition())
    close(tQ, jQ)
    close(tpp, jpp)
    tQ1, tp1, counts = ts.advance(tQ, tpp, ts.forcing(tp.f_rhs()(0.0)))
    assert counts == {"fgmres": [iters]} and spy.counts == {100: [iters]}
    close(tQ1, jQ1, 1e-10)
    close(tp1, jp1, 1e-10)


def test_cli_dg_square_matches_jax(tmp_path, monkeypatch, capsys):
    res, out, _, _ = check_cli_parity(
        ["--nx", "4", "--degree", "1", "--dt", "0.05", "--tfinal", "0.1", "--discretisation", "dg",
         "--timestepper", "implicit"], tmp_path, monkeypatch, capsys)
    assert "timestepping method = DG Implicit" in out and "wrote solution.vtu" in out
    assert len(res["timestepper"].step_counts) == 2
    assert all(0 < c["fgmres"][0] <= 100 for c in res["timestepper"].step_counts)
