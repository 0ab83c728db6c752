"""``--animation`` through the port's CLI against the JAX driver, on the CPU
in float64: ``evolution.pvd`` indexes the initial state and one .vtu a step
with the same times, and every .vtu holds velocity, pressure, vorticity (and
with a tracer the tracer) equal to the JAX driver's, under HDG implicit and
under the conforming scheme with a tracer."""

import re

import numpy as np
import pytest
import torch

from test_torch_dg import check_cli_parity

torch.set_num_threads(1)


def vtu_point_data(path):
    """name -> values of every DataArray of a .vtu written by either package."""
    text = path.read_text()
    return {m.group(1): np.array(m.group(2).split(), float)
            for m in re.finditer(r'Name="(\w+)"[^>]*>\n([^<]*)\n</DataArray>', text)}


ANIMATION_CLI = {
    "implicit": ["--nx", "4", "--degree", "1", "--timestepper", "implicit",
                 "--use_projection_method"],
    "conforming_tracer": ["--nx", "4", "--discretisation", "conforming", "--timestepper",
                          "implicit", "--use_projection_method", "--tracer_advection"],
}


@pytest.mark.parametrize("case", list(ANIMATION_CLI))
def test_cli_animation_matches_jax(case, tmp_path, monkeypatch, capsys):
    """``evolution.pvd`` indexes one .vtu a step and the initial state, with
    the same times; each holds velocity, pressure, vorticity (and the tracer)
    equal to the JAX driver's (the .vtu text has 12 significant digits)."""
    _, _, port_dir, jax_dir = check_cli_parity(
        ANIMATION_CLI[case] + ["--dt", "0.05", "--tfinal", "0.1", "--animation"],
        tmp_path, monkeypatch, capsys)
    assert (port_dir / "evolution.pvd").read_text() == (jax_dir / "evolution.pvd").read_text()
    names = {"velocity", "pressure", "vorticity"} | ({"tracer"} if "tracer" in case else set())
    for i in range(3):
        got, ref = (vtu_point_data(d / f"evolution_{i:05d}.vtu") for d in (port_dir, jax_dir))
        assert got.keys() == ref.keys() and names <= set(got)
        for name, v in ref.items():
            assert np.max(np.abs(got[name] - v)) <= 1e-10 * max(1.0, np.max(np.abs(v))), name


@pytest.mark.parametrize("flags", [["--use_projection_method"],
                                   ["--discretisation", "dg", "--timestepper", "implicit"],
                                   ["--discretisation", "conforming", "--timestepper", "implicit",
                                    "--use_projection_method"]],
                         ids=["imex_ssp2_332", "dg", "conforming"])
def test_resume_with_tracer_equals_straight_run(flags, tmp_path, monkeypatch, capsys):
    """The tracer is part of every scheme's checkpoint: a run resumed after
    one step ends where a straight two-step run ends, tracer included."""
    from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
    from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.chdir(tmp_path)
    base = ["--nx", "4", "--degree", "1", "--dt", "0.05", "--tracer_advection", "--device", "cpu",
            *flags]
    tdriver.main(base + ["--tfinal", "0.1", "--checkpoint_every", "2",
                         "--checkpoint_file", "straight.npz"])
    tdriver.main(base + ["--tfinal", "0.05", "--checkpoint_every", "1",
                         "--checkpoint_file", "resumed.npz"])
    res = tdriver.main(base + ["--tfinal", "0.1", "--checkpoint_every", "1", "--resume",
                               "--checkpoint_file", "resumed.npz"])
    assert "(step 1)" in capsys.readouterr().out
    assert len(res["timestepper"].step_counts) == 1
    (a, ta, _), (b, tb, _) = (load_checkpoint(tmp_path / f) for f in ("resumed.npz",
                                                                       "straight.npz"))
    assert ta == pytest.approx(tb) and a.keys() == b.keys() and "q_tracer" in a
    for name in a:
        for x, y in zip(*((v if isinstance(v, list) else [v]) for v in (a[name], b[name]))):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-13)


@pytest.mark.parametrize("relres, message", [(float("nan"), "non-finite Krylov residual"),
                                             (1.0e-3, "stalled above tolerance")],
                         ids=["nonfinite", "stall"])
def test_imex_solve_warns(relres, message, monkeypatch):
    """The IMEX ``solve`` warns at once of a non-finite Krylov residual and,
    at its end, of a projection run whose largest relative residual stayed
    above 20 times the solver tolerances (the JAX package's two
    RuntimeWarnings)."""
    from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh
    from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen
    from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )

    disc = HDGDiscretisation(unit_square_mesh(2), 1, device="cpu")
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, 0.1)
    counts = dict(tentative=[1], pressure=[1], final_pressure=1, reconstruction=1,
                  max_relres=relres)
    monkeypatch.setattr(stepper, "step", lambda sQ, sp, sl, tn, f: (sQ, sp, sl, counts))
    problem = TaylorGreen(disc)
    with pytest.warns(RuntimeWarning, match=message):
        stepper.solve(*problem.initial_condition(), None, problem.f_rhs(), 0.1)
    assert stepper.max_relres == (float("inf") if relres != relres else relres)
