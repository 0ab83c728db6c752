"""The port's CLI driver against the JAX package's, on the CPU in float64.

- the verify skill's canonical run (``--nx 8 --degree 1 --dt 0.1 --tfinal
  0.5 --timestepper imex_ssp2_332``), with ``--use_projection_method`` and
  without it (monolithic, the CLI default): the same velocity and pressure
  errors to three significant digits (BASELINE.md: 1.12e-3 and 6.03e-3 for
  the projection run);
- ``--test_pressure_solver``: the same iteration count;
- checkpoint every step, then resume: the final state equals a straight run;
- the ``--n_devices`` cases outside the slab path run on the cell/facet
  partition and give the single rank's counts and state, and the JAX
  driver's checks of invalid combinations keep their exceptions;
- ``--device cuda`` without a card exits non-zero;
- the constant forcing of the Taylor-Green problem matches the JAX package.
"""

import re

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu.cli import driver as jdriver
from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG

from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG

torch.set_num_threads(1)

CANONICAL = ["--nx", "8", "--degree", "1", "--dt", "0.1", "--tfinal", "0.5",
             "--timestepper", "imex_ssp2_332"]


def run_jax(argv, capsys):
    """The JAX driver in-process; returns its standard output."""
    capsys.readouterr()
    try:
        jdriver.main(argv)
    except SystemExit as e:  # --test_pressure_solver ends with sys.exit()
        assert not e.code
    return capsys.readouterr().out


def run_port(argv, capsys):
    capsys.readouterr()
    res = tdriver.main(argv + ["--device", "cpu"])
    return res, capsys.readouterr().out


def printed(out, name):
    return float(re.search(rf"^{name} = (\S+)$", out, re.M).group(1))


def sig3(x):
    return float(f"{x:.3g}")


@pytest.mark.parametrize("extra", [["--use_projection_method"], []],
                         ids=["projection", "monolithic"])
def test_canonical_run_matches_jax(tmp_path, monkeypatch, capsys, extra):
    monkeypatch.chdir(tmp_path)
    res, out = run_port(CANONICAL + extra, capsys)
    assert (tmp_path / "solution.vtu").exists()
    (tmp_path / "solution.vtu").unlink()
    jout = run_jax(CANONICAL + extra, capsys)
    for name in ("velocity error", "pressure error"):
        assert sig3(printed(out, name)) == sig3(printed(jout, name)), (out, jout)
    assert printed(out, "velocity error") == res["velocity_error"]
    assert "average number of solver iterations" in out and "wrote solution.vtu" in out
    if extra:
        assert sig3(res["velocity_error"]) == 1.12e-3
        assert sig3(res["pressure_error"]) == 6.03e-3


def test_pressure_solver_benchmark_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--nx", "8", "--degree", "1", "--test_pressure_solver"]
    res, out = run_port(argv, capsys)
    jits = int(re.search(r"number of iterations = (\d+)", run_jax(argv, capsys)).group(1))
    assert res["iterations"] == jits > 0
    assert f"number of iterations = {jits}" in out and "solve time" in out
    assert not (tmp_path / "solution.vtu").exists()


@pytest.mark.parametrize("scheme", ["imex_ssp2_332", "implicit"])
def test_checkpoint_resume_equals_straight_run(tmp_path, monkeypatch, capsys, scheme):
    monkeypatch.chdir(tmp_path)
    base = ["--nx", "4", "--degree", "1", "--dt", "0.1", "--timestepper", scheme,
            "--use_projection_method", "--checkpoint_file", str(tmp_path / "ck.npz")]
    straight, _ = run_port(base + ["--tfinal", "0.4"], capsys)
    run_port(base + ["--tfinal", "0.2", "--checkpoint_every", "1"], capsys)
    resumed, out = run_port(base + ["--tfinal", "0.4", "--resume"], capsys)
    assert "(step 2)" in out
    assert len(resumed["timestepper"].step_counts) == 2
    for f in ("Q", "p"):
        assert torch.allclose(resumed[f], straight[f], rtol=0.0, atol=1e-13)
    # a checkpoint of another scheme is refused
    other = "implicit" if scheme != "implicit" else "imex_ssp2_332"
    with pytest.raises(ValueError, match="mismatch"):
        run_port([a if a != scheme else other for a in base] + ["--tfinal", "0.4", "--resume"],
                 capsys)


def test_warmup_takes_one_step(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res, out = run_port(["--nx", "4", "--dt", "0.1", "--tfinal", "0.5", "--warmup",
                         "--use_projection_method"], capsys)
    assert "WARNING: performing a single timestep only!" in out
    assert len(res["timestepper"].step_counts) == 1
    assert "velocity_error" not in res and not (tmp_path / "solution.vtu").exists()


@pytest.mark.parametrize("flags", [
    ["--n_devices", "2", "--problem", "kelvinhelmholtz"],
    ["--n_devices", "2", "--discretisation", "conforming", "--timestepper", "implicit"],
    ["--n_devices", "3", "--problem", "shear", "--nx", "8"],
    ["--n_devices", "2", "--timestepper", "implicit", "--tracer_advection"],
    ["--n_devices", "2", "--discretisation", "dg", "--timestepper", "implicit",
     "--tracer_advection"],
    ["--n_devices", "8", "--nx", "7"],
], ids=lambda f: "_".join(a.strip("-") for a in f))
def test_out_of_slice_flags_raise(tmp_path, monkeypatch, flags):
    """The ``--n_devices`` cases the JAX package runs on its GSPMD sharding
    (the disk, the conforming scheme, a periodic split that does not divide
    nx, the tracer under the implicit schemes) and a split with an empty
    slab, which raised before the partition existed: each runs on the
    cell/facet partition through ``driver.main`` and gives the single
    rank's iteration counts and final state (<= 1e-10).  One step
    (``--warmup``), with projection where the flags leave the monolithic
    default (its FGMRES makes tens of thousands of gloo round trips a
    step; tests/test_torch_partition_*.py run it at a cap), the DG cases
    at nx = 4, dt = 0.01."""
    monkeypatch.chdir(tmp_path)
    extra = ["--warmup", "--device", "cpu"]
    if "dg" in flags:
        extra += ["--nx", "4", "--dt", "0.01"]
    else:
        extra += ["--use_projection_method"]
    single = tdriver.main([a if a != flags[1] else "1" for a in flags] + extra)
    dist = tdriver.main(flags + extra)
    def counts(res):  # the iteration counts, without the residual estimate
        return [{k: v for k, v in c.items() if k != "max_relres"} for c in res["step_counts"]]

    assert "timestepper" not in dist and counts(dist) == counts(single)
    for name in ("Q", "p"):
        ref = single[name]
        err = float(torch.max(torch.abs(dist[name] - ref)))
        assert err <= 1e-10 * float(torch.max(torch.abs(ref))), (name, err)


@pytest.mark.parametrize("flags, exc", [
    (["--discretisation", "dg", "--use_projection_method", "--timestepper", "implicit"],
     AssertionError),
    (["--discretisation", "dg"], RuntimeError),
    (["--discretisation", "conforming"], RuntimeError),
], ids=["dg_projection", "dg_imex", "conforming_imex"])
def test_invalid_combinations_keep_jax_behaviour(flags, exc):
    with pytest.raises(exc):
        tdriver.main(flags + ["--device", "cpu"])


def test_cuda_device_without_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda would run")
    with pytest.raises(SystemExit) as e:
        tdriver.main(["--nx", "2"])
    assert e.value.code not in (0, None) and "cuda" in str(e.value.code).lower()


@pytest.mark.parametrize("forcing", ["exponential", "constant"])
def test_taylor_green_forcing_matches_jax(forcing):
    jd, td = JDisc(unit_square_mesh(4), 1), TDisc(unit_square_mesh(4), 1, device="cpu")
    jp, tp = JTG(jd, forcing, 0.7), TTG(td, forcing, 0.7)
    for t in (0.0, 0.3):
        np.testing.assert_allclose(td.interpolate_velocity(tp.f_rhs()(t)).numpy(),
                                   np.asarray(jd.interpolate_velocity(jp.f_rhs()(t))),
                                   rtol=1e-13, atol=1e-15)
        for a, b in zip(tp.solution(t), jp.solution(t)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-15)
