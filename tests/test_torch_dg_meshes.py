"""DG implicit through the port's CLI on the periodic square and the unit
disk against the JAX driver, on the CPU in float64: the same checkpointed
final state (<= 1e-10) after one step, on the structured factored path with
wrapped rolls (the double shear layer, 6^2, k=1) and on the gather paths
with dense tentative tables (Kelvin-Helmholtz, refinement 2, k=1).  And
tools/jax_reference.py on Taylor-Green (DG with the tracer, the
pressure-solver benchmark) against the port's runs."""

import pytest
import torch

from test_torch_dg import check_cli_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("mesh_flags", [["--problem", "shear", "--nx", "6"],
                                        ["--problem", "kelvinhelmholtz", "--refinement", "2"]],
                         ids=["periodic6", "disk2"])
def test_cli_dg_meshes_match_jax(mesh_flags, tmp_path, monkeypatch, capsys):
    res, out, _, _ = check_cli_parity(
        mesh_flags + ["--degree", "1", "--dt", "0.05", "--tfinal", "0.05", "--discretisation",
                      "dg", "--timestepper", "implicit"], tmp_path, monkeypatch, capsys)
    assert "velocity error" not in out and "velocity_error" not in res
    assert 0 < res["timestepper"].step_counts[0]["fgmres"][0] <= 100


@pytest.mark.parametrize("flags", [["--discretisation", "dg", "--timestepper", "implicit",
                                    "--tracer_advection", "--dt", "0.05", "--steps", "1"],
                                   ["--test_pressure_solver"]],
                         ids=["dg_tracer", "pressure_solver"])
def test_jax_reference_tool_taylor_green(flags, tmp_path, monkeypatch, capsys):
    """tools/jax_reference.py on the Taylor-Green problem: the JAX driver's
    errors and tracer norm (or its pressure-solver count) read back in the
    subprocess equal the port's run of the same flags on the CPU."""
    from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
    from incompressibleeulerhdg_tpu_torch.tools import jax_reference as JR
    from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint
    from incompressibleeulerhdg_tpu_torch.utils.diagnostics import tracer_norm

    args = JR.build_parser().parse_args(["--problem", "taylorgreen", "--nx", "4", "--degree",
                                         "1", "--device", "cpu", *flags])
    ref = JR.run_reference(args)
    assert ref["jax_devices"].startswith("[Cpu")
    monkeypatch.chdir(tmp_path)
    argv = JR.driver_argv(args) + ["--device", "cpu"]
    if args.test_pressure_solver:
        res = tdriver.main(argv)
        assert res["iterations"] == ref["iterations"] > 0 and ref["solve_time"] > 0
        return
    res = tdriver.main(argv + ["--checkpoint_every", "1", "--checkpoint_file", "ck.npz"])
    assert ref["velocity_error"] == pytest.approx(res["velocity_error"], rel=1e-10)
    assert ref["pressure_error"] == pytest.approx(res["pressure_error"], rel=1e-10)
    state, _, _ = load_checkpoint(tmp_path / "ck.npz")
    norm = tracer_norm(res["timestepper"].disc, state["q_tracer"])
    assert ref["tracer_l2"] == pytest.approx(norm, rel=1e-10) and "energy_ratio" not in ref
