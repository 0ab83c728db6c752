"""The PyTorch port on the doubly periodic square (the double shear layer)
against the JAX package, on the CPU in float64.

The periodic mesh keeps the structured, factored path of the main path
(slices and rolls, K1-K3's plain versions, the FFT coarse solve), but every
move wraps: its three facet colours hold nx^2 facets each and there is no
boundary facet.  At 6^2 (k = 1) and 8^2 (k = 2), where every facet lies
within one cell of a seam, the generic parity tests of
tests/test_torch_disk.py run on this module's ``case`` fixture; the tests
below add the periodic coarse solve, the wrapped vertex shifts, the fused
sweep of the structured path, the end-to-end run of
test_integration_extra.py and the driver.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.linalg import preconditioners as JP

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models import problems as TPB
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)

from incompressibleeulerhdg_tpu_torch.utils.diagnostics import divergence_norm, kinetic_energy

from test_torch_disk import (  # noqa: F401 -- run here on the periodic ``case``
    SCHEMES,
    Case,
    check_cli_matches_jax,
    close,
    test_condense_matches_jax,
    test_fields_match_jax,
    test_forms_match_jax,
    test_geom_equals_jax,
    test_gtmg_apply,
    test_gtmg_tables,
    test_patch_color_each_colour,
    test_pressure_solve,
    test_ssp2_step_matches_jax,
    test_tentative_operator_applies,
    test_tentative_operator_tables,
    test_tentative_solve,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(6, 1), (8, 2)], ids=["6x6k1", "8x8k2"])
def case(request):
    return Case("periodic_square_mesh", *request.param, "shear")


@pytest.fixture(scope="module")
def step_case():
    return Case("periodic_square_mesh", 6, 1, "shear")


def test_periodic_layout(case):
    """Three colours of nx^2 facets at offsets 0, nx^2 and 2 nx^2, no
    boundary facet, no tail, and a factored operator on the wrapped mesh."""
    g = case.tg
    nx = case.mesh_arg
    assert case.k == (1 if nx == 6 else 2)
    assert g.n_int == g.n_facets == 3 * nx * nx and g.shift[2] and not g.shift[5]
    assert g.fcol_bounds == (0, nx * nx, 2 * nx * nx, 3 * nx * nx)
    assert g.uniform is not None and case.op[1].Sown is not None


def test_periodic_coarse_spectrum_and_vshift(case):
    jpc, tpc = case.pc
    assert tpc.coarse_kind == jpc.coarse_kind == "fft_periodic"
    assert tpc.grid_shape == tuple(jpc.grid_shape) == (case.mesh_arg,) * 2
    close(tpc.coarse_eig_inv, jpc.coarse_eig_inv)
    # the wrapped vertex shifts: three colour groups covering every facet
    assert tpc.vshift == jpc.vshift and tpc.vshift[2] is True
    assert len(tpc.vshift[3]) == 3 and tpc.vshift[3][-1][1] == case.tg.n_facets


def test_fused_sweep_on_wrapped_mesh(case):
    """The tentative preconditioner of the structured path: colour solves,
    off-colour cross applies and the final matvec through K1-K3's plain
    versions, on rolls that wrap."""
    jop, top = case.op
    nu = 2 * case.jg.d1
    v = case.u.reshape(nu, -1)
    tz, tAz = TP._colored_apply_fused_bl(case.tg, top, torch.as_tensor(v))
    jz, jAz = JP._colored_apply_fused_bl(case.jg, jop, jnp.asarray(v), symmetric=True)
    close(tz, jz)
    close(tAz, jAz)
    for k in range(3):
        close(TP._color_cov(case.tg, k), JP._color_cov(case.jg, k))
        close(TP._cross_offcolor(case.tg, top, k, torch.as_tensor(v)),
              JP._cross_offcolor(case.jg, jop, k, jnp.asarray(v)))


def test_shear_layer_periodic_end_to_end():
    """tests/test_integration_extra.py's double shear layer run through the
    port (8^2, k = 1, dt = 0.05 to T = 0.25): finite, energy within [0.5,
    1.05] of the initial one, divergence below 5e-2."""
    disc = TDisc(TM.periodic_square_mesh(8), 1, device="cpu")
    stepper = TSSP2(disc, 0.05)
    problem = TPB.DoubleLayerShearFlow(disc)
    Q0e, p0e = problem.initial_condition()
    E0 = kinetic_energy(disc.geom, disc.interpolate_velocity(Q0e))
    Q, _ = stepper.solve(Q0e, p0e, None, problem.f_rhs(), 0.25)
    assert bool(torch.isfinite(Q).all()) and problem.solution(0.25) is None
    E1 = kinetic_energy(disc.geom, Q)
    assert 0.5 * E0 <= E1 <= 1.05 * E0, (E0, E1)
    assert divergence_norm(disc.geom, Q) < 5e-2
    assert abs(stepper.domain_volume - (2 * np.pi) ** 2) < 1e-12


def test_cli_shear_matches_jax(tmp_path, monkeypatch, capsys):
    out = check_cli_matches_jax(
        ["--problem", "shear", "--nx", "8", "--degree", "1", "--dt", "0.05", "--tfinal", "0.1",
         "--use_projection_method"], tmp_path, monkeypatch, capsys)
    assert "mesh size = 8 x 8" in out and "kappa" not in out


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_cli_shear_schemes_match_jax(scheme, tmp_path, monkeypatch, capsys):
    """The CLI default (monolithic SSP2) and HDG implicit, with projection
    (the fused right-preconditioned tentative GMRES) and monolithic, on the
    wrapped 6^2 mesh: one step each."""
    flags, n_counts = SCHEMES[scheme]
    check_cli_matches_jax(["--problem", "shear", "--nx", "6", "--degree", "1", "--dt", "0.05",
                           "--tfinal", "0.05", *flags], tmp_path, monkeypatch, capsys, n_counts)


def test_jax_reference_tool_matches_port_run():
    """tools/jax_reference.py runs the JAX driver in a subprocess and reads
    its counts and final state back: on the CPU in float64 they equal the
    port's own run (counts exactly, energy and divergence to 1e-10)."""
    from incompressibleeulerhdg_tpu_torch.tools import jax_reference as JR

    args = JR.build_parser().parse_args(["--problem", "shear", "--nx", "6", "--degree", "1",
                                         "--dt", "0.05", "--steps", "2", "--device", "cpu",
                                         "--use_projection_method"])
    ref = JR.run_reference(args)
    assert ref["jax_devices"].startswith("[Cpu") and ref["t_final"] == pytest.approx(0.1)
    assert ref["timers"]["timestep"][0] == 2
    disc = TDisc(TM.periodic_square_mesh(6), 1, device="cpu")
    stepper = TSSP2(disc, 0.05)
    problem = TPB.DoubleLayerShearFlow(disc)
    Q, _ = stepper.solve(*problem.initial_condition(), None, problem.f_rhs(), 0.1)
    counts = {"tentative velocity": stepper.niter_tentative.value,
              "pressure": stepper.niter_pressure.value,
              "final pressure": stepper.niter_final_pressure.value,
              "pressure reconstruction": stepper.niter_pressure_reconstruction.value}
    assert ref["counts"] == pytest.approx(counts, abs=0.005)
    ratio, div = JR.reference_diagnostics(args, Q)
    assert ref["energy_ratio"] == pytest.approx(ratio, rel=1e-10)
    assert ref["divergence"] == pytest.approx(div, rel=1e-10)
