"""Float32 at a high degree, the port against the JAX package on the CPU.

One projection SSP2 step of the Taylor-Green vortex at k = 8 (d1 = 55,
Gauss-Jordan n = 110), dt = 1/256, float32: chip_smoke.py run (o8)'s flags
on the 4^2 square.  At (o8)'s 32^2 the float32 velocity error is 7.2e-5 in
the JAX package and 7.1e-5 in the port, on the CPU and on the card alike,
where float64 ends at 2.6e-9 (PERF.md section 6, PR 16): the growth is the
float32 rounding both packages share, not the port.  This test keeps that
finding on the CPU: the port's plain path gives the JAX package's float32
Krylov counts within one and its velocity and pressure errors within a
factor of 2.

The 4^2 square, not 2^2: the step's float32 error comes from the BDM
projection's reconstruction product, whose matrices reach 2.9e8 at k = 8,
and so from the order in which a backend sums it.  On 2^2 the JAX
package's XLA CPU dot sums that product within 0.033 of the exact product
of its float32 operands, torch's CPU matmul within 0.098, both inside
float32's bound of 0.19 for the sums (``bdm_float32_errors``, printed by
running this file); the step's velocity errors there are 3.4e-5 and
8.0e-5 (tools/fault_readings.py), on 4^2 5.9e-5 and 9.4e-5.
"""

import json

import numpy as np
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops.forms import star_fields as j_star_fields
from incompressibleeulerhdg_tpu.ops.projection import project_bdm as j_project_bdm
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.mesh import unit_square_mesh as t_mesh
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops import projection as TPR
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields as t_star_fields
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)

torch.set_num_threads(1)

DT = 1.0 / 256
COUNT_KEYS = ("tentative", "pressure", "final_pressure", "reconstruction")


def jax_step(nx, degree, dtype):
    """The JAX package's first step: (counts, velocity error, pressure error)."""
    jd = JDisc(unit_square_mesh(nx), degree, dtype=dtype)
    js, jp = JSSP2(jd, DT), JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    z = lambda a: [a] + [jnp.zeros_like(a)] * (js.nstages - 1)
    step = js._get_step(jp.f_rhs(), False)
    sQ, sp, _, _, c = step(jd.geom, js._proj, js._cs, js._gtmg, z(Q), z(p), z(lam),
                           jnp.asarray(0.0, dtype), jnp.zeros_like(p), None)
    Qe, pe = jp.solution(DT)
    counts = {k: [int(v) for v in np.ravel(np.asarray(c[k]))] for k in COUNT_KEYS}
    return (counts, float(js.velocity_error_norm(sQ[0], Qe)),
            float(js.pressure_error_norm(sp[0], pe)))


def port_step(nx, degree, dtype):
    """The port's first step on the CPU (the kernels' plain versions)."""
    td = TDisc(t_mesh(nx), degree, dtype=dtype, device="cpu")
    ts, tp = TSSP2(td, DT), TTG(td)
    sQ, sp, _, c = ts.step(*ts.initial_state(*tp.initial_condition()), 0.0, tp.f_rhs())
    Qe, pe = tp.solution(DT)
    counts = {k: [int(v) for v in np.ravel(c[k])] for k in COUNT_KEYS}
    return counts, ts.velocity_error_norm(sQ[0], Qe), ts.pressure_error_norm(sp[0], pe)


def test_float32_step_matches_jax():
    """k = 8 on the 4^2 square in float32: every Krylov count within one of
    the JAX package's, the velocity and pressure errors within 2x of its."""
    jc, jv, jpe = jax_step(4, 8, jnp.float32)
    tc, tv, tpe = port_step(4, 8, torch.float32)
    for k in COUNT_KEYS:
        assert len(tc[k]) == len(jc[k]), k
        assert all(abs(a - b) <= 1 for a, b in zip(tc[k], jc[k])), (k, tc[k], jc[k])
    assert min(tc["tentative"] + tc["pressure"]) > 0
    assert 0.5 * jv <= tv <= 2 * jv, (tv, jv)
    assert 0.5 * jpe <= tpe <= 2 * jpe, (tpe, jpe)


def bdm_float32_errors(nx, degree):
    """The BDM projection of the float32-rounded Taylor-Green velocity in
    float32, by each package, against the port's float64 projection of the
    same input (``projection_*``, max abs), and its reconstruction product
    alone, recon[class] @ dofs on the port's float32 operands, against the
    exact product of those operands (``product_*``), beside float32's
    bound for the product's sums, u |recon| |dofs| (``product_bound``), and
    the largest entry of the reconstruction matrices (``recon_max``)."""
    t64 = TDisc(t_mesh(nx), degree, dtype=torch.float64, device="cpu")
    t32 = TDisc(t_mesh(nx), degree, dtype=torch.float32, device="cpu")
    j32 = JDisc(unit_square_mesh(nx), degree, dtype=jnp.float32)
    s64, s32, js32 = TSSP2(t64, DT), TSSP2(t32, DT), JSSP2(j32, DT)
    Q = t64.interpolate_velocity(TTG(t64).initial_condition()[0]).float()
    operands = {}
    apply = TPR.apply_class_blocks

    def spy(tables, class_id, x):
        operands.update(tables=tables, class_id=class_id, x=x)
        return apply(tables, class_id, x)

    ref = TPR.project_bdm(s64.geom, s64._proj, Q.double()).numpy()
    TPR.apply_class_blocks = spy
    try:
        port = TPR.project_bdm(s32.geom, s32._proj, Q).double().numpy()
    finally:
        TPR.apply_class_blocks = apply
    jax_out = np.asarray(j_project_bdm(j32.geom, js32._proj, jnp.asarray(Q.numpy())), np.float64)
    T, cid, x = operands["tables"], operands["class_id"], operands["x"]
    exact = apply(T.double(), cid, x.double())
    cls = cid.numpy()
    by_jax = np.zeros(tuple(x.shape), np.float32)
    for k in range(T.shape[0]):
        by_jax[:, cls == k] = np.asarray(jnp.asarray(T[k].numpy()) @ jnp.asarray(x.numpy()))[:, cls == k]
    err = lambda y: float((torch.as_tensor(y).double() - exact).abs().max())
    bound = 2.0 ** -24 * (T.double().abs()[cid].permute(1, 2, 0) * x.double().abs()[None]).sum(1)
    return dict(projection_port=float(np.abs(port - ref).max()),
                projection_jax=float(np.abs(jax_out - ref).max()),
                projection_max=float(np.abs(ref).max()), product_port=err(apply(T, cid, x)),
                product_jax=err(by_jax), product_bound=float(bound.max()),
                recon_max=float(T.abs().max()))


def test_bdm_projection_float32_product_within_bound():
    """k = 8 on the 2^2 square: the BDM reconstruction product in float32
    is within float32's bound for its sums, u |recon| |dofs|, in both
    packages; how far inside it is each backend's order of summation."""
    r = bdm_float32_errors(2, 8)
    assert r["recon_max"] > 1e8  # the conditioning that makes float32 lose digits here
    assert r["product_port"] <= r["product_bound"], r
    assert r["product_jax"] <= r["product_bound"], r


def fused_az_consistency(nx, degree=2, seed=0):
    """``IEHDG_TENT_FUSED=2``'s fault at the apply: the fused sweep's
    returned ``A z`` in float32, by each package, exact (one matvec) and
    free (``v - r``), against the port's float64 product of the same
    returned ``z``, relative in the 2-norm, on the first stage's operator of
    the Taylor-Green step at nx^2 and a seeded vector (the port's side is
    tools/fault_readings.py ``--az``, which also runs on the card)."""
    t64 = TDisc(t_mesh(nx), degree, dtype=torch.float64, device="cpu")
    t32 = TDisc(t_mesh(nx), degree, dtype=torch.float32, device="cpu")
    j32 = JDisc(unit_square_mesh(nx), degree, dtype=jnp.float32)
    s64, s32, js32 = TSSP2(t64, DT), TSSP2(t32, DT), JSSP2(j32, DT)
    c = float(s64.tableau.a_impl[1][1]) * DT
    Q = t64.interpolate_velocity(TTG(t64).initial_condition()[0]).float()
    v = np.random.default_rng(seed).standard_normal((2 * t64.geom.d1, t64.geom.n_cells))
    op64 = TP.build_tentative_operator(
        s64.geom, t_star_fields(s64.geom, TPR.project_bdm(s64.geom, s64._proj, Q.double())), c)
    op32 = TP.build_tentative_operator(
        s32.geom, t_star_fields(s32.geom, TPR.project_bdm(s32.geom, s32._proj, Q)), c)
    jop = JP.build_tentative_operator(j32.geom, j_star_fields(
        j32.geom, j_project_bdm(j32.geom, js32._proj, jnp.asarray(Q.numpy()))), c)
    out = {}
    for mode, exact in (("exact_Az", True), ("free_Az", False)):
        for name, (z, Az) in (
                ("port", TP._colored_apply_fused_bl(s32.geom, op32, torch.as_tensor(v).float(),
                                                    symmetric=True, exact_Az=exact)),
                ("jax", JP._colored_apply_fused_bl(j32.geom, jop, jnp.asarray(v, jnp.float32),
                                                   symmetric=True, exact_Az=exact))):
            z = torch.as_tensor(np.asarray(z, np.float64))
            ref = TP._matvec_bl(s64.geom, op64, z)
            Az = torch.as_tensor(np.asarray(Az, np.float64))
            out[f"{name}_{mode}"] = float((Az - ref).norm() / ref.norm())
    return out


def test_free_Az_inconsistency_matches_jax():
    """On 8^2, k = 2, float32: the fused sweep's A z strays from the product
    of its own z as far in the port as in the JAX package, by either route
    (within 2x); the free A z strays further."""
    r = fused_az_consistency(8)
    for mode in ("exact_Az", "free_Az"):
        assert 0.5 <= r[f"port_{mode}"] / r[f"jax_{mode}"] <= 2, r
    assert r["port_free_Az"] > r["port_exact_Az"], r


def test_fault_readings_port_runs():
    """tools/fault_readings.py on the CPU: a float32 and a float64 step under
    ``IEHDG_TENT_FUSED=2`` (every count a step, the true relative residual,
    the errors), ``--az``'s two routes (float64: both consistent) and
    ``--f32-phase``."""
    from incompressibleeulerhdg_tpu_torch.tools import fault_readings

    runs = fault_readings.main(["--nx", "2", "--degree", "2", "--runs", "cpu:float32",
                                "cpu:float64", "--env", "IEHDG_TENT_FUSED=2"])
    assert [r["run"] for r in runs] == ["cpu:float32", "cpu:float64"]
    for r in runs:
        assert r["env"] == {"IEHDG_TENT_FUSED": "2"} and r["finite"]
        assert len(r["counts"]) == 1 and min(r["counts"][0]["tentative"]) > 0
        assert 0 < r["max_relres"] < 1e-4 and 0 < r["velocity_error"] < 1e-2
    az = fault_readings.main(["--nx", "2", "--degree", "2", "--runs", "cpu:float64", "--az"])
    assert az[0]["exact_Az"] < 1e-12 and az[0]["free_Az"] < 1e-12
    ph = fault_readings.main(["--nx", "2", "--degree", "2", "--runs", "cpu:float64",
                              "--f32-phase", "none", "bdm"])
    assert [r["f32_phase"] for r in ph] == ["none", "bdm"]
    assert all(0 < r["velocity_error"] < 1e-2 for r in ph)


if __name__ == "__main__":
    # the readings behind this file's docstrings, one JSON line each:
    # JAX_PLATFORMS=cpu python tests/test_torch_f32_faults.py [nx ...]
    import sys

    import jax

    jax.config.update("jax_enable_x64", True)
    print(json.dumps(dict(nx=2, degree=8, **bdm_float32_errors(2, 8))), flush=True)
    for nx in map(int, sys.argv[1:]):
        print(json.dumps(dict(nx=nx, degree=2, **fused_az_consistency(nx))), flush=True)
