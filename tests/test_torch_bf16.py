"""bfloat16 patch factors (``IEHDG_PC_BF16=1``) in the PyTorch port, against
the JAX package on the CPU in float32, the only dtype the knob acts in.

Meshes: the 4^2 unit square and periodic square (k = 1, 2) and the unit
disk at refinement 2 (k = 1).

- (a) ``build_tentative_operator(pc_dtype=torch.bfloat16)`` stores
  ``Sinv`` and ``Dinv0`` in bfloat16 and every other table in float32, on
  factored and dense (``IEHDG_FACT=0``) tables and on the disk;
- (b) the JAX package's float32 factors cast to bfloat16 (through
  ``convert``) are bit for bit its bfloat16 tables; the port's own
  bfloat16 tables are within one bfloat16 ulp of the JAX package's, entry
  by entry, beyond the two packages' own float32 factors' difference
  there (at most 7.5e-6 of the largest entry; it decides one entry of the
  disk's Sinv, 1e-6 of the largest, two ulps apart);
- (c) on the JAX package's bfloat16 tables and one float32 residual, the
  colour patch solves (``patch_solve_plain`` on factored tables), the
  coloured and fused sweeps (both ``A z``) and the additive
  ``_patch_apply_bl`` match the JAX functions within 5e-5 of the
  reference's largest entry (readings 4e-9 .. 1.8e-5; the largest, the
  symmetric sweep of the dense 4^2, k = 2 tables, reads 7.5e-6 on the
  float32 factors too: each package's float32 rounding, amplified by the
  matvecs between colours, 5.0e-6 (port) and 1.3e-5 (JAX) from a float64
  evaluation of the same tables);
- (d) one float32 step with ``IEHDG_PC_BF16=1`` against the JAX stepper:
  SSP2(3,3,2) on factored and on dense tables, and ARS2(2,3,2) with
  ``IEHDG_LAG_PC=1`` against the JAX composite step: equal Krylov counts
  and the velocity within 1e-5 of its largest entry (readings 8e-7 and
  below);
- (e) in float64 the knob changes nothing, in either package.

The wrappers' refusal of other dtype mixes is checked without a card: a
CPU tensor takes the plain version, so the check runs on ``check_cuda``
and ``dtype_code`` themselves.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.linalg import preconditioners as JP
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.ops.forms import star_fields as j_star_fields
from incompressibleeulerhdg_tpu.timesteppers import hdg_imex as JH

from incompressibleeulerhdg_tpu_torch import convert, kernels
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as TP
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen as TTG
from incompressibleeulerhdg_tpu_torch.ops.forms import star_fields as t_star_fields
from incompressibleeulerhdg_tpu_torch.timesteppers import hdg_imex as TH

torch.set_num_threads(1)

C_STAGE = 0.025
APPLY_TOL = 5e-5  # f32 applies on the same bf16 tables (readings to 1.8e-5)
STEP_TOL = 1e-5  # f32 steps (readings to 8e-7)
FACTORS = ("Sinv", "Dinv0")
OTHERS = ("Dinv", "Sown", "Pcell", "Ks01", "Ks10", "Bp", "Cp", "D", "Bx", "Cx")
# (generator, size, degree, IEHDG_FACT)
CASES = {
    "square_k1": ("unit_square_mesh", 4, 1, "1"),
    "periodic_k2": ("periodic_square_mesh", 4, 2, "1"),
    "square_k2_dense": ("unit_square_mesh", 4, 2, "0"),
    "disk_k1": ("unit_disk_mesh", 2, 1, "1"),
}


def f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def close(got, ref, rtol):
    got, ref = f64(got), f64(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


def bf16_ulp(a):
    """One bfloat16 ulp at each entry of ``a`` (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(a))[1] - 8)


class Case:
    """One mesh built by both packages in float32, a seeded star and
    residual, and the operators of both packages with and without the
    bfloat16 factors."""

    def __init__(self, name):
        gen, size, k, fact = CASES[name]
        self.jd = JDisc(getattr(JM, gen)(size), k, dtype=jnp.float32)
        self.td = TDisc(getattr(TM, gen)(size), k, dtype=torch.float32, device="cpu")
        self.jg, self.tg = self.jd.geom, self.td.geom
        rng = np.random.default_rng(size + 10 * k)
        shape = (2, self.jg.d1, self.jg.n_cells)
        Q, self.r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jstar = j_star_fields(self.jg, jnp.asarray(Q))
        tstar = t_star_fields(self.tg, torch.as_tensor(Q))
        with pytest.MonkeyPatch.context() as mp:  # the builds read IEHDG_FACT
            mp.setenv("IEHDG_FACT", fact)
            self.jop32 = JP.build_tentative_operator(self.jg, jstar, C_STAGE)
            self.jop = JP.build_tentative_operator(self.jg, jstar, C_STAGE,
                                                   pc_dtype=jnp.bfloat16)
            self.top = TP.build_tentative_operator(self.tg, tstar, C_STAGE,
                                                   pc_dtype=torch.bfloat16)
            self.top32 = TP.build_tentative_operator(self.tg, tstar, C_STAGE)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return Case(request.param)


def test_factors_stored_in_bf16(case):
    """(a) Sinv and Dinv0 in bfloat16, every other table float32, and the
    float32 build's other tables unchanged."""
    for name in FACTORS:
        assert getattr(case.top, name).dtype == torch.bfloat16, name
        assert getattr(case.top32, name).dtype == torch.float32, name
    held = [n for n in OTHERS if getattr(case.top, n) is not None]
    assert "Dinv" in held and len(held) in (4, 7)
    for name in held:
        assert getattr(case.top, name).dtype == torch.float32, name
        assert torch.equal(getattr(case.top, name), getattr(case.top32, name)), name


def test_bf16_tables_match_jax(case):
    """(b) The JAX package's float32 factors cast here are its bfloat16
    tables bit for bit; the port's own are within one bfloat16 ulp beyond
    the float32 factors' difference."""
    j32 = convert.tentative_operator_from_jax(case.jop32, torch.float32)
    j16 = convert.tentative_operator_from_jax(case.jop, torch.float32)
    for name in FACTORS:
        got = getattr(j32, name).to(torch.bfloat16)
        ref = getattr(j16, name)
        assert ref.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16)), name
        own, jax16 = f64(getattr(case.top, name)), f64(ref)
        d32 = np.abs(f64(getattr(case.top32, name)) - f64(getattr(j32, name)))
        ulp = np.maximum(bf16_ulp(own), bf16_ulp(jax16))
        assert np.all(np.abs(own - jax16) <= ulp + d32), name


def test_applies_on_bf16_tables(case):
    """(c) The plain applies on the JAX package's bfloat16 tables against
    the JAX functions, float32."""
    jg, tg, jop = case.jg, case.tg, case.jop
    top = convert.tentative_operator_from_jax(jop, torch.float32)
    r, tr = jnp.asarray(case.r), torch.as_tensor(case.r)
    close(TP.tentative_patch_apply(tg, top, tr), JP.tentative_patch_apply(jg, jop, r), APPLY_TOL)
    for sym in (False, True):
        close(TP.tentative_colored_apply(tg, top, tr, symmetric=sym),
              JP.tentative_colored_apply(jg, jop, r, symmetric=sym), APPLY_TOL)
    if tg.shift is None:  # the disk: no rectangle layout, no fused sweep
        return
    rb = case.r.reshape(2 * jg.d1, -1)
    for k in range(len(tg.fcol_bounds) - 1):
        close(TP._patch_color_structured(tg, top, k, torch.as_tensor(rb)),
              JP._patch_color_structured(jg, jop, k, jnp.asarray(rb)), APPLY_TOL)
    for exact in (True, False):
        tz, tAz = TP._colored_apply_fused_bl(tg, top, torch.as_tensor(rb), symmetric=True,
                                             exact_Az=exact)
        jz, jAz = JP._colored_apply_fused_bl(jg, jop, jnp.asarray(rb), symmetric=True,
                                             exact_Az=exact)
        close(tz, jz, APPLY_TOL)
        close(tAz, jAz, APPLY_TOL)


def _jax_steps(cls_name, dtype, n, composite=False):
    """The JAX package's ``n`` steps of the Taylor-Green vortex on the 4^2
    square, k = 1, dt = 0.1: [(velocity, counts)] a step."""
    jd = JDisc(JM.unit_square_mesh(4), 1, dtype=dtype)
    js = getattr(JH, cls_name)(jd, 0.1)
    if composite:
        js.composite_step_cells = 1
    jp = JTG(jd)
    Q0, p0 = jp.initial_condition()
    Q = jd.interpolate_velocity(Q0)
    p = js.shift_pressure(jd.interpolate_pressure(p0))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    z = lambda a: [a] + [jnp.zeros_like(a)] * (s - 1)
    state = (z(Q), z(p), z(lam))
    step = js._get_step(jp.f_rhs(), False)
    out = []
    for k in range(n):
        sQ, sp, sl, _, counts = step(jd.geom, js._proj, js._cs, js._gtmg, *state,
                                     jnp.asarray(k * 0.1, dtype), jnp.zeros_like(p), None)
        state = (sQ, sp, sl)
        out.append((sQ[0], {key: [int(v) for v in np.ravel(np.asarray(counts[key]))]
                            for key in ("tentative", "pressure", "final_pressure",
                                        "reconstruction")}))
    return out


def _port_steps(cls_name, dtype, n):
    td = TDisc(TM.unit_square_mesh(4), 1, dtype=dtype, device="cpu")
    ts = getattr(TH, cls_name)(td, 0.1)
    tp = TTG(td)
    state = ts.initial_state(*tp.initial_condition())
    out = []
    for k in range(n):
        *state, counts = ts.step(*state, k * 0.1, tp.f_rhs())
        out.append((state[0][0], {key: [int(v) for v in np.ravel(counts[key])]
                                  for key in ("tentative", "pressure", "final_pressure",
                                              "reconstruction")}))
    return out


STEPS = {  # name: (stepper, steps, knobs, JAX composite step)
    "ssp2": ("IncompressibleEulerHDGIMEXSSP2_332", 1, {}, False),
    "ssp2_dense": ("IncompressibleEulerHDGIMEXSSP2_332", 1, {"IEHDG_FACT": "0"}, False),
    "ars2_lag": ("IncompressibleEulerHDGIMEXARS2_232", 2, {"IEHDG_LAG_PC": "1"}, True),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_bf16_step_matches_jax(monkeypatch, name):
    """(d) float32 steps with IEHDG_PC_BF16=1: the JAX stepper's counts,
    its velocity within STEP_TOL; the operators of the step hold bfloat16
    factors."""
    cls_name, n, env, composite = STEPS[name]
    monkeypatch.setenv("IEHDG_PC_BF16", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    built = []
    real = TH.build_tentative_operator

    def spy(*a, **kw):
        op = real(*a, **kw)
        built.append((op.Sinv.dtype, op.Dinv0.dtype, op.Dinv.dtype))
        return op

    monkeypatch.setattr(TH, "build_tentative_operator", spy)
    ref = _jax_steps(cls_name, jnp.float32, n, composite)
    got = _port_steps(cls_name, torch.float32, n)
    for (tQ, tc), (jQ, jc) in zip(got, ref):
        assert tc == jc
        assert min(tc["tentative"]) > 0
        close(tQ, jQ, STEP_TOL)
    assert built and set(built) == {(torch.bfloat16, torch.bfloat16, torch.float32)}


def test_knob_ignored_in_float64(monkeypatch):
    """(e) In float64 both packages step the same with and without
    IEHDG_PC_BF16=1, and the port's operators keep float64 factors."""
    out = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("IEHDG_PC_BF16", knob)
        out[knob] = (_jax_steps("IncompressibleEulerHDGIMEXSSP2_332", jnp.float64, 1),
                     _port_steps("IncompressibleEulerHDGIMEXSSP2_332", torch.float64, 1))
    (j0, t0), (j1, t1) = out["0"], out["1"]
    assert np.array_equal(np.asarray(j0[0][0]), np.asarray(j1[0][0])) and j0[0][1] == j1[0][1]
    assert torch.equal(t0[0][0], t1[0][0]) and t0[0][1] == t1[0][1] == j0[0][1]


def test_only_bf16_factors_with_float32_pass():
    """The dtype codes of the C interface: 2 for float32 vectors with
    bfloat16 factors, and a TypeError for every other mix."""
    f32, f64_, bf16, f16 = torch.float32, torch.float64, torch.bfloat16, torch.float16
    assert kernels.dtype_code(f32) == 0 and kernels.dtype_code(f64_) == 1
    assert kernels.dtype_code(f32, f32) == 0 and kernels.dtype_code(f32, bf16) == 2
    for vec, fac in ((f64_, bf16), (f32, f16), (f32, f64_), (f64_, f32), (bf16, bf16)):
        with pytest.raises(TypeError):
            kernels.dtype_code(vec, fac)
    assert TP.width_kernels(10, f32, bf16)[2] == "patch_solve_bf16"
    assert TP.width_kernels(45, f32, bf16)[2] == "patch_solve_wide_bf16"
    assert TP.width_kernels(45, f32, f32)[2] == "patch_solve_wide"
    for name in ("patch_solve_bf16", "patch_solve_wide_bf16"):
        assert kernels.source_of(name) == name[:-5]
