"""Distributed steps of the PyTorch port on even slab splits (``--n_devices``
2 and 4 at 8^2, k=1, float64) against the port's single-rank steps and the
JAX package's single-device steps.

Every scheme whose ``--n_devices`` the JAX package runs on its slab path:
HDG IMEX SSP2(3,3,2) with projection and with the monolithic stage solve,
HDG implicit, DG implicit.  After each of two steps the gathered (Q, p)
agree with the single-rank run's to 1e-10 relative, and every Krylov solve
takes as many iterations; each step makes halo exchanges and sums and no
gather, the same on every rank.  The monolithic stage solve and DG's
coupled FGMRES run at a cap of four outer iterations (slab_jobs.CAP) on the
distributed and the single-rank run alike: at their full cap of 100 a step
makes tens of thousands of gloo round trips on the CPU.  The uncapped
projection and HDG-implicit steps are also held to the JAX package's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh
from incompressibleeulerhdg_tpu.models.problems import TaylorGreen as JTG
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)
from incompressibleeulerhdg_tpu.timesteppers.hdg_implicit import (
    IncompressibleEulerHDGImplicit as JImplicit,
)

from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks

import slab_jobs

torch.set_num_threads(1)

SCHEMES = ("imex", "monolithic", "hdg_implicit", "dg_implicit")
RUNS = tuple((s, "taylorgreen", 8) for s in SCHEMES)
TIMEOUT = 300


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module")
def single():
    return {r: slab_jobs.run_scheme(*r) for r in RUNS}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def dist(request, tmp_path_factory):
    n = request.param
    return n, run_ranks(slab_jobs.job, n, args=(RUNS,), device="cpu",
                        timeout=TIMEOUT, rendezvous_dir=tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_distributed_steps_match_single_rank(dist, single, scheme):
    n, out = dist
    run = (scheme, "taylorgreen", 8)
    got, ref = out[0][run], single[run]
    assert got["counts"] == ref["counts"]
    assert min(n for c in got["counts"] for v in c.values()
               for n in (v if isinstance(v, list) else [v])) > 0
    for a, b in zip(got["states"], ref["states"]):
        for x, y in zip(a, b):
            close(x, y, 1e-10)


def test_steps_move_only_halos_and_sums(dist):
    n, out = dist
    for run in RUNS:
        per_rank = [o[run]["collectives"] for o in out]
        assert all(c == per_rank[0] for c in per_rank), run
        for c in per_rank[0]:
            assert c["gather"] == 0 and c["halo"] > 0 and c["allreduce"] > 0, (run, c)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's single-device states and counts after two steps of
    the projection SSP2 and of HDG implicit (8^2, k=1, dt 0.1)."""
    jd = JDisc(unit_square_mesh(8), 1)
    jp = JTG(jd)
    Q0e, p0e = jp.initial_condition()
    out = {}
    js = JSSP2(jd, 0.1)
    Q = jd.interpolate_velocity(Q0e)
    p = js.shift_pressure(jd.interpolate_pressure(p0e))
    lam = js._reconstruct_trace(Q, p)
    s = js.nstages
    state = ([Q] + [jnp.zeros_like(Q)] * (s - 1), [p] + [jnp.zeros_like(p)] * (s - 1),
             [lam] + [jnp.zeros_like(lam)] * (s - 1))
    step = js._get_step(jp.f_rhs(), False)
    ops = (jd.geom, js._proj, js._cs, js._gtmg)
    steps = []
    for k in range(2):
        *state, _, counts = step(*ops, *state, jnp.asarray(k * 0.1), jnp.zeros_like(p), None)
        steps.append(((state[0][0], state[1][0]), counts))
    out["imex"] = steps
    ji = JImplicit(jd, 0.1)
    Q = jd.interpolate_velocity(Q0e)
    p = ji.shift_pressure(jd.interpolate_pressure(p0e))
    istep = jax.jit(ji._make_step())
    steps = []
    for k in range(2):
        f = jd.interpolate_velocity(jp.f_rhs()(k * 0.1))
        Q, p, it_t, it_p = istep(jd.geom, ji._proj, ji._cs, ji._gtmg, Q, p, f)
        steps.append(((Q, p), {"tentative": [int(it_t)], "pressure": [int(it_p)]}))
    out["hdg_implicit"] = steps
    return out


@pytest.mark.parametrize("scheme", ["imex", "hdg_implicit"])
def test_single_rank_steps_match_jax(single, jax_steps, scheme):
    ref = single[(scheme, "taylorgreen", 8)]
    for (state, counts), got_state, got_counts in zip(jax_steps[scheme], ref["states"],
                                                      ref["counts"]):
        for x, y in zip(got_state, state):
            close(x, y, 1e-10)
        for key, v in got_counts.items():
            assert np.ravel(v).tolist() == np.ravel(np.asarray(counts[key])).tolist(), key
