"""The other cases the JAX package runs on its GSPMD sharding, on the PyTorch
port's cell/facet partition (float64, gloo), against the port's single-rank
steps:

- the conforming RT1 x DG0 scheme, projection and monolithic, on the unit
  square (nx = 8) over 2 ranks (at nx = 4 the Schur CG exhausts its
  Krylov space of 31 pressure modes: its last step falls from 1e-5 to
  1e-13, and which of two iterations crosses 1e-12 is decided by
  rounding, on one rank as on two);
- the double shear layer on the periodic square, nx = 8 over 3 ranks (3
  does not divide nx);
- Taylor-Green at nx = 3 over 4 ranks (the slab split leaves a slab
  empty);
- the tracer under HDG implicit and under DG implicit (nx = 4, 2 ranks).

After each step the gathered state (Q, p and the tracer) agrees with the
single-rank run's to 1e-10 relative and every Krylov solve takes as many
iterations; each step makes ghost exchanges and sums and no gather.  The
structured meshes take the gather path here but keep the single rank's
right-preconditioned tentative GMRES.  The coupled FGMRES of DG and of the
conforming monolithic scheme run at a cap of four outer iterations
(partition_jobs.CAP) on both runs alike.
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks

import partition_jobs

torch.set_num_threads(1)

CASES = {  # name: ((problem, size, scheme, dt, steps, tracer), ranks)
    "conforming": (("taylorgreen", 8, "conforming", 0.05, 2, False), 2),
    "conforming_monolithic": (("taylorgreen", 8, "conforming_monolithic", 0.05, 1, False), 2),
    "shear_nx8": (("shear", 8, "imex", 0.05, 1, False), 3),
    "empty_slab_nx3": (("taylorgreen", 3, "imex", 0.1, 2, False), 4),
    "tracer_hdg_implicit": (("taylorgreen", 4, "hdg_implicit", 0.05, 2, True), 2),
    "tracer_dg_implicit": (("taylorgreen", 4, "dg_implicit", 0.01, 1, True), 2),
}
TIMEOUT = 300


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """Every case, the cases of one rank count in one launch."""
    out = {}
    for n in sorted({n for _, n in CASES.values()}):
        cases = tuple(c for c, m in CASES.values() if m == n)
        res = run_ranks(partition_jobs.job, n, args=(cases,), device="cpu", timeout=TIMEOUT,
                        rendezvous_dir=tmp_path_factory.mktemp("ranks"))
        for c in cases:
            out[c] = [r[c] for r in res]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_partitioned_steps_match_single_rank(dist, name):
    case, n = CASES[name]
    got, ref = dist[case][0], partition_jobs.run_case(case)
    assert got["counts"] == ref["counts"]
    assert min(v for c in got["counts"] for vs in c.values()
               for v in (vs if isinstance(vs, list) else [vs])) > 0
    for a, b in zip(got["states"], ref["states"]):
        assert len(a) == len(b) == (3 if case[5] else 2)
        for x, y in zip(a, b):
            close(x, y, 1e-10)
    per_rank = [r["collectives"] for r in dist[case]]
    assert len(per_rank) == n and all(c == per_rank[0] for c in per_rank)
    for c in per_rank[0]:
        assert c["gather"] == 0 and c["halo"] == 0, c
        assert c["ghosts"] > 0 and c["allreduce"] > 0, c
