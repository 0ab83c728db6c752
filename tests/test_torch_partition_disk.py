"""Distributed steps of the PyTorch port on the cell/facet partition of the
unstructured unit disk (refinement 2, 96 cells, k = 1, float64, gloo) over 2
and 3 ranks, against the port's single-rank steps.

HDG IMEX SSP2(3,3,2) with projection and with the monolithic stage solve,
HDG implicit (projection) and DG implicit: after each step the gathered
(Q, p) agree with the single-rank run's to 1e-10 relative and every Krylov
solve takes as many iterations; each step makes ghost exchanges and sums,
the same on every rank, and no gather.  The monolithic stage solve and DG's
coupled FGMRES run at a cap of four outer iterations
(partition_jobs.CAP) on both runs alike.
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks

import partition_jobs

torch.set_num_threads(1)

CASES = {
    "imex": ("kelvinhelmholtz", 2, "imex", 0.05, 2, False),
    "monolithic": ("kelvinhelmholtz", 2, "monolithic", 0.05, 1, False),
    "hdg_implicit": ("kelvinhelmholtz", 2, "hdg_implicit", 0.05, 2, False),
    "dg_implicit": ("kelvinhelmholtz", 2, "dg_implicit", 0.01, 1, False),
}
TIMEOUT = 300


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module")
def single():
    return {c: partition_jobs.run_case(c) for c in CASES.values()}


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def dist(request, tmp_path_factory):
    n = request.param
    return n, run_ranks(partition_jobs.job, n, args=(tuple(CASES.values()),), device="cpu",
                        timeout=TIMEOUT, rendezvous_dir=tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("scheme", list(CASES))
def test_partitioned_steps_match_single_rank(dist, single, scheme):
    n, out = dist
    case = CASES[scheme]
    got, ref = out[0][case], single[case]
    assert got["counts"] == ref["counts"]
    assert min(v for c in got["counts"] for vs in c.values()
               for v in (vs if isinstance(vs, list) else [vs])) > 0
    for a, b in zip(got["states"], ref["states"]):
        for x, y in zip(a, b):
            close(x, y, 1e-10)


def test_steps_move_only_ghosts_and_sums(dist):
    n, out = dist
    for case in CASES.values():
        per_rank = [o[case]["collectives"] for o in out]
        assert all(c == per_rank[0] for c in per_rank), case
        for c in per_rank[0]:
            assert c["gather"] == 0 and c["halo"] == 0, (case, c)
            assert c["ghosts"] > 0 and c["allreduce"] > 0, (case, c)
